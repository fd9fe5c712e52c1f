"""Wrappers of the port's hand-written CUDA kernels (the counterpart of the
JAX package's ``ops/pallas``).

Each wrapper launches its kernel on a CUDA tensor (or raises) and computes
its plain twin on a CPU tensor; there is no fallback from the one to the
other. Each entry point has its own launch count (``_build.launches``),
incremented only where its kernel is launched.
"""

from __future__ import annotations

from . import _build

__all__ = ["KERNELS", "launch_counts", "reset_launches"]

# the wrapper entry points: K1 polyexp.poly_exp, K2 warp.warp_bilinear,
# K3 flow_step.box_blur_solve, K4 in two forms (warp.sample_abs, dense;
# warp.sample_patches, the DIS patch sampler), K5 warp.warp_planes, K6
# pyramid.pyramid_level
KERNELS = ("poly_exp", "warp_bilinear", "box_blur_solve", "sample_abs",
           "sample_patches", "warp_planes", "pyramid_level")


def launch_counts() -> dict:
    with _build._count_lock:
        return {name: _build.launches.get(name, 0) for name in KERNELS}


def reset_launches() -> None:
    with _build._count_lock:
        _build.launches.clear()
