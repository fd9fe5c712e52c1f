"""Wrappers of the port's hand-written CUDA kernels (the counterpart of the
JAX package's ``ops/pallas``).

Each wrapper launches its kernel on a CUDA tensor (or raises) and computes
its plain twin from ``ops.farneback`` on a CPU tensor; there is no fallback
from the one to the other. Each keeps a plain integer ``launches`` count,
incremented only where the kernel is launched.
"""

from __future__ import annotations

from . import flow_step, polyexp, warp

__all__ = ["KERNELS", "launch_counts", "reset_launches"]

# kernel name -> wrapper module
KERNELS = {
    "poly_exp": polyexp,
    "warp_bilinear": warp,
    "box_blur_solve": flow_step,
}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
