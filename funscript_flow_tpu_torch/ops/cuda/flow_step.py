"""Wrapper of the ``box_blur_solve`` CUDA kernel (``csrc/flow_step.cu``).

Replaces the Pallas kernel ``funscript_flow_tpu/ops/pallas/flow_step.py``
``box_blur_solve_pallas``. Plain twin: ``ops.farneback.solve_flow``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import farneback
from ._build import check_planes, launch

__all__ = ["box_blur_solve", "MAX_WINSIZE"]

MAX_WINSIZE = 31  # csrc/flow_step.cu MAX_R = 15
_NAMES = tuple(f"M[{k}]" for k in range(5))


def box_blur_solve(M, winsize: int = 15):
    """M: 5 constraint planes (G11, G12, G22, h1, h2), each [B, H, W]
    float32 -> (u, v): the winsize x winsize replicate-border mean of each
    plane, then the regularized 2x2 solve.

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    if len(M) != 5:
        raise ValueError(f"M: expected 5 planes, got {len(M)}")
    m0 = M[0]
    if m0.dim() != 3:
        raise ValueError(f"M: expected [B, H, W] planes, got {tuple(m0.shape)}")
    shape = m0.shape
    check_planes(M, _NAMES, shape)
    if winsize % 2 != 1 or not 1 <= winsize <= MAX_WINSIZE:
        raise ValueError(f"winsize must be odd and <= {MAX_WINSIZE}, "
                         f"got {winsize}")
    if m0.is_cpu:
        return farneback.solve_flow(M, winsize)
    B, H, W = shape
    # two allocations cost the host less than one split by unbind
    u = torch.empty_like(m0)
    v = torch.empty_like(m0)
    launch("box_blur_solve", "ff_box_blur_solve", m0, m0.data_ptr(),
           M[1].data_ptr(), M[2].data_ptr(), M[3].data_ptr(), M[4].data_ptr(),
           u.data_ptr(), v.data_ptr(), B, H, W, winsize, _inv_area(winsize))
    return u, v


@functools.lru_cache(maxsize=None)
def _inv_area(winsize: int) -> float:
    """The float32 rounding of 1/(win*win), by which the plain twin
    multiplies."""
    return float(np.float32(1.0 / (winsize * winsize)))
