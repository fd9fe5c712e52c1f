"""Wrapper of the ``box_blur_solve`` CUDA kernel (``csrc/flow_step.cu``).

Replaces the Pallas kernel ``funscript_flow_tpu/ops/pallas/flow_step.py``
``box_blur_solve_pallas``. Plain twin: ``ops.farneback.solve_flow``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import farneback
from ._build import check_tensor, launch

__all__ = ["box_blur_solve", "MAX_WINSIZE"]

MAX_WINSIZE = 31  # csrc/flow_step.cu MAX_R = 15


def box_blur_solve(M, winsize: int = 15):
    """M: 5 constraint planes (G11, G12, G22, h1, h2), each [B, H, W]
    float32 -> (u, v): the winsize x winsize replicate-border mean of each
    plane, then the regularized 2x2 solve.

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    if len(M) != 5:
        raise ValueError(f"M: expected 5 planes, got {len(M)}")
    shape = tuple(M[0].shape)
    if len(shape) != 3:
        raise ValueError(f"M: expected [B, H, W] planes, got {shape}")
    for k, m in enumerate(M):
        check_tensor(m, f"M[{k}]", shape)
        if m.device != M[0].device:
            raise ValueError("M planes must be on one device")
    if winsize % 2 != 1 or not 1 <= winsize <= MAX_WINSIZE:
        raise ValueError(f"winsize must be odd and <= {MAX_WINSIZE}, "
                         f"got {winsize}")
    if M[0].device.type == "cpu":
        return farneback.solve_flow(M, winsize)
    B, H, W = shape
    u = torch.empty(shape, dtype=torch.float32, device=M[0].device)
    v = torch.empty_like(u)
    # the plain twin multiplies by the float32 rounding of 1/(win*win)
    inv_area = float(np.float32(1.0 / (winsize * winsize)))
    launch("box_blur_solve", "ff_box_blur_solve", M[0].device,
           *(m.data_ptr() for m in M), u.data_ptr(), v.data_ptr(),
           B, H, W, winsize, inv_area)
    return u, v
