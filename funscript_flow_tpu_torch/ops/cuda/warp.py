"""Wrapper of the ``warp_bilinear`` CUDA kernel (``csrc/warp.cu``).

Replaces the Pallas kernel ``funscript_flow_tpu/ops/pallas/warp.py``
``warp_bilinear_pallas`` on the Farnebäck path. Plain twin:
``ops.farneback.warp_bilinear``.
"""

from __future__ import annotations

import torch

from .. import farneback
from ._build import check_tensor, launch

__all__ = ["warp_bilinear"]

launches = 0  # kernel launches since the last reset (ops.cuda.reset_launches)


def warp_bilinear(R: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the P planes of R [B, P, H, W] at (x + u, y + v)
    with per-corner clamping -> [B, P, H, W]. The caller masks
    out-of-bounds pixels (``farneback.warp_inbounds``).

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    global launches
    check_tensor(R, "R")
    if R.dim() != 4:
        raise ValueError(f"R: expected [B, P, H, W], got {tuple(R.shape)}")
    B, P, H, W = R.shape
    check_tensor(u, "u", (B, H, W))
    check_tensor(v, "v", (B, H, W))
    if not (R.device == u.device == v.device):
        raise ValueError("R, u and v must be on one device")
    if R.device.type == "cpu":
        return farneback.warp_bilinear(R, u, v)
    out = torch.empty_like(R)
    launch("ff_warp_bilinear", R.device, R.data_ptr(), u.data_ptr(),
           v.data_ptr(), out.data_ptr(), B, P, H, W)
    launches += 1
    return out
