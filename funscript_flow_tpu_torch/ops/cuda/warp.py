"""Wrappers of the bilinear-sampling CUDA kernels (``csrc/warp.cu``).

Three entry points, each with its own launch count, replacing the three
entry points of ``funscript_flow_tpu/ops/pallas/warp.py``:

* ``warp_bilinear`` (K2, ``warp_bilinear_pallas``, Farnebäck): relative
  warp of the 5 R1 planes. Plain twin: ``ops.farneback.warp_bilinear``.
* ``warp_planes`` (K5, ``warp_planes_padded``, DIS variational
  refinement): relative warp of 3 planes through the same kernel. Plain
  twin: ``ops.farneback.warp_bilinear`` on the stacked planes.
* ``sample_abs`` (K4, ``sample_abs_pallas``, DIS dense patch sampler):
  absolute-coordinate sampling of one plane. Plain twin:
  ``models.dis.bilinear_abs``.
"""

from __future__ import annotations

import torch

from .. import farneback
from ...models import dis
from ._build import check_tensor, launch

__all__ = ["warp_bilinear", "warp_planes", "sample_abs"]


def _same_device(*ts) -> None:
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("all tensors must be on one device")


def _warp(kernel: str, R: torch.Tensor, u: torch.Tensor,
          v: torch.Tensor) -> torch.Tensor:
    check_tensor(R, "R")
    if R.dim() != 4:
        raise ValueError(f"R: expected [B, P, H, W], got {tuple(R.shape)}")
    B, P, H, W = R.shape
    check_tensor(u, "u", (B, H, W))
    check_tensor(v, "v", (B, H, W))
    _same_device(R, u, v)
    if R.device.type == "cpu":
        return farneback.warp_bilinear(R, u, v)
    out = torch.empty_like(R)
    launch(kernel, "ff_warp_bilinear", R.device, R.data_ptr(), u.data_ptr(),
           v.data_ptr(), out.data_ptr(), B, P, H, W)
    return out


def warp_bilinear(R: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the P planes of R [B, P, H, W] at (x + u, y + v)
    with per-corner clamping -> [B, P, H, W]. The caller masks
    out-of-bounds pixels (``farneback.warp_inbounds``).

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    return _warp("warp_bilinear", R, u, v)


def warp_planes(planes, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Relative bilinear warp of a sequence of [B, H, W] planes by (u, v)
    -> [B, P, H, W], corners clamped one by one. The DIS refinement passes
    (I1, I1x, I1y) with (u, v) pre-clamped so every sample is in bounds.

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    return _warp("warp_planes", torch.stack(tuple(planes), dim=1), u, v)


def sample_abs(img: torch.Tensor, fy: torch.Tensor,
               fx: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of img [B, h, w] at absolute coordinates (fy, fx)
    [B, Ho, Wo] -> [B, Ho, Wo]. The caller pre-clamps the coordinates to
    [0, h-1] x [0, w-1].

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    check_tensor(img, "img")
    check_tensor(fy, "fy")
    if img.dim() != 3 or fy.dim() != 3 or fy.shape[0] != img.shape[0]:
        raise ValueError(f"expected img [B, h, w] and fy [B, Ho, Wo], got "
                         f"{tuple(img.shape)} and {tuple(fy.shape)}")
    check_tensor(fx, "fx", fy.shape)
    _same_device(img, fy, fx)
    if img.device.type == "cpu":
        return dis.bilinear_abs(img, fy, fx)
    B, h, w = img.shape
    Ho, Wo = fy.shape[1], fy.shape[2]
    out = torch.empty_like(fy)
    launch("sample_abs", "ff_sample_abs", img.device, img.data_ptr(),
           fy.data_ptr(), fx.data_ptr(), out.data_ptr(), B, h, w, Ho, Wo)
    return out
