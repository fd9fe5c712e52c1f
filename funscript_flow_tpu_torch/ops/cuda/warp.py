"""Wrappers of the bilinear-sampling CUDA kernels (``csrc/warp.cu``).

Four entry points, each with its own launch count, replacing the three
entry points of ``funscript_flow_tpu/ops/pallas/warp.py``:

* ``warp_bilinear`` (K2, ``warp_bilinear_pallas``, Farnebäck): relative
  warp of the 5 R1 planes. Plain twin: ``ops.farneback.warp_bilinear``.
* ``warp_planes`` (K5, ``warp_planes_padded``, DIS variational
  refinement): relative warp of 3 planes through the same kernel. Plain
  twin: ``ops.farneback.warp_bilinear`` on the stacked planes.
* ``sample_patches`` (K4, ``sample_abs_pallas`` as the DIS patch sampler
  uses it): the ps x ps patches of one plane at offset patch corners,
  written in the patch layout. Plain twin: ``models.dis.
  _sample_patches_plain`` (``_sample_patches_dense`` with
  ``bilinear_abs``).
* ``sample_abs`` (K4, ``sample_abs_pallas``): absolute-coordinate sampling
  of one plane, the same kernel body with the coordinates read instead of
  formed. Plain twin: ``models.dis.bilinear_abs``.
"""

from __future__ import annotations

import torch

from .. import farneback
from ...models import dis
from ._build import check_tensor, launch, same_device

__all__ = ["warp_bilinear", "warp_planes", "sample_patches", "sample_abs"]


def _warp(kernel: str, R: torch.Tensor, u: torch.Tensor,
          v: torch.Tensor) -> torch.Tensor:
    check_tensor(R, "R")
    if R.dim() != 4:
        raise ValueError(f"R: expected [B, P, H, W], got {tuple(R.shape)}")
    B, P, H, W = R.shape
    shape = (B, H, W)
    check_tensor(u, "u", shape)
    check_tensor(v, "v", shape)
    same_device(R, u, v)
    if R.is_cpu:
        return farneback.warp_bilinear(R, u, v)
    out = torch.empty_like(R)
    launch(kernel, "ff_warp_bilinear", R, R.data_ptr(), u.data_ptr(),
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


def sample_patches(img: torch.Tensor, pu: torch.Tensor, pv: torch.Tensor,
                   ps: int, stride: int) -> torch.Tensor:
    """The ps x ps patches of img [B, h, w] on the patch grid of ``stride``,
    each moved by its offset (pu, pv) [B, ny, nx] (x, y), bilinearly
    sampled -> [B, ny, nx, ps*ps], patch pixels ordered dy*ps + dx.

    Patch (i, j)'s corner is clamp(i*stride + pv, 0, h-ps) (likewise in x
    with j and pu); its pixel (dy, dx) is sampled at (corner + dy,
    corner + dx) as :func:`sample_abs` does.

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    check_tensor(img, "img")
    check_tensor(pu, "pu")
    if img.dim() != 3 or pu.dim() != 3 or pu.shape[0] != img.shape[0]:
        raise ValueError(f"expected img [B, h, w] and pu [B, ny, nx], got "
                         f"{tuple(img.shape)} and {tuple(pu.shape)}")
    check_tensor(pv, "pv", pu.shape)
    same_device(img, pu, pv)
    B, h, w = img.shape
    _, ny, nx = pu.shape
    if not (1 <= ps <= min(h, w) and stride >= 1):
        raise ValueError(f"patch size {ps} and stride {stride} do not fit "
                         f"a {h}x{w} source")
    if img.is_cpu:
        return dis._sample_patches_plain(img, pu, pv, ps, stride)
    out = img.new_empty((B, ny, nx, ps * ps))
    launch("sample_patches", "ff_sample_patches", img, img.data_ptr(),
           pu.data_ptr(), pv.data_ptr(), out.data_ptr(), B, h, w, ny, nx, ps,
           stride)
    return out


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
    same_device(img, fy, fx)
    if img.is_cpu:
        return dis.bilinear_abs(img, fy, fx)
    B, h, w = img.shape
    _, Ho, Wo = fy.shape
    out = torch.empty_like(fy)
    launch("sample_abs", "ff_sample_abs", img, img.data_ptr(),
           fy.data_ptr(), fx.data_ptr(), out.data_ptr(), B, h, w, Ho, Wo)
    return out
