"""Wrapper of the ``pyramid_level`` CUDA kernel (``csrc/pyramid.cu``).

Replaces no Pallas kernel: the JAX package leaves the Farnebäck pyramid to
XLA. The kernel fuses one level's Gaussian blur and bilinear resize, which
the port otherwise runs as about 46 PyTorch launches an image. Plain twin:
``ops.image.resize_bilinear(ops.image.gaussian_blur(x, ksize, sigma),
out_h, out_w)``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import image
from ._build import check_tensor, launch

__all__ = ["pyramid_level", "MAX_KSIZE"]

MAX_KSIZE = 79  # csrc/pyramid.cu MAX_K: 5 levels at pyr_scale 0.5
_ROWS = 8              # csrc/pyramid.cu TY: a tile's output rows
_TILE_SPAN = 256       # source columns a tile aims at
_SMEM_MAX = 48 * 1024  # csrc/pyramid.cu MAX_SMEM: a block's vertical sums


@functools.lru_cache(maxsize=None)
def _taps(ksize: int, sigma: float):
    """The Gaussian taps as float32 (the twin's), with their address (the
    array stays referenced by the cache while the address is used)."""
    taps = np.ascontiguousarray(image.gaussian_kernel_cv(ksize, sigma),
                                np.float32)
    return taps, taps.ctypes.data_as(ctypes.c_void_p)


@functools.lru_cache(maxsize=None)
def _tables_on(H: int, W: int, out_h: int, out_w: int,
               device: torch.device):
    """The twin's resize tables on ``device``: int32 ry0, ry1, cx0, cx1 in
    one tensor and float32 wy, wx in another."""
    ry0, ry1, wy = image._resize_tables(H, out_h)
    cx0, cx1, wx = image._resize_tables(W, out_w)
    idx = torch.cat([ry0, ry1, cx0, cx1]).to(torch.int32)
    return idx.to(device), torch.cat([wy, wx]).to(device)


@functools.lru_cache(maxsize=None)
def tiles(H: int, W: int, out_h: int, out_w: int, ksize: int):
    """(th, tw, sw): a block's output tile, ``th`` rows by ``tw`` columns
    (about 256 source columns), and the row stride of its vertical sums,
    the widest column span of any tile (from its first column floored to a
    multiple of 32, as the kernel floors it, to the last column its taps
    read)."""
    r = ksize // 2
    cx0, cx1, _ = (t.numpy() for t in image._resize_tables(W, out_w))
    tw = max(1, min(out_w, _TILE_SPAN * out_w // W))
    first = np.arange(0, out_w, tw)
    last = np.minimum(first + tw, out_w) - 1
    sw = int((cx1[last] + r - (cx0[first] - r) // 32 * 32 + 1).max())
    th = min(_ROWS, out_h, _SMEM_MAX // (8 * sw))
    if th < 1:
        raise ValueError(f"pyramid_level: a {W}-column frame at level width "
                         f"{out_w} spans more columns than a tile holds")
    return th, tw, sw


def pyramid_level(x: torch.Tensor, ksize: int, sigma: float, out_h: int,
                  out_w: int) -> torch.Tensor:
    """x [N, H, W] float32 -> one pyramid level [N, out_h, out_w]: the
    Gaussian blur (``ksize`` odd taps, ``sigma``, reflect-101 border), then
    the cv2.INTER_LINEAR resize.

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    check_tensor(x, "x")
    if x.dim() != 3:
        raise ValueError(f"x: expected [N, H, W], got {tuple(x.shape)}")
    if ksize % 2 != 1 or not 1 <= ksize <= MAX_KSIZE:
        raise ValueError(f"ksize must be odd and <= {MAX_KSIZE}, got {ksize}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"level size must be positive, got {out_h}x{out_w}")
    if x.is_cpu:
        return image.resize_bilinear(image.gaussian_blur(x, ksize, sigma),
                                     out_h, out_w)
    N, H, W = x.shape
    th, tw, sw = tiles(H, W, out_h, out_w, ksize)
    idx, wts = _tables_on(H, W, out_h, out_w, x.device)
    out = x.new_empty((N, out_h, out_w))
    launch("pyramid_level", "ff_pyramid_level", x, x.data_ptr(),
           out.data_ptr(), idx.data_ptr(), wts.data_ptr(), N, H, W, out_h,
           out_w, ksize, _taps(ksize, sigma)[1], th, tw, sw)
    return out
