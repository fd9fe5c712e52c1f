"""Wrapper of the ``poly_exp`` CUDA kernel (``csrc/polyexp.cu``).

Replaces the Pallas kernel ``funscript_flow_tpu/ops/pallas/polyexp.py``
``poly_exp_pallas``. Plain twin: ``ops.farneback.poly_exp``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import farneback
from ._build import check_tensor, launch

__all__ = ["poly_exp", "MAX_POLY_N"]

MAX_POLY_N = 8  # csrc/polyexp.cu MAX_N


@functools.lru_cache(maxsize=None)
def _tables(poly_n: int, poly_sigma: float):
    """The kernel's host arguments: the taps (g, xg, xxg) and the four
    inverse-Gramian entries as float32 arrays, with their addresses (the
    arrays stay referenced by the cache while the addresses are used)."""
    g, xg, xxg, ig = farneback._poly_exp_tables(poly_n, poly_sigma)
    taps = np.ascontiguousarray(np.concatenate([g, xg, xxg]), np.float32)
    igs = np.asarray(ig, np.float32)
    return (taps, igs, taps.ctypes.data_as(ctypes.c_void_p),
            igs.ctypes.data_as(ctypes.c_void_p))


def poly_exp(img: torch.Tensor, poly_n: int = 5,
             poly_sigma: float = 1.2) -> torch.Tensor:
    """img [B, H, W] float32 -> the 5 expansion planes stacked
    [B, 5, H, W] (bx·ig11, by·ig11, bc·ig03+bxx·ig33, bc·ig03+byy·ig33,
    bxy·ig55).

    A CUDA tensor launches the kernel; a CPU tensor computes the plain twin.
    """
    check_tensor(img, "img")
    if img.dim() != 3:
        raise ValueError(f"img: expected [B, H, W], got {tuple(img.shape)}")
    if not 1 <= poly_n <= MAX_POLY_N:
        raise ValueError(f"poly_n must be in [1, {MAX_POLY_N}], got {poly_n}")
    if img.is_cpu:
        return torch.stack(farneback.poly_exp(img, poly_n, poly_sigma), dim=1)
    B, H, W = img.shape
    out = img.new_empty((B, 5, H, W))
    _, _, taps, igs = _tables(poly_n, poly_sigma)
    launch("poly_exp", "ff_poly_exp", img, img.data_ptr(), out.data_ptr(),
           B, H, W, poly_n, taps, igs)
    return out
