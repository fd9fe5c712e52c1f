"""Batched image primitives (PyTorch) used by the optical-flow pipeline.

All functions take ``[B, H, W]`` float32 tensors (a batch of grayscale
frames) on any device and repeat the JAX package's arithmetic step for step
(same taps, same summation order, same float64-built tables), so the two
agree to float32 rounding. Border semantics follow the OpenCV functions they
stand in for (reference cv2.GaussianBlur / cv2.resize / the box blur inside
calcOpticalFlowFarneback, FunscriptFlow.pyw:878-879):

* Gaussian blur: BORDER_REFLECT_101 (cv2 default) = torch's ``reflect``
* polynomial-expansion separable correlation: replicate
* box blur: replicate
* resize: bilinear with half-pixel centers (cv2 INTER_LINEAR convention)
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "gaussian_kernel_cv",
    "gaussian_blur",
    "box_blur",
    "resize_bilinear",
    "sepconv",
    "cv_round",
]

_TORCH_PAD = {"reflect101": "reflect", "replicate": "replicate"}


def cv_round(x: float) -> int:
    """cvRound: round half to even (banker's rounding), like rint."""
    return int(np.rint(x))


def gaussian_kernel_cv(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel: if sigma <= 0, sigma = 0.3*((ksize-1)*0.5 - 1) + 0.8.

    For ksize <= 7 and sigma <= 0 OpenCV substitutes fixed binomial kernels
    (getGaussianKernel's small_gaussian_tab) — reproduced here verbatim since
    the formula-derived kernels differ in the 2nd decimal.
    """
    if sigma <= 0 and ksize <= 7:
        tab = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        }
        if ksize in tab:
            return np.asarray(tab[ksize], dtype=np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad_hw(x: torch.Tensor, top: int, left: int, mode: str) -> torch.Tensor:
    """Pad the trailing two axes symmetrically (``top`` rows and ``left``
    columns on each side); F.pad's reflect/replicate modes want a 4-D view."""
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    y = F.pad(x.reshape(-1, 1, h, w), (left, left, top, top),
              mode=_TORCH_PAD[mode])
    return y.reshape(*lead, h + 2 * top, w + 2 * left)


def sepconv(x: torch.Tensor, taps_y, taps_x, border: str = "replicate") -> torch.Tensor:
    """Separable 2-D correlation over the trailing two axes.

    ``taps_y``/``taps_x`` are 1-D kernels (numpy or tuple). Shifted-slice
    sums over a padded tensor, taps in order, vertical pass first — the
    JAX package's order, so rounding matches.
    """
    taps_y = np.asarray(taps_y, dtype=np.float32)
    taps_x = np.asarray(taps_x, dtype=np.float32)
    ry, rx = len(taps_y) // 2, len(taps_x) // 2
    H, W = x.shape[-2], x.shape[-1]

    if len(taps_y) > 1:
        xp = _pad_hw(x, ry, 0, border)
        acc = None
        for i, t in enumerate(taps_y):
            sl = xp[..., i : i + H, :]
            acc = sl * float(t) if acc is None else acc + sl * float(t)
        x = acc
    else:
        x = x * float(taps_y[0])

    if len(taps_x) > 1:
        xp = _pad_hw(x, 0, rx, border)
        acc = None
        for i, t in enumerate(taps_x):
            sl = xp[..., :, i : i + W]
            acc = sl * float(t) if acc is None else acc + sl * float(t)
        x = acc
    else:
        x = x * float(taps_x[0])
    return x


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(ksize, sigma) with BORDER_REFLECT_101 semantics."""
    k = gaussian_kernel_cv(ksize, sigma)
    return sepconv(x, k, k, border="reflect101")


def box_blur(x: torch.Tensor, win: int) -> torch.Tensor:
    """Replicate-border mean filter of odd width ``win`` (the running-sum
    blur inside OpenCV's Farneback flow update, flags=0 path): every output
    is the mean of a full win x win replicated window."""
    ones = np.ones(win, dtype=np.float32)
    return sepconv(x, ones, ones, border="replicate") * (1.0 / (win * win))


@functools.lru_cache(maxsize=None)
def _resize_tables(n_in: int, n_out: int):
    """Index/weight tables of one resize axis, built in float64 with numpy
    (the JAX package's tables, bit for bit)."""
    d = np.arange(n_out, dtype=np.float64)
    s = (d + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(s).astype(np.int64)
    w1 = (s - i0).astype(np.float32)
    # edge clamp: when both taps collapse to the same pixel the weight
    # cancels, so no weight adjustment is needed
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    return (torch.from_numpy(i0c), torch.from_numpy(i1c),
            torch.from_numpy(w1))


@functools.lru_cache(maxsize=None)
def _resize_tables_on(n_in: int, n_out: int, device: torch.device):
    return tuple(t.to(device) for t in _resize_tables(n_in, n_out))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize INTER_LINEAR: half-pixel centers, edge clamp.

    src = (dst + 0.5) * (in/out) - 0.5; separable lerp with precomputed
    index/weight tables.
    """
    in_h, in_w = x.shape[-2], x.shape[-1]
    ry0, ry1, wy = _resize_tables_on(in_h, out_h, x.device)
    cx0, cx1, wx = _resize_tables_on(in_w, out_w, x.device)

    x = x.index_select(-2, ry0) * (1.0 - wy[:, None]) + \
        x.index_select(-2, ry1) * wy[:, None]
    x = x.index_select(-1, cx0) * (1.0 - wx) + \
        x.index_select(-1, cx1) * wx
    return x
