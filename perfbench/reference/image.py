"""Batched image primitives of the plain reference, in plain PyTorch.

Frozen copy of the plain arithmetic that the flow reference needs
(Gaussian blur with BORDER_REFLECT_101, replicate-border separable
correlation and box blur, cv2 INTER_LINEAR resize with half-pixel
centres), written in the order the port's plain path takes, so that at
float32 the two agree to float32 rounding. Every function computes in the
dtype of its input: the benchmark's control runs the same code in bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_TORCH_PAD = {"reflect101": "reflect", "replicate": "replicate"}


def cv_round(x: float) -> int:
    """cvRound: round half to even."""
    return int(np.rint(x))


def gaussian_kernel_cv(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel (with OpenCV's fixed small kernels for
    sigma <= 0 and ksize <= 7)."""
    if sigma <= 0 and ksize <= 7:
        tab = {
            1: [1.0],
            3: [0.25, 0.5, 0.25],
            5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
            7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375,
                0.03125],
        }
        if ksize in tab:
            return np.asarray(tab[ksize], dtype=np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    r = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(r * r) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad_hw(x: torch.Tensor, top: int, left: int, mode: str) -> torch.Tensor:
    lead = x.shape[:-2]
    h, w = x.shape[-2:]
    y = F.pad(x.reshape(-1, 1, h, w), (left, left, top, top),
              mode=_TORCH_PAD[mode])
    return y.reshape(*lead, h + 2 * top, w + 2 * left)


def sepconv(x: torch.Tensor, taps_y, taps_x,
            border: str = "replicate") -> torch.Tensor:
    """Separable 2-D correlation over the trailing two axes: shifted-slice
    sums, taps in order, the vertical pass first."""
    taps_y = np.asarray(taps_y, dtype=np.float32)
    taps_x = np.asarray(taps_x, dtype=np.float32)
    ry, rx = len(taps_y) // 2, len(taps_x) // 2
    H, W = x.shape[-2], x.shape[-1]
    if len(taps_y) > 1:
        xp = _pad_hw(x, ry, 0, border)
        acc = None
        for i, t in enumerate(taps_y):
            sl = xp[..., i: i + H, :]
            acc = sl * float(t) if acc is None else acc + sl * float(t)
        x = acc
    else:
        x = x * float(taps_y[0])
    if len(taps_x) > 1:
        xp = _pad_hw(x, 0, rx, border)
        acc = None
        for i, t in enumerate(taps_x):
            sl = xp[..., :, i: i + W]
            acc = sl * float(t) if acc is None else acc + sl * float(t)
        x = acc
    else:
        x = x * float(taps_x[0])
    return x


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    """cv2.GaussianBlur(ksize, sigma), BORDER_REFLECT_101."""
    k = gaussian_kernel_cv(ksize, sigma)
    return sepconv(x, k, k, border="reflect101")


def box_blur(x: torch.Tensor, win: int) -> torch.Tensor:
    """Replicate-border mean filter of odd width ``win``."""
    ones = np.ones(win, dtype=np.float32)
    return sepconv(x, ones, ones, border="replicate") * (1.0 / (win * win))


def _resize_tables(n_in: int, n_out: int, device, dtype):
    d = np.arange(n_out, dtype=np.float64)
    s = (d + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(s).astype(np.int64)
    w1 = (s - i0).astype(np.float32)
    i0c = np.clip(i0, 0, n_in - 1)
    i1c = np.clip(i0 + 1, 0, n_in - 1)
    return (torch.from_numpy(i0c).to(device), torch.from_numpy(i1c).to(device),
            torch.from_numpy(w1).to(device=device, dtype=dtype))


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize INTER_LINEAR: half-pixel centres, edge clamp."""
    in_h, in_w = x.shape[-2], x.shape[-1]
    ry0, ry1, wy = _resize_tables(in_h, out_h, x.device, x.dtype)
    cx0, cx1, wx = _resize_tables(in_w, out_w, x.device, x.dtype)
    x = x.index_select(-2, ry0) * (1.0 - wy[:, None]) + \
        x.index_select(-2, ry1) * wy[:, None]
    x = x.index_select(-1, cx0) * (1.0 - wx) + \
        x.index_select(-1, cx1) * wx
    return x
