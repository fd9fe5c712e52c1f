"""Plain float64 signal chain for the benchmark's reference: per-pair
scalars to funscript actions (FunscriptFlow.pyw:1266-1397): midpoint
integration with cut resets, Hann-windowed linear detrend split at
discontinuities, 5-tap binomial smoothing, centred rolling min-max
normalisation, local-extrema keyframes, ``pos = 100 - round(norm)``.
"""

from __future__ import annotations

import numpy as np

BINOMIAL = np.array([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16], dtype=np.float64)
DISCONTINUITY = 1000.0


def integrate(dots, cuts):
    dots = np.asarray(dots, dtype=np.float64)
    n = len(dots)
    cum = np.zeros(n, dtype=np.float64)
    for i in range(1, n):
        cum[i] = 0.0 if cuts[i] else cum[i - 1] + (dots[i - 1] + dots[i]) / 2.0
    out = cum.copy()
    out[1:] = (cum[1:] + cum[:-1]) / 2.0
    return out


def _residual(seg):
    x = np.arange(len(seg), dtype=np.float64)
    return seg - np.polyval(np.polyfit(x, seg, 1), x)


def detrend(x, win: int):
    n = len(x)
    out = np.zeros(n, dtype=np.float64)
    wsum = np.zeros(n, dtype=np.float64)
    disc = np.where(np.abs(np.diff(x)) > DISCONTINUITY)[0] + 1
    bounds = [0] + list(disc) + [n]
    hop = win // 2
    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a < 5:
            out[a:b] = x[a:b] - np.mean(x[a:b])
            continue
        if b - a <= win:
            w = np.hanning(b - a)
            out[a:b] += _residual(x[a:b]) * w
            wsum[a:b] += w
            continue
        for s in range(a, b - hop, hop):
            e = min(s + win, b)
            w = np.hanning(e - s)
            out[s:e] += _residual(x[s:e]) * w
            wsum[s:e] += w
    return out / np.maximum(wsum, 1e-6)


def normalize(x, win: int):
    if win % 2 == 0:
        win += 1
    half = win // 2
    n = len(x)
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        w = x[max(0, i - half): min(n, i + half + 1)]
        lo, hi = w.min(), w.max()
        out[i] = 50.0 if hi - lo == 0 else (x[i] - lo) / (hi - lo) * 100.0
    return out


def keyframes(norm):
    idx = [0]
    for i in range(1, len(norm) - 1):
        if (norm[i] - norm[i - 1] < 0) != (norm[i + 1] - norm[i] < 0):
            idx.append(i)
    idx.append(len(norm) - 1)
    return idx


def actions(dots, cuts, step: int, fps: float, effective_fps: float,
            detrend_window: float, norm_window: float,
            keyframe_reduction: bool = True):
    """The funscript actions of one clip's per-pair scalars."""
    n = len(dots)
    stamps = np.arange(n) * step
    norm = normalize(np.convolve(
        detrend(integrate(dots, cuts), int(detrend_window * effective_fps)),
        BINOMIAL, mode="same"), int(norm_window * effective_fps))
    idx = keyframes(norm) if keyframe_reduction else range(n)
    out = []
    for k in idx:
        if k < n:  # np.convolve grows signals shorter than 5 samples
            out.append({"at": int((stamps[k] / fps) * 1000),
                         "pos": 100 - int(round(norm[k]))})
    return out
