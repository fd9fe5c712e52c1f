"""Host-side (NumPy, float64) signal chain — the exact behavioral reference.

This module is a from-scratch reimplementation of the 1-D signal chain the
reference inlines in its per-video driver (reference: FunscriptFlow.pyw
:1266-1397). The PyTorch port's own copy: the port runs its whole signal
chain here (there is no device chain in the port yet), and this module is
also the documentation of the output contract, including reference quirks
matched bit-for-bit (they are behavior, not defects we are licensed to
change):

   * segments shorter than 5 samples are mean-subtracted but never weighted,
     so the global ``/ max(weight_sum, 1e-6)`` multiplies them by 1e6
     (reference :1306-1307, :1331);
   * Hann windows zero the first/last sample of each detrend window, so
     positions covered only by window endpoints come out exactly 0;
   * a length-1 signal emits index 0 twice in keyframe reduction
     (reference :1367, :1374);
   * ``pos`` is inverted: ``100 - round(norm)`` (reference :1382).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "integrate_flow",
    "detrend",
    "binomial_smooth",
    "rolling_normalize",
    "keyframe_indices",
    "actions_from_signal",
    "actions_at",
    "signal_chain",
]

BINOMIAL_KERNEL = np.array([1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16], dtype=np.float64)
DISCONTINUITY_THRESHOLD = 1000.0  # reference :1288


def integrate_flow(dots: np.ndarray, cuts: np.ndarray) -> np.ndarray:
    """Midpoint integration with cut resets and half-step phase correction.

    Reference: FunscriptFlow.pyw:1266-1284. ``cum[0] = 0``; for i >= 1 a cut at
    i resets the accumulator to 0, otherwise ``cum[i] = cum[i-1] +
    (dots[i-1] + dots[i]) / 2``. Afterwards the curve is shifted back half a
    sample: ``out[i] = (cum[i] + cum[i-1]) / 2`` (out[0] unchanged). The cut
    flag of pair 0 is ignored, as in the reference.
    """
    dots = np.asarray(dots, dtype=np.float64)
    cuts = np.asarray(cuts, dtype=bool)
    n = len(dots)
    cum = np.zeros(n, dtype=np.float64)
    for i in range(1, n):
        if cuts[i]:
            cum[i] = 0.0
        else:
            cum[i] = cum[i - 1] + (dots[i - 1] + dots[i]) / 2.0
    out = cum.copy()
    out[1:] = (cum[1:] + cum[:-1]) / 2.0
    return out


def _linear_residual(segment: np.ndarray) -> np.ndarray:
    """Residual after removing the least-squares line (reference :1312-1314)."""
    x = np.arange(len(segment), dtype=np.float64)
    coeffs = np.polyfit(x, segment, 1)
    return segment - np.polyval(coeffs, x)


def detrend(cum_flow: np.ndarray, detrend_win: int) -> np.ndarray:
    """Discontinuity-segmented, Hann-overlap-add windowed linear detrend.

    Reference: FunscriptFlow.pyw:1286-1331. Splits at |diff| > 1000, then per
    segment: < 5 samples -> subtract mean (no weights, see module docstring);
    <= detrend_win -> single Hann-weighted linear residual; else overlapping
    windows of ``detrend_win`` at hop ``detrend_win // 2``.
    """
    x = np.asarray(cum_flow, dtype=np.float64)
    n = len(x)
    detrended = np.zeros(n, dtype=np.float64)
    weight_sum = np.zeros(n, dtype=np.float64)

    disc = np.where(np.abs(np.diff(x)) > DISCONTINUITY_THRESHOLD)[0] + 1
    boundaries = [0] + list(disc) + [n]
    overlap = detrend_win // 2

    for seg_start, seg_end in zip(boundaries[:-1], boundaries[1:]):
        seg_len = seg_end - seg_start
        if seg_len < 5:
            detrended[seg_start:seg_end] = x[seg_start:seg_end] - np.mean(
                x[seg_start:seg_end]
            )
            continue
        if seg_len <= detrend_win:
            res = _linear_residual(x[seg_start:seg_end])
            w = np.hanning(seg_len)
            detrended[seg_start:seg_end] += res * w
            weight_sum[seg_start:seg_end] += w
        else:
            for start in range(seg_start, seg_end - overlap, overlap):
                end = min(start + detrend_win, seg_end)
                res = _linear_residual(x[start:end])
                w = np.hanning(end - start)
                detrended[start:end] += res * w
                weight_sum[start:end] += w

    return detrended / np.maximum(weight_sum, 1e-6)


def binomial_smooth(x: np.ndarray) -> np.ndarray:
    """5-tap binomial smoothing, zero-padded 'same' conv (reference :1333)."""
    return np.convolve(np.asarray(x, dtype=np.float64), BINOMIAL_KERNEL, mode="same")


def rolling_normalize(x: np.ndarray, norm_win: int) -> np.ndarray:
    """Centered rolling min-max normalization to 0-100 (reference :1335-1349).

    ``norm_win`` is forced odd; the window clamps (shrinks) at the edges; a
    flat window maps to 50.
    """
    x = np.asarray(x, dtype=np.float64)
    if norm_win % 2 == 0:
        norm_win += 1
    half = norm_win // 2
    n = len(x)
    out = np.empty(n, dtype=np.float64)
    for i in range(n):
        lo = max(0, i - half)
        hi = min(n, i + half + 1)
        w = x[lo:hi]
        wmin, wmax = w.min(), w.max()
        if wmax - wmin == 0:
            out[i] = 50.0
        else:
            out[i] = (x[i] - wmin) / (wmax - wmin) * 100.0
    return out


def keyframe_indices(norm: np.ndarray) -> list:
    """Local-extrema keyframe reduction (reference :1366-1374).

    Keeps index 0, every slope-sign inversion ``(d1 < 0) != (d2 < 0)``, and the
    last index. A length-1 input yields [0, 0], matching the reference.
    """
    idx = [0]
    for i in range(1, len(norm) - 1):
        d1 = norm[i] - norm[i - 1]
        d2 = norm[i + 1] - norm[i]
        if (d1 < 0) != (d2 < 0):
            idx.append(i)
    idx.append(len(norm) - 1)
    return idx


def actions_from_signal(norm, time_stamps, fps, keyframe_reduction=True, log_func=None):
    """Funscript action list (reference :1366-1386).

    ``at = int(frame_idx / fps * 1000)`` uses the *original* video fps and
    frame indices; ``pos = 100 - int(round(norm))`` (inverted). Per-action
    failures are logged and skipped, as in the reference (:1378-1385) — e.g.
    signals shorter than the 5-tap smoothing kernel grow to length 5 under
    ``np.convolve(mode='same')`` and can index past the timestamp array.
    """
    idx = keyframe_indices(norm) if keyframe_reduction else range(len(norm))
    return actions_at(idx, norm, time_stamps, fps, log_func)


def actions_at(idx, norm, time_stamps, fps, log_func=None):
    """The actions at the signal indices ``idx``, as
    :func:`actions_from_signal` emits them (the device chain selects its
    keyframes on the card and emits here)."""
    actions = []
    for ki in idx:
        try:
            actions.append(
                {
                    "at": int((time_stamps[ki] / fps) * 1000),
                    "pos": 100 - int(round(norm[ki])),
                }
            )
        except Exception as e:  # faithful to reference error isolation
            if log_func is not None:
                log_func(f"Error computing action at segment index {ki}: {e}")
    return actions


def signal_chain(
    dots,
    cuts,
    time_stamps,
    fps,
    detrend_win: int,
    norm_win: int,
    keyframe_reduction: bool = True,
):
    """Full per-video signal chain: per-pair scalars -> funscript actions.

    Mirrors the inline chain of the reference driver (FunscriptFlow.pyw
    :1266-1397). ``detrend_win``/``norm_win`` are sample counts, i.e. already
    multiplied by the effective fps by the caller (reference :1287, :1335).
    Returns ``(actions, norm_curve)``.
    """
    cum = integrate_flow(dots, cuts)
    det = detrend(cum, detrend_win)
    smooth = binomial_smooth(det)
    norm = rolling_normalize(smooth, norm_win)
    actions = actions_from_signal(norm, time_stamps, fps, keyframe_reduction)
    return actions, norm
