"""Device-side signal chain (PyTorch, float32) for long clips.

The port of ``funscript_flow_tpu.ops.signal``: the reference's per-video
1-D signal chain (FunscriptFlow.pyw:1266-1397) as tensor ops on the
caller's device. ``runner.compute_actions`` sends a clip here when its
signal has 65,536 samples or more and no cumulative-flow discontinuity
(or when ``signal_backend="device"``); the float64 host chain in
``signal_host`` stays the exact reference for the rest.

Every function takes the signal and ``n``, its valid length (a Python
int); samples past ``n`` are padding that the masks exclude, as in the
JAX module. The runner passes unpadded signals (the JAX package padded to
power-of-two lengths only to bound XLA compiles).

* Integration is a segmented prefix sum over affine maps
  ``c -> a*c + b``, composed by the same odd-even recursion that
  ``jax.lax.associative_scan`` uses, so the two round alike: O(log n)
  depth instead of the reference's sequential loop (:1270-1279).
* The windowed detrend is a static grid of window slots (start = w * hop)
  with a closed-form masked linear fit per slot. Its Hann overlap-add is
  a gather: each sample sums the slots that cover it in slot order, so no
  atomic scatter is involved and two runs give the same bits. The grid is
  exact for signals without discontinuities (|diff| > 1000, :1288); those
  go to the host chain.
* Rolling min-max normalization is ``max_pool1d`` with +/-inf fill beyond
  ``n``, reproducing the reference's shrink-at-edges windows (:1340-1349).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "integrate_flow",
    "detrend_single_segment",
    "binomial_smooth",
    "rolling_normalize",
    "keyframe_mask",
    "signal_chain_device",
    "has_discontinuity",
    "DISCONTINUITY_THRESHOLD",
]

BINOMIAL_KERNEL = (1 / 16, 1 / 4, 3 / 8, 1 / 4, 1 / 16)
DISCONTINUITY_THRESHOLD = 1000.0  # reference :1288


def _affine_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of the affine maps (a[i], b[i]) under
    ``(a1, b1) . (a2, b2) = (a1*a2, b1*a2 + b2)``, by the odd-even
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the half-size sequence, then fill in the even entries."""
    n = a.shape[0]
    if n < 2:
        return a, b

    def combine(l, r):
        return l[0] * r[0], l[1] * r[0] + r[1]

    odd = _affine_scan(*combine((a[0:-1:2], b[0:-1:2]), (a[1::2], b[1::2])))
    if n % 2 == 0:
        even = combine((odd[0][:-1], odd[1][:-1]), (a[2::2], b[2::2]))
    else:
        even = combine(odd, (a[2::2], b[2::2]))
    out = []
    for first, ev, od in zip((a, b), even, odd):
        t = torch.empty_like(first)
        t[0] = first[0]
        t[2::2] = ev
        t[1::2] = od
        out.append(t)
    return out[0], out[1]


def integrate_flow(dots: torch.Tensor, cuts: torch.Tensor) -> torch.Tensor:
    """Segmented midpoint integration + half-step shift (reference
    :1266-1284): ``cum[i] = cuts[i] ? 0 : cum[i-1] + (dots[i-1]+dots[i])/2``,
    then ``out[i] = (cum[i]+cum[i-1])/2``. Padding entries should be
    0/False; they give values the downstream masks discard."""
    dots = dots.to(torch.float32)
    g = torch.cat([dots.new_zeros(1), (dots[:-1] + dots[1:]) * 0.5])
    keep = torch.logical_not(cuts).to(torch.float32)
    # element i applies c -> a[i]*c + b[i]; index 0 pins cum[0] = 0
    a = keep.clone()
    a[0] = 0.0
    b = g * keep
    b[0] = 0.0
    _, cum = _affine_scan(a, b)
    shifted = (cum + torch.cat([cum[:1], cum[:-1]])) * 0.5
    shifted[0] = cum[0]
    return shifted


def _hann(t: torch.Tensor, length) -> torch.Tensor:
    """np.hanning of length ``length`` (int or tensor) at integer offsets
    ``t``: length 1 -> 1.0; entries at t >= length are 0."""
    length = torch.as_tensor(length, device=t.device)
    denom = torch.clamp(length - 1, min=1).to(torch.float32)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * t.to(torch.float32) / denom)
    w = torch.where(length == 1, 1.0, w)
    return torch.where(t < length, w, 0.0)


def _masked_linear_residual(y: torch.Tensor, t: torch.Tensor, length):
    """Residual after the least-squares line fit over the first ``length``
    samples of the trailing window axis (closed form of the reference's
    per-window ``np.polyfit(deg=1)``, :1312-1314); entries at
    ``t >= length`` are left out of the fit and zeroed."""
    length = torch.as_tensor(length, device=y.device)
    valid = (t < length).to(y.dtype)
    Lk = torch.clamp(length, min=1).to(y.dtype)
    tf = t.to(y.dtype) * valid
    yv = y * valid
    st = torch.sum(tf, -1, keepdim=True)
    stt = torch.sum(tf * tf, -1, keepdim=True)
    sy = torch.sum(yv, -1, keepdim=True)
    sty = torch.sum(tf * yv, -1, keepdim=True)
    det = Lk * stt - st * st
    safe_det = torch.where(det == 0, 1.0, det)
    slope = torch.where(det == 0, 0.0, (Lk * sty - st * sy) / safe_det)
    intercept = (sy - slope * st) / Lk
    return (y - (slope * t.to(y.dtype) + intercept)) * valid


def detrend_single_segment(x: torch.Tensor, n: int,
                           detrend_win: int) -> torch.Tensor:
    """Windowed Hann overlap-add linear detrend, single-segment case
    (reference :1300-1331 without discontinuity splits): n < 5 ->
    mean-subtract, times 1e6 (the global ``/ max(weight_sum, 1e-6)`` with
    zero weights, a faithful quirk); n <= win -> one Hann-weighted window;
    else windows of ``detrend_win`` on a hop = win//2 grid, truncated at
    ``n``."""
    P = x.shape[0]
    dev = x.device
    x = x.to(torch.float32)
    i = torch.arange(P, device=dev)
    in_range = (i < n).to(x.dtype)

    if n < 5:
        mean = torch.sum(x * in_range) / max(n, 1)
        return (x - mean) * in_range * 1e6 * in_range

    if n <= detrend_win:
        res = _masked_linear_residual(x[None, :], i[None, :], n)[0]
        w = _hann(i, n)
        return res * w / torch.clamp(w, min=1e-6) * in_range

    # grid case: static window slots at start = s * hop
    hop = max(detrend_win // 2, 1)
    n_slots = max(-(-(P - hop) // hop), 1)  # len(range(0, P - hop, hop))
    starts = torch.arange(n_slots, device=dev) * hop  # [S]
    t = torch.arange(detrend_win, device=dev)          # [win]
    idx = starts[:, None] + t[None, :]                  # [S, win]
    # slot s is emitted iff start < n - hop (reference loop bound :1320);
    # its length is min(win, n - start) (truncation at the segment end)
    slot_valid = starts < (n - hop)
    lengths = torch.clamp(n - starts, 0, detrend_win)[:, None]
    gathered = x[torch.clamp(idx, 0, P - 1)]
    tb = t.expand(idx.shape)
    res = _masked_linear_residual(gathered, tb, lengths)
    w = _hann(tb, lengths)
    mask = (slot_valid[:, None] & (tb < lengths)).to(x.dtype)
    contrib = (res * w * mask).reshape(-1)
    wcontrib = (w * mask).reshape(-1)

    # overlap-add as a gather: sample p is covered by the slots
    # s = p//hop - j, j = 0..depth-1; summing them from the lowest slot up
    # adds in the order of a sequential scatter, deterministically
    depth = -(-detrend_win // hop)
    q = i // hop
    acc = torch.zeros(P, dtype=x.dtype, device=dev)
    wsum = torch.zeros(P, dtype=x.dtype, device=dev)
    for j in range(depth - 1, -1, -1):
        s = q - j
        off = i - s * hop
        ok = (s >= 0) & (s < n_slots) & (off < detrend_win)
        flat = torch.where(ok, s * detrend_win + off, 0)
        acc = acc + torch.where(ok, contrib[flat], 0.0)
        wsum = wsum + torch.where(ok, wcontrib[flat], 0.0)
    return acc / torch.clamp(wsum, min=1e-6) * in_range


def binomial_smooth(x: torch.Tensor, n: int) -> torch.Tensor:
    """5-tap binomial smoothing, zero-padded 'same' convolution (reference
    :1333), as five shifted-slice adds (no convolution library call). The
    signal is zeroed past ``n`` first, so the padding acts as the zero
    padding ``np.convolve(mode='same')`` sees at a true array end."""
    P = x.shape[0]
    x = x * (torch.arange(P, device=x.device) < n).to(x.dtype)
    xp = F.pad(x, (2, 2))
    # the kernel is symmetric, so correlation equals convolution
    acc = xp[0:P] * BINOMIAL_KERNEL[0]
    for k in range(1, 5):
        acc = acc + xp[k : k + P] * BINOMIAL_KERNEL[k]
    return acc


def rolling_normalize(x: torch.Tensor, n: int, norm_win: int) -> torch.Tensor:
    """Centered rolling min-max normalization to 0-100 (reference
    :1335-1349). ``norm_win`` is forced odd; windows shrink at the array
    start and at ``n`` (entries past ``n`` are +/-inf fill); a flat window
    maps to 50."""
    if norm_win % 2 == 0:
        norm_win += 1
    half = norm_win // 2
    P = x.shape[0]
    inside = torch.arange(P, device=x.device) < n
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    x_min_src = torch.where(inside, x, inf)
    x_max_src = torch.where(inside, x, -inf)

    def pool(z):  # max over the centered window; max_pool1d pads with -inf
        return F.max_pool1d(z[None, None], norm_win, 1, half)[0, 0]

    wmax = pool(x_max_src)
    wmin = -pool(-x_min_src)
    span = wmax - wmin
    flat = span == 0
    out = torch.where(flat, 50.0,
                      (x - wmin) / torch.where(flat, 1.0, span) * 100.0)
    return torch.where(inside, out, 0.0)


def keyframe_mask(norm: torch.Tensor, n: int) -> torch.Tensor:
    """Boolean keep-mask of the local-extrema keyframe reduction
    (:1366-1374): True at index 0, at every interior slope-sign inversion
    ``(d1 < 0) != (d2 < 0)`` for 1 <= i <= n-2, and at index n-1. The host
    compacts it into indices (and repeats the reference's [0, 0] for
    n == 1)."""
    P = norm.shape[0]
    prev = torch.cat([norm[:1], norm[:-1]])
    nxt = torch.cat([norm[1:], norm[-1:]])
    inv = (norm - prev < 0) != (nxt - norm < 0)
    i = torch.arange(P, device=norm.device)
    interior = (i >= 1) & (i <= n - 2)
    return (inv & interior) | (i == 0) | (i == n - 1)


@torch.inference_mode()
def signal_chain_device(dots: torch.Tensor, cuts: torch.Tensor, n: int,
                        detrend_win: int, norm_win: int):
    """Per-pair scalars -> (0-100 normalized curve, keyframe keep-mask), on
    the tensors' device. Emission (timestamps, pos inversion) stays on the
    host."""
    cum = integrate_flow(dots, cuts)
    det = detrend_single_segment(cum, n, detrend_win)
    smooth = binomial_smooth(det, n)
    norm = rolling_normalize(smooth, n, norm_win)
    return norm, keyframe_mask(norm, n)


def has_discontinuity(cum_flow) -> bool:
    """Host-side check for the detrend grid re-anchoring case (:1288-1294)."""
    d = np.abs(np.diff(np.asarray(cum_flow)))
    return bool((d > DISCONTINUITY_THRESHOLD).any())
