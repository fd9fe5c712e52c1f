"""Sequence-parallel (time-axis-sharded) signal chain over a device list
(the port of the JAX package's ``parallel/signal_sp.py``).

The per-pair scalar timeline of one long video is cut into D equal shards,
one tensor on each device, and the whole 1-D chain runs shard by shard:

* integration — the cut-segmented prefix sum is a segmented scan: a local
  affine scan per shard (``ops.signal._affine_scan``), then an exclusive
  inter-shard carry folded on the host from the per-shard composites, and
  applied locally;
* detrend — the global Hann window grid is recomputed per shard from its
  global offset; a halo of ``detrend_win`` samples per side lets every
  shard evaluate every window that overlaps its range (windows straddling
  two shards are computed on both, identically), and the overlap-add is a
  gather in slot order, as in ``ops.signal``;
* smoothing / rolling normalization / keyframe mask — halos of 2 /
  ``norm_win // 2`` / 1 samples, then purely local work.

One process drives all the devices, as the JAX package's single-controller
``shard_map`` does: a halo is a slice of the neighbouring shards copied to
the shard's device, so the chain needs no process group and tests on the
CPU with a list of CPU devices. Matches ``ops.signal.signal_chain_device``
for n > detrend_win (the sharded path assumes the window-grid detrend;
shorter signals belong on one device — ``runner.compute_actions`` routes
them there).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.signal import (BINOMIAL_KERNEL, _affine_scan, _hann,
                          _masked_linear_residual)

__all__ = ["signal_chain_sharded"]


class _Shards:
    """D equal shards of one padded signal, shard d on ``devices[d]``,
    holding global samples [d*L, (d+1)*L); samples at or past ``n`` are
    padding."""

    def __init__(self, parts: list, devices: list, n: int):
        self.parts, self.devices, self.n = parts, devices, n
        self.L = parts[0].shape[0]

    def map(self, fn) -> "_Shards":
        return _Shards([fn(d, x) for d, x in enumerate(self.parts)],
                       self.devices, self.n)

    def gidx(self, d: int, lo: int = 0, hi: int = 0) -> torch.Tensor:
        """Global indices of shard d's samples, widened by ``lo`` before
        and ``hi`` after."""
        g0 = d * self.L
        return torch.arange(g0 - lo, g0 + self.L + hi, device=self.devices[d])

    def halo(self, d: int, k: int, fill: float = 0.0):
        """(left, right): the k samples before and after shard d, copied
        from its neighbours to its device (as many neighbours as k spans);
        samples outside the signal's [0, D*L) are ``fill``."""
        D, L, dev = len(self.parts), self.L, self.devices[d]

        def fill_of(m: int) -> torch.Tensor:
            return torch.full((m,), fill, dtype=self.parts[d].dtype,
                              device=dev)

        def take(lo: int, hi: int) -> torch.Tensor:  # global [lo, hi)
            out = [fill_of(min(hi, 0) - lo)] if lo < 0 else []
            g = max(lo, 0)
            while g < min(hi, D * L):
                s, o = divmod(g, L)
                e = min(hi, (s + 1) * L)
                out.append(self.parts[s][o : o + e - g].to(dev))
                g = e
            if hi > D * L:
                out.append(fill_of(hi - max(lo, D * L)))
            return torch.cat(out)

        g0 = d * L
        return take(g0 - k, g0), take(g0 + L, g0 + L + k)

    def extended(self, d: int, k: int, fill: float = 0.0) -> torch.Tensor:
        """Shard d with k halo samples on each side, samples outside
        [0, n) set to ``fill``."""
        left, right = self.halo(d, k, fill)
        xx = torch.cat([left, self.parts[d], right])
        g = self.gidx(d, k, k)
        return torch.where((g >= 0) & (g < self.n), xx, fill)

    def gather(self) -> np.ndarray:
        return torch.cat([p.cpu() for p in self.parts]).numpy()[: self.n]


def _integrate_sp(dots: _Shards, cuts: _Shards) -> _Shards:
    """Segmented midpoint integration + half-step shift, with an exclusive
    inter-shard carry folded on the host."""
    n = dots.n

    def local(d, x):
        gi = dots.gidx(d)
        dl, _ = dots.halo(d, 1)
        g = (torch.cat([dl, x[:-1]]) + x) * 0.5
        keep = torch.logical_not(cuts.parts[d]).to(torch.float32)
        a = torch.where(gi == 0, 0.0, keep)
        b = torch.where(gi == 0, 0.0, g * keep)
        a = torch.where(gi >= n, 1.0, a)  # identity past the valid range
        b = torch.where(gi >= n, 0.0, b)
        return _affine_scan(a, b)

    scans = [local(d, x) for d, x in enumerate(dots.parts)]
    # each shard's composite map, then the exclusive prefix of their
    # composition (float32, left to right, as the JAX package's lax.scan)
    carry, carries = np.float32(0.0), []
    for A, B in scans:
        carries.append(carry)
        carry = np.float32(A[-1].item()) * carry + np.float32(B[-1].item())
    cum = _Shards([A * float(c) + B for (A, B), c in zip(scans, carries)],
                  dots.devices, n)

    def shift(d, x):
        cl, _ = cum.halo(d, 1)
        return torch.where(cum.gidx(d) == 0, x,
                           (x + torch.cat([cl, x[:-1]])) * 0.5)

    return cum.map(shift)


def _detrend_sp(x: _Shards, detrend_win: int) -> _Shards:
    """Window-grid Hann overlap-add detrend with a ``detrend_win`` halo."""
    n, L, win = x.n, x.L, detrend_win
    hop = max(win // 2, 1)
    k = win
    depth = -(-win // hop)
    W = (L + win) // hop + 2  # slots that can overlap a shard

    def local(d, _):
        dev = x.devices[d]
        g0 = d * L
        xx = x.extended(d, k)
        # the global window grid: starts m*hop overlapping (g0 - win, g0 + L)
        m_min = (g0 - win) // hop + 1
        starts = (m_min + torch.arange(W, device=dev)) * hop
        slot_valid = ((starts >= 0) & (starts < n - hop)
                      & (starts < g0 + L) & (starts + win > g0))
        lengths = torch.clamp(n - starts, 0, win)[:, None]
        t = torch.arange(win, device=dev)
        pos = torch.clamp(starts[:, None] - g0 + k + t[None, :], 0,
                          L + 2 * k - 1)
        tb = t.expand(pos.shape)
        res = _masked_linear_residual(xx[pos], tb, lengths)
        w = _hann(tb, lengths)
        mask = (slot_valid[:, None] & (tb < lengths)).to(torch.float32)
        contrib = (res * w * mask).reshape(-1)
        wcontrib = (w * mask).reshape(-1)
        # overlap-add as a gather over the slots covering each sample, from
        # the lowest slot up (ops.signal.detrend_single_segment's order)
        gi = x.gidx(d)
        acc = torch.zeros(L, dtype=torch.float32, device=dev)
        wsum = torch.zeros(L, dtype=torch.float32, device=dev)
        for j in range(depth - 1, -1, -1):
            m = gi // hop - j
            off = gi - m * hop
            slot = m - m_min
            ok = (slot >= 0) & (slot < W) & (off < win)
            flat = torch.where(ok, slot * win + off, 0)
            acc = acc + torch.where(ok, contrib[flat], 0.0)
            wsum = wsum + torch.where(ok, wcontrib[flat], 0.0)
        y = acc / torch.clamp(wsum, min=1e-6)
        return torch.where(gi < n, y, 0.0)

    return x.map(local)


def _binomial_sp(x: _Shards) -> _Shards:
    L = x.L

    def local(d, _):
        xx = x.extended(d, 2)
        out = xx[0:L] * BINOMIAL_KERNEL[0]
        for j in range(1, 5):
            out = out + xx[j : j + L] * BINOMIAL_KERNEL[j]
        return out

    return x.map(local)


def _rolling_norm_sp(x: _Shards, norm_win: int) -> _Shards:
    if norm_win % 2 == 0:
        norm_win += 1
    h = norm_win // 2
    n = x.n
    inf = float("inf")

    def local(d, v):
        def pool(z):  # max over each full window ("valid")
            return F.max_pool1d(z[None, None], norm_win, 1)[0, 0]

        wmax = pool(x.extended(d, h, -inf))
        wmin = -pool(-x.extended(d, h, inf))
        span = wmax - wmin
        flat = span == 0
        out = torch.where(flat, 50.0,
                          (v - wmin) / torch.where(flat, 1.0, span) * 100.0)
        return torch.where(x.gidx(d) < n, out, 0.0)

    return x.map(local)


def _keyframe_sp(norm: _Shards) -> _Shards:
    n = norm.n

    def local(d, v):
        gi = norm.gidx(d)
        lh, rh = norm.halo(d, 1)
        prev = torch.cat([lh, v[:-1]])
        nxt = torch.cat([v[1:], rh])
        inv = (v - prev < 0) != (nxt - v < 0)
        interior = (gi >= 1) & (gi <= n - 2)
        return (inv & interior) | (gi == 0) | (gi == n - 1)

    return norm.map(local)


@torch.inference_mode()
def signal_chain_sharded(dots: np.ndarray, cuts: np.ndarray, devices,
                         detrend_win: int, norm_win: int):
    """Host API: shard a whole-video signal over ``devices`` (a list, one
    shard each; a device may repeat) and run the chain.

    Pads to a per-device multiple; returns (norm [n], keep_mask [n]) as
    numpy arrays.
    """
    devices = list(devices)
    D = len(devices)
    n = len(dots)
    L = max(-(-n // D), 1)
    dpad = np.zeros(L * D, np.float32)
    dpad[:n] = dots
    cpad = np.zeros(L * D, bool)
    cpad[:n] = cuts

    def shard(arr):
        return _Shards([torch.from_numpy(arr[d * L : (d + 1) * L]).to(dev)
                        for d, dev in enumerate(devices)], devices, n)

    cum = _integrate_sp(shard(dpad), shard(cpad))
    norm = _rolling_norm_sp(_binomial_sp(_detrend_sp(cum, detrend_win)),
                            norm_win)
    return norm.gather(), _keyframe_sp(norm).gather()
