"""Plain per-pair reductions for the benchmark's reference: the
divergence-argmax centre (FunscriptFlow.pyw:748-758, 884), the
mean-magnitude cut flag (:888-894), the +/-6-pair centre smoothing over
the whole clip (:1200-1214) and the weighted radial projection (:761-785).
"""

from __future__ import annotations

import torch

SMOOTH_RADIUS = 6


def _grad(a, dim):
    n = a.shape[dim]
    lead = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    mid = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    tail = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([lead, mid, tail], dim=dim)


def centers(u, v):
    """(x, y) of the first maximum of |d(u)/drow + d(v)/dcol| per pair."""
    div = _grad(u, 1) + _grad(v, 2)
    B, H, W = div.shape
    idx = torch.argmax(div.reshape(B, H * W).abs(), dim=1)
    y = torch.div(idx, W, rounding_mode="floor")
    return torch.stack([idx % W, y], dim=-1).to(u.dtype)


def mean_magnitude(u, v):
    return torch.hypot(u, v).mean(dim=(1, 2))


def smooth(c):
    """Mean of each centre with up to SMOOTH_RADIUS neighbours a side,
    truncated at the clip's ends."""
    n = c.shape[0]
    i = torch.arange(n, device=c.device)
    cs = torch.cat([torch.zeros((1, 2), dtype=c.dtype, device=c.device),
                    torch.cumsum(c, dim=0)], dim=0)
    lo = torch.clamp(i - SMOOTH_RADIUS, min=0)
    hi = torch.clamp(i + SMOOTH_RADIUS, max=n - 1)
    return (cs[hi + 1] - cs[lo]) / (hi - lo + 1).to(c.dtype)[:, None]


def radial(u, v, c, cuts, pov_mode: bool = False):
    """The weighted radial projection per pair; 0 on cut pairs."""
    B, H, W = u.shape
    ys = torch.arange(H, dtype=torch.float32, device=u.device).to(u.dtype)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=u.device).to(u.dtype)[None, None, :]
    cx = c[:, 0][:, None, None]
    cy = c[:, 1][:, None, None]
    dot = u * (xs - cx) + v * (ys - cy)
    if pov_mode:
        val = dot.mean(dim=(1, 2))
    else:
        wdot = torch.where(xs > cx, dot * (W - xs) / W, dot * xs / W)
        wdot = torch.where(ys > cy, wdot * (H - ys) / H, wdot * ys / H)
        val = wdot.mean(dim=(1, 2))
    return torch.where(cuts, torch.zeros_like(val), val)
