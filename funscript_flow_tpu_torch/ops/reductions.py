"""Per-pair reductions: center-of-motion, cut detection, radial projection.

Everything the reference computes per frame pair *after* the dense flow —
divergence-argmax center (FunscriptFlow.pyw:748-758, 884), mean-magnitude cut
flag (:888-894), +/-6-pair temporal center smoothing (:1200-1214), and the
camera-motion-cancelling weighted radial projection (:761-785) — batched over
the pair axis so flow fields never leave the device; only [B] scalars and
[B, 2] centers return to the host.

Flow travels as (u, v) planes, each [B, H, W] float32, as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = [
    "divergence",
    "max_divergence_center",
    "mean_flow_magnitude",
    "smooth_centers",
    "radial_motion_weighted",
]

CENTER_SMOOTH_RADIUS = 6  # reference :1206 (6 pairs each direction)


def _grad(a: torch.Tensor, dim: int) -> torch.Tensor:
    """np.gradient along ``dim``: central differences inside, one-sided at
    the two edges."""
    n = a.shape[dim]
    lead = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    mid = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    tail = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    return torch.cat([lead, mid, tail], dim=dim)


def divergence(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """np.gradient-style 'divergence' d(u)/drow + d(v)/dcol, [B, H, W].

    Faithful to the reference's axis pairing (FunscriptFlow.pyw:754): the
    x-flow component is differentiated along rows and the y-flow component
    along columns — not the mathematical divergence, but it is the behavior
    the center selection was tuned on (SURVEY.md §2.1 #8).
    """
    return _grad(u, 1) + _grad(v, 2)


def max_divergence_center(u: torch.Tensor, v: torch.Tensor):
    """Argmax-of-|divergence| center per pair (reference :748-758, :884).

    Returns (centers [B, 2] float32 as (x, y), values [B]). First-occurrence
    argmax in row-major order, like np.argmax (torch.argmax returns the
    first maximal index).
    """
    div = divergence(u, v)
    B, H, W = div.shape
    flat = div.reshape(B, H * W)
    idx = torch.argmax(flat.abs(), dim=1)
    y = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    x = (idx % W).to(torch.float32)
    val = torch.gather(flat, 1, idx[:, None])[:, 0]
    return torch.stack([x, y], dim=-1), val


def mean_flow_magnitude(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mean |flow| per pair, [B] — the cut statistic (reference :889-894)."""
    return torch.hypot(u, v).mean(dim=(1, 2))


def smooth_centers(centers: torch.Tensor, n_valid: int,
                   radius: int = CENTER_SMOOTH_RADIUS) -> torch.Tensor:
    """Mean of each center with up to ``radius`` neighbors per side
    (:1203-1214).

    The window truncates at index 0 and at ``n_valid`` (callers that stitch
    windows pass a halo, so this truncation only happens at true video
    edges). Windowed mean via cumsum over the small pair axis.
    """
    B = centers.shape[0]
    i = torch.arange(B, device=centers.device)
    cs = torch.cumsum(centers, dim=0)
    zero = torch.zeros((1, centers.shape[1]), dtype=centers.dtype,
                       device=centers.device)
    cs = torch.cat([zero, cs], dim=0)  # cs[k] = sum of first k
    lo = torch.clamp(i - radius, min=0)
    hi = torch.clamp(i + radius, max=max(int(n_valid) - 1, 0))
    total = cs[hi + 1] - cs[lo]
    count = (hi - lo + 1).to(centers.dtype)
    return total / count[:, None]


def radial_motion_weighted(u: torch.Tensor, v: torch.Tensor,
                           centers: torch.Tensor, cuts: torch.Tensor,
                           pov_mode: bool = False) -> torch.Tensor:
    """Signed expansion scalar per pair (reference :761-785), [B].

    dot = flow . (pixel - center); POV mode returns the plain mean;
    otherwise the dot is weighted so the two sides of the center contribute
    equally in x and y (camera-motion cancellation, :781-783), with the
    reference's strict ``>`` tests. Cut pairs return 0.
    """
    B, H, W = u.shape
    ys = torch.arange(H, dtype=torch.float32, device=u.device)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=u.device)[None, None, :]
    cx = centers[:, 0][:, None, None]
    cy = centers[:, 1][:, None, None]
    dot = u * (xs - cx) + v * (ys - cy)
    if pov_mode:
        val = dot.mean(dim=(1, 2))
    else:
        wdot = torch.where(xs > cx, dot * (W - xs) / W, dot * xs / W)
        wdot = torch.where(ys > cy, wdot * (H - ys) / H, wdot * ys / H)
        val = wdot.mean(dim=(1, 2))
    return torch.where(cuts, torch.zeros_like(val), val)
