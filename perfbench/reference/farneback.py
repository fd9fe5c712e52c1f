"""Plain pyramidal Farnebäck flow (cv2.calcOpticalFlowFarneback, flags=0)
for the benchmark's reference.

A frozen copy of the algorithm as the port's plain path computes it
(pyr_scale 0.5, levels 3, winsize 15, iterations 3, poly_n 5, poly_sigma
1.2; the reference's call, FunscriptFlow.pyw:878-879), with no kernel and
no batching of its own: every step is plain PyTorch in the dtype of the
frames it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from .image import box_blur, cv_round, gaussian_blur, resize_bilinear, sepconv

_MIN_PYR_SIZE = 32
_BORDER = 5
_BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)

PYR_SCALE = 0.5
LEVELS = 3
WINSIZE = 15
ITERATIONS = 3
POLY_N = 5
POLY_SIGMA = 1.2


def pyramid_plan(h: int, w: int):
    """(scale, height, width, smooth sigma, smooth ksize) per level,
    coarsest first; levels stop at 32 px, as OpenCV's do."""
    n_levels, scale = 0, 1.0
    for k in range(LEVELS):
        scale *= PYR_SCALE
        if w * scale < _MIN_PYR_SIZE or h * scale < _MIN_PYR_SIZE:
            break
        n_levels = k + 1
    plan = []
    for k in range(n_levels, -1, -1):
        s = 1.0
        for _ in range(k):
            s *= PYR_SCALE
        sigma = (1.0 / s - 1.0) * 0.5
        ksize = max(cv_round(sigma * 5) | 1, 3)
        plan.append((s, cv_round(h * s), cv_round(w * s), sigma, ksize))
    return plan


def _poly_tables(poly_n: int, poly_sigma: float):
    i = np.arange(-poly_n, poly_n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * poly_sigma * poly_sigma))
    g /= g.sum()
    xg, xxg = i * g, i * i * g
    s2 = float((g * i * i).sum())
    s4 = float((g * i ** 4).sum())
    G = np.zeros((6, 6))
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = s2 * s2
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = s2
    G[3, 4] = G[4, 3] = s2 * s2
    inv = np.linalg.inv(G)
    return (g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32),
            (inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]))


def poly_exp(img: torch.Tensor):
    """The five expansion planes (bx, by, Axx, Ayy, Axy2) of img [B, H, W]."""
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_tables(POLY_N, POLY_SIGMA)
    bc = sepconv(img, g, g)
    bx = sepconv(img, g, xg)
    by = sepconv(img, xg, g)
    bxx = sepconv(img, g, xxg)
    byy = sepconv(img, xxg, g)
    bxy = sepconv(img, xg, xg)
    return (bx * ig11, by * ig11, bc * ig03 + bxx * ig33,
            bc * ig03 + byy * ig33, bxy * ig55)


def _border_scale(h: int, w: int, device, dtype) -> torch.Tensor:
    def axis(n):
        s = np.ones(n, dtype=np.float32)
        for i in range(min(_BORDER, n)):
            s[i] *= _BORDER_SCALE[i]
            s[n - 1 - i] *= _BORDER_SCALE[i]
        return s
    m = np.outer(axis(h), axis(w)).astype(np.float32)
    return torch.from_numpy(m).to(device=device, dtype=dtype)[None]


def _iota(h: int, w: int, device, dtype):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys.to(dtype), xs.to(dtype)


def warp_bilinear(R, u, v):
    """The planes of R [B, P, H, W] sampled bilinearly at (x + u, y + v),
    each corner clamped on its own."""
    B, P, H, W = R.shape
    ys, xs = _iota(H, W, u.device, u.dtype)
    fx, fy = xs + u, ys + v
    x1, y1 = torch.floor(fx), torch.floor(fy)
    wx = (fx - x1)[:, None]
    wy = (fy - y1)[:, None]
    x0c = x1.clamp(0, W - 1).long()
    y0c = y1.clamp(0, H - 1).long()
    x1c = (x0c + 1).clamp(max=W - 1)
    y1c = (y0c + 1).clamp(max=H - 1)
    flat = R.reshape(B, P, H * W)

    def corner(yy, xx):
        idx = (yy * W + xx).reshape(B, 1, H * W).expand(B, P, H * W)
        return torch.gather(flat, 2, idx).reshape(B, P, H, W)

    g00, g01 = corner(y0c, x0c), corner(y0c, x1c)
    g10, g11 = corner(y1c, x0c), corner(y1c, x1c)
    return (g00 * (1 - wx) + g01 * wx) * (1 - wy) + \
           (g10 * (1 - wx) + g11 * wx) * wy


def _inbounds(u, v):
    B, H, W = u.shape
    ys, xs = _iota(H, W, u.device, u.dtype)
    x1 = torch.floor(xs + u)
    y1 = torch.floor(ys + v)
    return (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)


def _matrices(R0, warped, inb, u, v):
    H, W = u.shape[1], u.shape[2]
    w0, w1, w2, w3, w4 = warped
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    r2 = torch.where(inb, w0, zero)
    r3 = torch.where(inb, w1, zero)
    r4 = torch.where(inb, (R0[2] + w2) * 0.5, R0[2])
    r5 = torch.where(inb, (R0[3] + w3) * 0.5, R0[3])
    r6 = torch.where(inb, (R0[4] + w4) * 0.25, R0[4] * 0.5)
    r2 = (R0[0] - r2) * 0.5
    r3 = (R0[1] - r3) * 0.5
    r2 = r2 + r4 * u + r6 * v
    r3 = r3 + r6 * u + r5 * v
    scale = _border_scale(H, W, u.device, u.dtype)
    r2, r3, r4, r5, r6 = (r * scale for r in (r2, r3, r4, r5, r6))
    return (r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
            r4 * r2 + r6 * r3, r6 * r2 + r5 * r3)


def _solve(M):
    g11, g12, g22, h1, h2 = (box_blur(m, WINSIZE) for m in M)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return (g22 * h1 - g12 * h2) * idet, (g11 * h2 - g12 * h1) * idet


def flow(f0: torch.Tensor, f1: torch.Tensor):
    """(u, v) [B, H, W] of the frame pairs f0, f1 [B, H, W] (already in
    the dtype to compute in)."""
    B, H, W = f0.shape
    u = v = None
    for (s, lh, lw, sigma, ksize) in pyramid_plan(H, W):
        i0 = resize_bilinear(gaussian_blur(f0, ksize, sigma), lh, lw)
        i1 = resize_bilinear(gaussian_blur(f1, ksize, sigma), lh, lw)
        R0 = poly_exp(i0)
        R1 = torch.stack(poly_exp(i1), 1)
        if u is None:
            u = torch.zeros((B, lh, lw), dtype=f0.dtype, device=f0.device)
            v = torch.zeros((B, lh, lw), dtype=f0.dtype, device=f0.device)
        else:
            u = resize_bilinear(u, lh, lw) * (1.0 / PYR_SCALE)
            v = resize_bilinear(v, lh, lw) * (1.0 / PYR_SCALE)

        def matrices(u, v, R0=R0, R1=R1):
            warped = warp_bilinear(R1, u, v).unbind(1)
            return _matrices(R0, warped, _inbounds(u, v), u, v)

        M = matrices(u, v)
        for i in range(ITERATIONS):
            u, v = _solve(M)
            if i < ITERATIONS - 1:
                M = matrices(u, v)
    return u, v
