"""Batched pyramidal Farnebäck dense optical flow in PyTorch.

The port of ``funscript_flow_tpu.ops.farneback``: the algorithm behind
``cv2.calcOpticalFlowFarneback`` (Farnebäck 2003), numerically matched to
OpenCV because the downstream center-of-motion argmax is winner-take-all.
The reference calls it with ``pyr_scale=0.5, levels=3, winsize=15,
iterations=3, poly_n=5, poly_sigma=1.2, flags=0`` (reference:
FunscriptFlow.pyw:878-879).

Layout: public functions take and return tuples of ``[B, H, W]`` float32
planes, as the JAX package does; inside the schedule the five polynomial
planes of one image travel stacked as ``[B, 5, H, W]`` (the layout the
kernels read and write).

Three steps of each pyramid level are hand-written CUDA kernels
(``ops/cuda``, sources in ``csrc/``): the polynomial expansion, the bilinear
warp of R1, and the box blur + 2x2 solve. Their plain PyTorch twins live
here (``poly_exp``, ``warp_bilinear``, ``solve_flow``): the tests hold them
against the JAX package, the kernels are held against them on the card, and
a kernel wrapper handed a CPU tensor computes its twin.
``FarnebackConfig(kernels="plain")`` runs the twins on any device — the
reference run of the kernel checks.

Matched OpenCV details (see the JAX module for the derivations):

* pyramid: per-level Gaussian smooth of the *full-res* image with
  ``sigma = (1/scale - 1) * 0.5``, ``ksize = rint(sigma*5) | 1`` (min 3),
  then one bilinear resize to ``rint(size * scale)``;
* level count: scales ``pyr_scale^k`` are used while the scaled size stays
  >= 32 px;
* polynomial expansion: separable Gaussian-applicability correlation with
  replicate borders; dual-basis inverse entries ig11/ig03/ig33/ig55;
* flow update: bilinear warp of R1 (out-of-bounds pixels fall back to
  frame-0 coefficients with zeroed residual), constraint matrices
  attenuated in a 5-px border band, win x win replicate box blur, 2x2
  solve with +1e-3 on the determinant;
* schedule: per level, M is built once, then ``iterations`` x
  (blur -> solve), rebuilding M between iterations but not after the last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .image import box_blur, cv_round, gaussian_blur, resize_bilinear, sepconv

__all__ = ["FarnebackConfig", "poly_exp", "warp_bilinear", "warp_inbounds",
           "matrices_from_warped", "solve_flow", "farneback_flow",
           "farneback_flow_planes"]

_MIN_PYR_SIZE = 32
_BORDER = 5
_BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)


class FarnebackConfig:
    """Flow parameters.

    ``kernels``: ``"auto"`` routes the three hot steps through the CUDA
    kernel wrappers (which launch their kernel on a CUDA tensor and compute
    the plain twin on a CPU tensor); ``"plain"`` runs the plain twins on
    any device.
    """

    def __init__(self, pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                 poly_n=5, poly_sigma=1.2, kernels="auto"):
        if kernels not in ("auto", "plain"):
            raise ValueError(f"Unknown kernels: {kernels}")
        self.pyr_scale = pyr_scale
        self.levels = levels
        self.winsize = winsize
        self.iterations = iterations
        self.poly_n = poly_n
        self.poly_sigma = poly_sigma
        self.kernels = kernels

    def pyramid_plan(self, h: int, w: int):
        """Per-level (scale, height, width, smooth_sigma, smooth_ksize),
        coarsest first. Mirrors OpenCV's level-count clamp at 32 px."""
        n_levels = 0
        scale = 1.0
        for k in range(self.levels):
            scale *= self.pyr_scale
            if w * scale < _MIN_PYR_SIZE or h * scale < _MIN_PYR_SIZE:
                break
            n_levels = k + 1
        plan = []
        for k in range(n_levels, -1, -1):
            s = 1.0
            for _ in range(k):
                s *= self.pyr_scale
            sigma = (1.0 / s - 1.0) * 0.5
            ksize = max(cv_round(sigma * 5) | 1, 3)
            plan.append((s, cv_round(h * s), cv_round(w * s), sigma, ksize))
        return plan


@functools.lru_cache(maxsize=None)
def _poly_exp_tables(poly_n: int, poly_sigma: float):
    """1-D applicability kernels and dual-basis inverse Gramian entries.

    Basis (1, x, y, x^2, y^2, xy) with separable Gaussian applicability;
    G is the 6x6 Gramian; we need rows (1,1), (0,3), (3,3), (5,5) of G^-1.
    """
    n = poly_n
    i = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(i * i) / (2.0 * poly_sigma * poly_sigma))
    g /= g.sum()
    xg = i * g
    xxg = i * i * g

    s2 = float((g * i * i).sum())
    s4 = float((g * i ** 4).sum())
    G = np.zeros((6, 6))
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = s2
    G[3, 3] = G[4, 4] = s4
    G[5, 5] = s2 * s2
    G[0, 3] = G[3, 0] = G[0, 4] = G[4, 0] = s2
    G[3, 4] = G[4, 3] = s2 * s2
    invG = np.linalg.inv(G)
    ig = (invG[1, 1], invG[0, 3], invG[3, 3], invG[5, 5])
    return g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32), ig


def poly_exp(img: torch.Tensor, poly_n: int, poly_sigma: float):
    """Quadratic polynomial expansion coefficients per pixel (plain twin of
    the ``poly_exp`` kernel).

    img [B, H, W] float32 -> tuple of 5 planes (bx, by, Axx, Ayy, Axy2),
    each [B, H, W]; the local model is f ~ c + b.x + x^T A x. The Axy2
    plane stores the xy projection before the /2 that turns it into A's
    off-diagonal (folded into ``matrices_from_warped``' 0.25, as in OpenCV).
    """
    g, xg, xxg, (ig11, ig03, ig33, ig55) = _poly_exp_tables(poly_n, poly_sigma)

    bc = sepconv(img, g, g)       # constant projection
    bx = sepconv(img, g, xg)      # x-linear
    by = sepconv(img, xg, g)      # y-linear
    bxx = sepconv(img, g, xxg)    # x^2
    byy = sepconv(img, xxg, g)    # y^2
    bxy = sepconv(img, xg, xg)    # xy

    return (
        bx * ig11,
        by * ig11,
        bc * ig03 + bxx * ig33,
        bc * ig03 + byy * ig33,
        bxy * ig55,
    )


@functools.lru_cache(maxsize=None)
def _border_scale_map(h: int, w: int):
    """[H, W] attenuation map for the 5-px border band (OpenCV's border[])."""
    def axis_scale(n):
        s = np.ones(n, dtype=np.float32)
        for i in range(min(_BORDER, n)):
            s[i] *= _BORDER_SCALE[i]
            s[n - 1 - i] *= _BORDER_SCALE[i]
        return s
    return np.outer(axis_scale(h), axis_scale(w)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _border_scale_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_border_scale_map(h, w)).to(device)[None]


def _iota(H: int, W: int, device):
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def warp_bilinear(R: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample each of the P planes of R [B, P, H, W] at (x + u, y + v),
    bilinear; returns [B, P, H, W] (plain twin of the ``warp_bilinear``
    kernel).

    Corners are clamped one by one, as the JAX f32 warp does:
    ``x0c = clip(floor(x + u), 0, W-1)``, ``x1c = min(x0c + 1, W-1)``, and
    likewise in y. Out-of-bounds pixels (:func:`warp_inbounds` False) carry
    values the caller discards.
    """
    B, P, H, W = R.shape
    ys, xs = _iota(H, W, u.device)
    fx = xs + u
    fy = ys + v
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
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


def warp_inbounds(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """OpenCV's out-of-bounds condition: floor coords outside [0, dim-2]."""
    B, H, W = u.shape
    ys, xs = _iota(H, W, u.device)
    x1 = torch.floor(xs + u)
    y1 = torch.floor(ys + v)
    return (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)


def matrices_from_warped(R0, warped, inb: torch.Tensor, u: torch.Tensor,
                         v: torch.Tensor):
    """Constraint-matrix planes (G11, G12, G22, h1, h2), each [B, H, W].

    ``R0`` and ``warped`` are 5-plane sequences (frame-0 coefficients and
    R1 warped by the current flow). Out-of-bounds pixels keep frame-0
    coefficients with zero residual; the border band is attenuated.
    """
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

    scale = _border_scale_on(H, W, u.device)
    r2, r3, r4, r5, r6 = (r * scale for r in (r2, r3, r4, r5, r6))

    return (
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    )


def solve_flow(M, winsize: int):
    """Box-blur the constraint planes and solve the regularized 2x2 system
    (plain twin of the ``box_blur_solve`` kernel).

    Returns (u, v) planes; OpenCV's flags=0 path: replicate-border mean
    filter of ``winsize``, then [G11 G12; G12 G22] [u v]^T = [h1 h2]^T with
    det + 1e-3.
    """
    g11, g12, g22, h1, h2 = (box_blur(m, winsize) for m in M)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    u = (g22 * h1 - g12 * h2) * idet
    v = (g11 * h2 - g12 * h1) * idet
    return u, v


def farneback_flow(f0: torch.Tensor, f1: torch.Tensor,
                   cfg: FarnebackConfig | None = None) -> torch.Tensor:
    """Dense flow for a batch of grayscale frame pairs.

    f0, f1: [B, H, W] uint8 or float32. Returns [B, H, W, 2] float32 flow
    in pixels (x, y), matching cv2.calcOpticalFlowFarneback(..., flags=0).
    """
    u, v = farneback_flow_planes(f0, f1, cfg)
    return torch.stack([u, v], dim=-1)


def farneback_flow_planes(f0: torch.Tensor, f1: torch.Tensor,
                          cfg: FarnebackConfig | None = None):
    """Plane-layout variant: returns (u, v), each [B, H, W] float32."""
    cfg = cfg or FarnebackConfig()
    f0 = f0.to(torch.float32)
    f1 = f1.to(torch.float32)
    B, H, W = f0.shape
    plan = cfg.pyramid_plan(H, W)

    if cfg.kernels == "auto":
        from .cuda import flow_step, polyexp, warp

        def expand(img):
            return polyexp.poly_exp(img, cfg.poly_n, cfg.poly_sigma)

        warp_fn = warp.warp_bilinear

        def solve(M):
            return flow_step.box_blur_solve(M, cfg.winsize)
    else:
        def expand(img):
            return torch.stack(poly_exp(img, cfg.poly_n, cfg.poly_sigma), 1)

        warp_fn = warp_bilinear

        def solve(M):
            return solve_flow(M, cfg.winsize)

    u = v = None
    for (s, lh, lw, sigma, ksize) in plan:
        i0 = resize_bilinear(gaussian_blur(f0, ksize, sigma), lh, lw)
        i1 = resize_bilinear(gaussian_blur(f1, ksize, sigma), lh, lw)
        R0 = expand(i0).unbind(1)
        R1 = expand(i1)  # stacked [B, 5, lh, lw]: the warp's operand

        if u is None:
            u = torch.zeros((B, lh, lw), dtype=torch.float32, device=f0.device)
            v = torch.zeros((B, lh, lw), dtype=torch.float32, device=f0.device)
        else:
            inv = 1.0 / cfg.pyr_scale
            u = resize_bilinear(u, lh, lw) * inv
            v = resize_bilinear(v, lh, lw) * inv

        def matrices(u, v, R0=R0, R1=R1):
            warped = warp_fn(R1, u, v).unbind(1)
            return matrices_from_warped(R0, warped, warp_inbounds(u, v), u, v)

        M = matrices(u, v)
        for i in range(cfg.iterations):
            u, v = solve(M)
            if i < cfg.iterations - 1:
                M = matrices(u, v)
    return u, v
