"""DIS (Dense Inverse Search) optical flow in PyTorch — the DIS backend.

The port of ``funscript_flow_tpu.models.dis``: the reference's "DNN"
backend, which runs ``cv2.DISOpticalFlow_create(PRESET_FAST)``
(FunscriptFlow.pyw:948-980), reimplemented after Kroeger, Timofte, Dai and
Van Gool, "Fast Optical Flow using Dense Inverse Search" (ECCV 2016):
coarse-to-fine patch grid, inverse-compositional gradient descent per
patch, weighted densification, then Brox-style variational refinement
per level. The arithmetic repeats the JAX module's, op for op and in its
order; the documented deviations from cv2 (no serial spatial
propagation, per-patch densification weights) are the JAX module's.

Two steps are hand-written CUDA kernels (``ops/cuda/warp.py``, source
``csrc/warp.cu``):

* K4 ``sample_patches``: the patch sampler, which forms each patch's
  clamped corner from its offset and bilinearly samples I1 over the patch,
  once per descent step and once more for the densification weights
  (``gd_iters + 1`` launches per level);
* K5 ``warp_planes``: the one relative warp of (I1, I1x, I1y) in each
  level's variational refinement.

Their plain twins are :func:`_sample_patches_plain` (the dense grid of
:func:`_sample_patches_dense` fetched by :func:`bilinear_abs`) here and
``ops.farneback.warp_bilinear``. ``DISConfig(kernels="plain")`` runs the
twins on any device (the reference run of the kernel checks); with
``"auto"`` the wrappers launch the kernels on CUDA tensors and compute the
twins on CPU tensors.

The JAX module's per-patch window gather ``_sample_patches`` is on no
path (the dense sampler replaced it) and is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.farneback import warp_bilinear
from ..ops.image import resize_bilinear, sepconv

__all__ = ["DISConfig", "bilinear_abs", "dis_flow_planes", "dis_flow",
           "variational_refinement"]


@dataclass(frozen=True)
class DISConfig:
    """cv2 DIS preset-shaped parameters (defaults = PRESET_FAST: finest
    scale 2, patch 8/4, 16 descent iterations, 5 refinement iterations).

    ``kernels``: ``"auto"`` (the CUDA kernel wrappers) or ``"plain"`` (the
    plain PyTorch twins on any device)."""

    finest_scale: int = 2
    patch_size: int = 8
    patch_stride: int = 4
    gd_iters: int = 16
    use_mean_norm: bool = True
    var_iters: int = 5          # variational fixed-point iterations (0 = off)
    var_alpha: float = 20.0     # smoothness weight
    var_delta: float = 5.0      # intensity-constancy weight
    var_gamma: float = 10.0     # gradient-constancy weight
    var_omega: float = 1.6      # SOR relaxation
    var_sor_iters: int = 5
    kernels: str = "auto"

    def __post_init__(self):
        if self.kernels not in ("auto", "plain"):
            raise ValueError(f"Unknown kernels: {self.kernels}")

    @classmethod
    def preset(cls, name: str, kernels: str = "auto") -> "DISConfig":
        """cv2 preset equivalents: ultrafast | fast | medium."""
        name = name.lower()
        if name == "ultrafast":
            return cls(gd_iters=12, var_iters=0, kernels=kernels)
        if name == "fast":
            return cls(kernels=kernels)
        if name == "medium":
            return cls(finest_scale=1, patch_stride=3, gd_iters=25,
                       kernels=kernels)
        raise ValueError(f"Unknown DIS preset: {name}")


def _samplers(kernels: str):
    """(patch sampler, relative plane warp) for ``kernels``."""
    if kernels == "auto":
        from ..ops.cuda import warp as kwarp

        return kwarp.sample_patches, kwarp.warp_planes
    return _sample_patches_plain, _warp_planes_plain


def _warp_planes_plain(planes, u, v):
    return warp_bilinear(torch.stack(tuple(planes), dim=1), u, v)


def _pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Half-resolution: 5-tap binomial smooth + 2x subsample (pyrDown-like)."""
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    sm = sepconv(img, k, k, border="reflect101")
    return sm[..., ::2, ::2].contiguous()


def _sobel(img: torch.Tensor):
    """Sobel 3x3 gradients (cv2.spatialGradient convention)."""
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    return sepconv(img, s, d), sepconv(img, d, s)  # (d/dx, d/dy)


def _extract_patches(img: torch.Tensor, ny: int, nx: int, ps: int,
                     stride: int) -> torch.Tensor:
    """[B, h, w] -> [B, ny, nx, ps*ps], patch axis ordered dy*ps + dx (the
    JAX module's static strided slices, as one unfold)."""
    B = img.shape[0]
    p = img.unfold(1, ps, stride).unfold(2, ps, stride)  # [B, ny', nx', dy, dx]
    return p[:, :ny, :nx].reshape(B, ny, nx, ps * ps)


def _sample_patches_dense(img: torch.Tensor, py, px, uy, ux, ps: int,
                          sample) -> torch.Tensor:
    """Bilinear-sample the ps x ps patches of ``img`` [B, h, w] at corners
    (py + uy, px + ux) -> [B, ny, nx, ps*ps].

    Patch corners are clamped to [0, dim - ps]; all patch pixels are laid
    out as one dense [B, ny*ps, nx*ps] absolute coordinate grid, fetched by
    one ``sample`` call (:func:`bilinear_abs` in the twin of the
    ``sample_patches`` kernel), and folded back to the patch layout.
    """
    B, h, w = img.shape
    ny, nx = py.shape
    fy = torch.clamp(py[None] + uy, 0.0, float(h - ps))  # effective corner
    fx = torch.clamp(px[None] + ux, 0.0, float(w - ps))
    d = torch.arange(ps, dtype=torch.float32, device=img.device)
    fyd = fy[:, :, None, :, None] + d[None, None, :, None, None]
    fxd = fx[:, :, None, :, None] + d[None, None, None, None, :]
    fyd = fyd.expand(B, ny, ps, nx, ps).reshape(B, ny * ps, nx * ps)
    fxd = fxd.expand(B, ny, ps, nx, ps).reshape(B, ny * ps, nx * ps)
    val = sample(img, fyd, fxd)
    return (val.reshape(B, ny, ps, nx, ps)
               .permute(0, 1, 3, 2, 4)
               .reshape(B, ny, nx, ps * ps))


def _patch_origins(ny: int, nx: int, stride: int, device):
    """(py, px) [ny, nx]: the patch grid's corners i*stride, j*stride
    (exact in float32)."""
    ys = torch.arange(ny, dtype=torch.float32, device=device) * stride
    xs = torch.arange(nx, dtype=torch.float32, device=device) * stride
    return ys[:, None].expand(ny, nx), xs[None, :].expand(ny, nx)


def _sample_patches_plain(img: torch.Tensor, pu: torch.Tensor,
                          pv: torch.Tensor, ps: int,
                          stride: int) -> torch.Tensor:
    """The patches at the patch grid of ``stride`` moved by (pu, pv)
    [B, ny, nx] -> [B, ny, nx, ps*ps] (plain twin of the
    ``sample_patches`` kernel): :func:`_sample_patches_dense` with
    :func:`bilinear_abs`."""
    py, px = _patch_origins(pu.shape[1], pu.shape[2], stride, img.device)
    return _sample_patches_dense(img, py, px, pv, pu, ps, bilinear_abs)


def bilinear_abs(img: torch.Tensor, fy: torch.Tensor,
                 fx: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of ``img`` [B, h, w] at absolute coordinates
    (fy, fx) [B, Ho, Wo], which satisfy ``0 <= f <= dim-1`` (plain twin of
    the ``sample_abs`` kernel; the counterpart of ``_bilinear_abs_packed``).

    ``y0 = clip(floor(fy), 0, h-1)`` with the +1 neighbour edge-replicated,
    likewise in x, combined as
    ``(g00*(1-wx) + g01*wx)*(1-wy) + (g10*(1-wx) + g11*wx)*wy``.
    """
    B, h, w = img.shape
    Ho, Wo = fy.shape[1], fy.shape[2]
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = fy - y0
    wx = fx - x0
    y0i = y0.clamp(0, h - 1).long()
    x0i = x0.clamp(0, w - 1).long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    flat = img.reshape(B, h * w)

    def corner(yy, xx):
        return torch.gather(flat, 1, (yy * w + xx).reshape(B, Ho * Wo)
                            ).reshape(B, Ho, Wo)

    g00, g01 = corner(y0i, x0i), corner(y0i, x1i)
    g10, g11 = corner(y1i, x0i), corner(y1i, x1i)
    return (g00 * (1 - wx) + g01 * wx) * (1 - wy) + \
           (g10 * (1 - wx) + g11 * wx) * wy


def _d5(img: torch.Tensor):
    """5-point derivative stencil [-1, 8, 0, -8, 1]/12 (Brox'04), replicate
    borders; returns (d/dx, d/dy)."""
    k = np.array([-1.0, 8.0, 0.0, -8.0, 1.0], np.float32) / 12.0
    one = np.array([1.0], np.float32)
    # sepconv performs correlation; flip for convolution-style derivative
    kc = k[::-1].copy()
    return sepconv(img, one, kc), sepconv(img, kc, one)


def _shift_nb(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Neighbour value at (y+dy, x+dx), zero outside the image."""
    xp = F.pad(x, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
    h, w = x.shape[-2], x.shape[-1]
    y0, x0 = max(0, dy), max(0, dx)
    return xp[..., y0 : y0 + h, x0 : x0 + w]


def _iota(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def variational_refinement(I0, I1, u, v, cfg: DISConfig):
    """Brox-style dense refinement of (u, v) on one pyramid level.

    Energy: delta*psi(|I(x+w)-I(x)|^2) + gamma*psi(|grad I(x+w)-grad I(x)|^2)
    + alpha*psi(|grad w|^2), psi(s) = sqrt(s + eps^2). One linearization
    around the incoming flow (I1 and its gradients warped once, by K5 or
    its twin), ``var_iters`` fixed-point reweightings, each
    solved by ``var_sor_iters`` red-black SOR sweeps. Within each colour du
    is updated before dv, and dv reads the new du, as in the JAX module.
    """
    warp3 = _samplers(cfg.kernels)[1]
    B, h, w = I0.shape
    eps2 = 0.001 ** 2

    # clamp target coords so the warp is edge-sampling, never out-of-bounds
    ys, xs = _iota(h, w, I0.device)
    uc = (torch.clamp(xs + u, 0.0, w - 1.0) - xs).contiguous()
    vc = (torch.clamp(ys + v, 0.0, h - 1.0) - ys).contiguous()

    I1x, I1y = _d5(I1)
    W1, W1x, W1y = warp3((I1, I1x, I1y), uc, vc).unbind(1)

    I0x, I0y = _d5(I0)
    Ax, Ay = 0.5 * (W1x + I0x), 0.5 * (W1y + I0y)
    Iz = W1 - I0
    Axx, Axy = _d5(Ax)
    Ayx, Ayy = _d5(Ay)
    Axy = 0.5 * (Axy + Ayx)
    Ixz, Iyz = _d5(Iz)

    du = torch.zeros_like(u)
    dv = torch.zeros_like(v)
    iy = torch.arange(h, device=I0.device)[:, None]
    ix = torch.arange(w, device=I0.device)[None, :]
    red = ((iy + ix) % 2 == 0)[None]
    nbs = ((0, 1), (0, -1), (1, 0), (-1, 0))
    inside = torch.ones((1, h, w), dtype=torch.float32, device=I0.device)
    inside_nb = [_shift_nb(inside, dy, dx) for dy, dx in nbs]

    for _ in range(cfg.var_iters):
        # robust data weights at the current increment
        r_d = Iz + Ax * du + Ay * dv
        w_d = cfg.var_delta / torch.sqrt(r_d * r_d + eps2)
        r_gx = Ixz + Axx * du + Axy * dv
        r_gy = Iyz + Axy * du + Ayy * dv
        w_g = cfg.var_gamma / torch.sqrt(r_gx * r_gx + r_gy * r_gy + eps2)
        a11 = w_d * Ax * Ax + w_g * (Axx * Axx + Axy * Axy)
        a12 = w_d * Ax * Ay + w_g * (Axy * (Axx + Ayy))
        a22 = w_d * Ay * Ay + w_g * (Axy * Axy + Ayy * Ayy)
        b1 = -(w_d * Ax * Iz + w_g * (Axx * Ixz + Axy * Iyz))
        b2 = -(w_d * Ay * Iz + w_g * (Axy * Ixz + Ayy * Iyz))

        # robust smoothness weight of the full flow (u+du, v+dv)
        fu, fv = u + du, v + dv
        gux, guy = _d5(fu)
        gvx, gvy = _d5(fv)
        sw = cfg.var_alpha / torch.sqrt(
            gux * gux + guy * guy + gvx * gvx + gvy * gvy + eps2
        )
        wn = [0.5 * (sw + _shift_nb(sw, dy, dx)) * ins
              for (dy, dx), ins in zip(nbs, inside_nb)]
        wsum = wn[0] + wn[1] + wn[2] + wn[3]
        # smoothness acts on the FULL flow u+du: the base-flow diffusion
        # term sum_n w_n (u_n - u) is constant across SOR sweeps
        su = sum(wk * _shift_nb(u, dy, dx) for wk, (dy, dx) in zip(wn, nbs)) - wsum * u
        sv = sum(wk * _shift_nb(v, dy, dx) for wk, (dy, dx) in zip(wn, nbs)) - wsum * v
        b1s = b1 + su
        b2s = b2 + sv
        # the SOR denominators, the same sums the JAX module forms per sweep
        den_u = a11 + wsum + 1e-6
        den_v = a22 + wsum + 1e-6

        for _s in range(cfg.var_sor_iters):
            for mask in (red, ~red):
                # masked update of one colour: torch.where keeps the other
                # colour's values bit for bit, as jnp.where does
                nb_u = sum(wk * _shift_nb(du, dy, dx)
                           for wk, (dy, dx) in zip(wn, nbs))
                gs_u = (b1s - a12 * dv + nb_u) / den_u
                du = torch.where(mask, du + cfg.var_omega * (gs_u - du), du)
                nb_v = sum(wk * _shift_nb(dv, dy, dx)
                           for wk, (dy, dx) in zip(wn, nbs))
                gs_v = (b2s - a12 * du + nb_v) / den_v
                dv = torch.where(mask, dv + cfg.var_omega * (gs_v - dv), dv)

    return u + du, v + dv


def _dis_level(I0, I1, u, v, cfg: DISConfig):
    """One pyramid level: patch inverse search + densification.

    u, v: [B, h, w] initial flow at this level (from the coarser level).
    """
    sample = _samplers(cfg.kernels)[0]
    B, h, w = I0.shape
    dev = I0.device
    ps, st = cfg.patch_size, cfg.patch_stride
    ny = (h - ps) // st + 1
    nx = (w - ps) // st + 1

    gx, gy = _sobel(I0)
    T = _extract_patches(I0, ny, nx, ps, st)
    Tx = _extract_patches(gx, ny, nx, ps, st)
    Ty = _extract_patches(gy, ny, nx, ps, st)
    if cfg.use_mean_norm:
        T = T - T.mean(dim=-1, keepdim=True)

    h11 = torch.sum(Tx * Tx, -1) + 1e-3
    h12 = torch.sum(Tx * Ty, -1)
    h22 = torch.sum(Ty * Ty, -1) + 1e-3
    idet = 1.0 / (h11 * h22 - h12 * h12)

    # init patch offsets from the incoming dense flow at patch centers
    cy = torch.from_numpy(np.arange(ny) * st + ps // 2).to(dev)
    cx = torch.from_numpy(np.arange(nx) * st + ps // 2).to(dev)
    pu = u.index_select(1, cy).index_select(2, cx)
    pv = v.index_select(1, cy).index_select(2, cx)

    max_disp = float(max(h, w))

    def patches(pu, pv):
        P1 = sample(I1, pu, pv, ps, st)
        if cfg.use_mean_norm:
            P1 = P1 - P1.mean(dim=-1, keepdim=True)
        return P1

    for _ in range(cfg.gd_iters):
        r = patches(pu, pv) - T
        g1 = torch.sum(Tx * r, -1)
        g2 = torch.sum(Ty * r, -1)
        du = (h22 * g1 - h12 * g2) * idet
        dv = (h11 * g2 - h12 * g1) * idet
        pu = torch.clamp(pu - du, -max_disp, max_disp)
        pv = torch.clamp(pv - dv, -max_disp, max_disp)

    # densification weights: inverse residual energy per patch
    lam = 1.0 / torch.clamp(torch.mean((patches(pu, pv) - T) ** 2, -1),
                            min=1.0)

    # col2im: strided accumulation of (weight, weight*u, weight*v), one
    # in-place add per patch pixel in the JAX module's (dy, dx) order, so
    # every sum is taken in the same order and no atomics are involved
    acc = torch.zeros((3, B, h, w), dtype=torch.float32, device=dev)
    vals = torch.stack([lam, lam * pu, lam * pv])
    ylim = (ny - 1) * st + 1
    xlim = (nx - 1) * st + 1
    for dy in range(ps):
        for dx in range(ps):
            acc[:, :, dy : dy + ylim : st, dx : dx + xlim : st] += vals
    acc_w, acc_u, acc_v = acc.unbind(0)
    safe = torch.clamp(acc_w, min=1e-6)
    covered = acc_w > 0
    return (
        torch.where(covered, acc_u / safe, u),
        torch.where(covered, acc_v / safe, v),
    )


def dis_flow_planes(f0: torch.Tensor, f1: torch.Tensor,
                    cfg: DISConfig | None = None):
    """DIS dense flow, plane layout: [B, H, W] pair batch -> (u, v) planes."""
    cfg = cfg or DISConfig()
    f0 = f0.to(torch.float32)
    f1 = f1.to(torch.float32)
    B, H, W = f0.shape

    coarsest = max(
        cfg.finest_scale,
        int(round(math.log2(max(H, W) / (4.0 * cfg.patch_size)))),
    )
    # pyramids: index k = scale 2^-k
    pyr0 = [f0.contiguous()]
    pyr1 = [f1.contiguous()]
    for _ in range(coarsest):
        pyr0.append(_pyr_down(pyr0[-1]))
        pyr1.append(_pyr_down(pyr1[-1]))

    lh, lw = pyr0[coarsest].shape[1:]
    u = torch.zeros((B, lh, lw), dtype=torch.float32, device=f0.device)
    v = torch.zeros((B, lh, lw), dtype=torch.float32, device=f0.device)
    for k in range(coarsest, cfg.finest_scale - 1, -1):
        if k != coarsest:
            lh, lw = pyr0[k].shape[1:]
            u = resize_bilinear(u, lh, lw) * 2.0
            v = resize_bilinear(v, lh, lw) * 2.0
        u, v = _dis_level(pyr0[k], pyr1[k], u, v, cfg)
        if cfg.var_iters > 0:
            u, v = variational_refinement(pyr0[k], pyr1[k], u, v, cfg)

    scale = float(1 << cfg.finest_scale)
    u = resize_bilinear(u, H, W) * scale
    v = resize_bilinear(v, H, W) * scale
    return u, v


def dis_flow(f0: torch.Tensor, f1: torch.Tensor,
             cfg: DISConfig | None = None) -> torch.Tensor:
    """[B, H, W, 2] convenience wrapper (cv2.DISOpticalFlow.calc shape)."""
    u, v = dis_flow_planes(f0, f1, cfg)
    return torch.stack([u, v], dim=-1)
