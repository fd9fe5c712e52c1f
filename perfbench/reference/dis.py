"""Plain DIS (Dense Inverse Search) flow for the benchmark's reference.

A frozen copy of the algorithm as the port's plain path computes it for
the reference's "DNN" backend (cv2.DISOpticalFlow_create(PRESET_FAST),
FunscriptFlow.pyw:948-980; Kroeger et al., ECCV 2016): a coarse-to-fine
patch grid, inverse-compositional descent per patch, weighted
densification, then a variational refinement per level. Plain PyTorch in
the dtype of the frames it is given; patches are sampled from a dense
coordinate grid and the refinement's warp stacks its three planes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .farneback import warp_bilinear
from .image import resize_bilinear, sepconv


@dataclass(frozen=True)
class Preset:
    finest_scale: int = 2
    patch_size: int = 8
    patch_stride: int = 4
    gd_iters: int = 16
    use_mean_norm: bool = True
    var_iters: int = 5
    var_alpha: float = 20.0
    var_delta: float = 5.0
    var_gamma: float = 10.0
    var_omega: float = 1.6
    var_sor_iters: int = 5


PRESETS = {
    "ultrafast": Preset(gd_iters=12, var_iters=0),
    "fast": Preset(),
    "medium": Preset(finest_scale=1, patch_stride=3, gd_iters=25),
}


def _pyr_down(img):
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16.0
    return sepconv(img, k, k, border="reflect101")[..., ::2, ::2].contiguous()


def _sobel(img):
    d = np.array([-1.0, 0.0, 1.0], np.float32)
    s = np.array([1.0, 2.0, 1.0], np.float32)
    return sepconv(img, s, d), sepconv(img, d, s)


def _extract_patches(img, ny, nx, ps, stride):
    B = img.shape[0]
    p = img.unfold(1, ps, stride).unfold(2, ps, stride)
    return p[:, :ny, :nx].reshape(B, ny, nx, ps * ps)


def _bilinear_abs(img, fy, fx):
    B, h, w = img.shape
    Ho, Wo = fy.shape[1], fy.shape[2]
    y0, x0 = torch.floor(fy), torch.floor(fx)
    wy, wx = fy - y0, fx - x0
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


def _sample_patches(img, pu, pv, ps, stride):
    """The ps x ps patches at the patch grid moved by (pu, pv), from one
    dense grid of absolute coordinates."""
    B, h, w = img.shape
    ny, nx = pu.shape[1], pu.shape[2]
    ys = torch.arange(ny, dtype=torch.float32, device=img.device).to(img.dtype) * stride
    xs = torch.arange(nx, dtype=torch.float32, device=img.device).to(img.dtype) * stride
    py, px = ys[:, None].expand(ny, nx), xs[None, :].expand(ny, nx)
    fy = torch.clamp(py[None] + pv, 0.0, float(h - ps))
    fx = torch.clamp(px[None] + pu, 0.0, float(w - ps))
    d = torch.arange(ps, dtype=torch.float32, device=img.device).to(img.dtype)
    fyd = fy[:, :, None, :, None] + d[None, None, :, None, None]
    fxd = fx[:, :, None, :, None] + d[None, None, None, None, :]
    fyd = fyd.expand(B, ny, ps, nx, ps).reshape(B, ny * ps, nx * ps)
    fxd = fxd.expand(B, ny, ps, nx, ps).reshape(B, ny * ps, nx * ps)
    val = _bilinear_abs(img, fyd, fxd)
    return (val.reshape(B, ny, ps, nx, ps).permute(0, 1, 3, 2, 4)
               .reshape(B, ny, nx, ps * ps))


def _d5(img):
    k = np.array([-1.0, 8.0, 0.0, -8.0, 1.0], np.float32) / 12.0
    one = np.array([1.0], np.float32)
    kc = k[::-1].copy()
    return sepconv(img, one, kc), sepconv(img, kc, one)


def _shift_nb(x, dy, dx):
    xp = F.pad(x, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)))
    h, w = x.shape[-2], x.shape[-1]
    y0, x0 = max(0, dy), max(0, dx)
    return xp[..., y0: y0 + h, x0: x0 + w]


def _iota(h, w, device, dtype):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys.to(dtype), xs.to(dtype)


def _refine(I0, I1, u, v, p: Preset):
    B, h, w = I0.shape
    eps2 = 0.001 ** 2
    ys, xs = _iota(h, w, I0.device, I0.dtype)
    uc = (torch.clamp(xs + u, 0.0, w - 1.0) - xs).contiguous()
    vc = (torch.clamp(ys + v, 0.0, h - 1.0) - ys).contiguous()
    I1x, I1y = _d5(I1)
    W1, W1x, W1y = warp_bilinear(torch.stack((I1, I1x, I1y), dim=1),
                                 uc, vc).unbind(1)
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
    inside = torch.ones((1, h, w), dtype=I0.dtype, device=I0.device)
    inside_nb = [_shift_nb(inside, dy, dx) for dy, dx in nbs]

    for _ in range(p.var_iters):
        r_d = Iz + Ax * du + Ay * dv
        w_d = p.var_delta / torch.sqrt(r_d * r_d + eps2)
        r_gx = Ixz + Axx * du + Axy * dv
        r_gy = Iyz + Axy * du + Ayy * dv
        w_g = p.var_gamma / torch.sqrt(r_gx * r_gx + r_gy * r_gy + eps2)
        a11 = w_d * Ax * Ax + w_g * (Axx * Axx + Axy * Axy)
        a12 = w_d * Ax * Ay + w_g * (Axy * (Axx + Ayy))
        a22 = w_d * Ay * Ay + w_g * (Axy * Axy + Ayy * Ayy)
        b1 = -(w_d * Ax * Iz + w_g * (Axx * Ixz + Axy * Iyz))
        b2 = -(w_d * Ay * Iz + w_g * (Axy * Ixz + Ayy * Iyz))
        fu, fv = u + du, v + dv
        gux, guy = _d5(fu)
        gvx, gvy = _d5(fv)
        sw = p.var_alpha / torch.sqrt(
            gux * gux + guy * guy + gvx * gvx + gvy * gvy + eps2)
        wn = [0.5 * (sw + _shift_nb(sw, dy, dx)) * ins
              for (dy, dx), ins in zip(nbs, inside_nb)]
        wsum = wn[0] + wn[1] + wn[2] + wn[3]
        su = sum(wk * _shift_nb(u, dy, dx) for wk, (dy, dx) in zip(wn, nbs)) - wsum * u
        sv = sum(wk * _shift_nb(v, dy, dx) for wk, (dy, dx) in zip(wn, nbs)) - wsum * v
        b1s, b2s = b1 + su, b2 + sv
        den_u = a11 + wsum + 1e-6
        den_v = a22 + wsum + 1e-6
        for _s in range(p.var_sor_iters):
            for mask in (red, ~red):
                nb_u = sum(wk * _shift_nb(du, dy, dx)
                           for wk, (dy, dx) in zip(wn, nbs))
                gs_u = (b1s - a12 * dv + nb_u) / den_u
                du = torch.where(mask, du + p.var_omega * (gs_u - du), du)
                nb_v = sum(wk * _shift_nb(dv, dy, dx)
                           for wk, (dy, dx) in zip(wn, nbs))
                gs_v = (b2s - a12 * du + nb_v) / den_v
                dv = torch.where(mask, dv + p.var_omega * (gs_v - dv), dv)
    return u + du, v + dv


def _level(I0, I1, u, v, p: Preset):
    B, h, w = I0.shape
    dev, dt = I0.device, I0.dtype
    ps, st = p.patch_size, p.patch_stride
    ny = (h - ps) // st + 1
    nx = (w - ps) // st + 1
    gx, gy = _sobel(I0)
    T = _extract_patches(I0, ny, nx, ps, st)
    Tx = _extract_patches(gx, ny, nx, ps, st)
    Ty = _extract_patches(gy, ny, nx, ps, st)
    if p.use_mean_norm:
        T = T - T.mean(dim=-1, keepdim=True)
    h11 = torch.sum(Tx * Tx, -1) + 1e-3
    h12 = torch.sum(Tx * Ty, -1)
    h22 = torch.sum(Ty * Ty, -1) + 1e-3
    idet = 1.0 / (h11 * h22 - h12 * h12)
    cy = torch.from_numpy(np.arange(ny) * st + ps // 2).to(dev)
    cx = torch.from_numpy(np.arange(nx) * st + ps // 2).to(dev)
    pu = u.index_select(1, cy).index_select(2, cx)
    pv = v.index_select(1, cy).index_select(2, cx)
    max_disp = float(max(h, w))

    def patches(pu, pv):
        P1 = _sample_patches(I1, pu, pv, ps, st)
        if p.use_mean_norm:
            P1 = P1 - P1.mean(dim=-1, keepdim=True)
        return P1

    for _ in range(p.gd_iters):
        r = patches(pu, pv) - T
        g1 = torch.sum(Tx * r, -1)
        g2 = torch.sum(Ty * r, -1)
        du = (h22 * g1 - h12 * g2) * idet
        dv = (h11 * g2 - h12 * g1) * idet
        pu = torch.clamp(pu - du, -max_disp, max_disp)
        pv = torch.clamp(pv - dv, -max_disp, max_disp)

    lam = 1.0 / torch.clamp(torch.mean((patches(pu, pv) - T) ** 2, -1),
                            min=1.0)
    acc = torch.zeros((3, B, h, w), dtype=dt, device=dev)
    vals = torch.stack([lam, lam * pu, lam * pv])
    ylim = (ny - 1) * st + 1
    xlim = (nx - 1) * st + 1
    for dy in range(ps):
        for dx in range(ps):
            acc[:, :, dy: dy + ylim: st, dx: dx + xlim: st] += vals
    acc_w, acc_u, acc_v = acc.unbind(0)
    safe = torch.clamp(acc_w, min=1e-6)
    covered = acc_w > 0
    return (torch.where(covered, acc_u / safe, u),
            torch.where(covered, acc_v / safe, v))


def flow(f0: torch.Tensor, f1: torch.Tensor, preset: str = "fast"):
    """(u, v) [B, H, W] of the frame pairs f0, f1 [B, H, W] (already in
    the dtype to compute in)."""
    p = PRESETS[preset]
    B, H, W = f0.shape
    coarsest = max(p.finest_scale,
                   int(round(math.log2(max(H, W) / (4.0 * p.patch_size)))))
    pyr0, pyr1 = [f0.contiguous()], [f1.contiguous()]
    for _ in range(coarsest):
        pyr0.append(_pyr_down(pyr0[-1]))
        pyr1.append(_pyr_down(pyr1[-1]))
    lh, lw = pyr0[coarsest].shape[1:]
    u = torch.zeros((B, lh, lw), dtype=f0.dtype, device=f0.device)
    v = torch.zeros((B, lh, lw), dtype=f0.dtype, device=f0.device)
    for k in range(coarsest, p.finest_scale - 1, -1):
        if k != coarsest:
            lh, lw = pyr0[k].shape[1:]
            u = resize_bilinear(u, lh, lw) * 2.0
            v = resize_bilinear(v, lh, lw) * 2.0
        u, v = _level(pyr0[k], pyr1[k], u, v, p)
        if p.var_iters > 0:
            u, v = _refine(pyr0[k], pyr1[k], u, v, p)
    scale = float(1 << p.finest_scale)
    return (resize_bilinear(u, H, W) * scale,
            resize_bilinear(v, H, W) * scale)
