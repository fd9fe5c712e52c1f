#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Exits non-zero, with no ``ok`` line, when
CUDA is unavailable, when the port's package is not beside this script, or
when any phase fails. Phases, in order:

1. the card's name and power limit (nvidia-smi);
2. build: the port's CUDA kernels are compiled from ``csrc/`` (nvcc);
3. kernels: each kernel's wrapper against its plain PyTorch twin on the
   card, at B=252, with the stated tolerance (K2, K3 and K5 bitwise): K1-K3
   at every Farnebäck pyramid level of a 256x256 frame, K2 on a random
   (sigma 5 px) and on a smooth displacement field, K4 and K5 at the DIS
   level shapes of the three presets. Per kernel and shape the kernel's
   time, the plain twin's time and, where one PyTorch call computes the
   same function, that call's time (CUDA events around one call, median of
   ``REPS``: the host's cost of issuing the call included), beside the
   bound: the larger of its bytes at 3.35 TB/s and its float32 operations
   at 67 TFLOP/s (the H100 SXM data-sheet peaks). For K2, K3 and K5 also
   the device time of the kernel and of the library call (a CUDA graph of
   ``REPS`` calls), and the host's cost of one wrapper call. The JSON line
   sums each kernel over the shapes its main path runs (all four levels
   for K1-K3, K2 on the random field; the ``fast`` preset's two levels for
   K4 and K5); K2's smooth-field sums are printed on a line of their own;
3b. edge shapes: K3 at odd shapes and every winsize class, K2 and K5 at
   the same shapes on a tiny and a huge field, bitwise against the twins;
4. Farnebäck main path: a synthetic clip of ``FRAMES`` 256x256 frames (a
   smooth texture zoomed about the centre with scale
   1 + 0.06 sin(2 pi t / 30)) through the port's entry point
   ``process_video`` with default Params, twice (a cold and a warm run,
   each timed); checks on each run the funscript, the
   keyframe period and that every dispatched window launched each kernel
   its expected number of times (K1-K3 8 / 12 / 12, K4 and K5 none);
5. Farnebäck kernels vs plain end to end: the first two full windows of the
   clip through the flow program with ``kernels="auto"`` and ``"plain"``;
6. DIS main path: the same clip through ``process_video`` with
   ``backend="DIS"`` (preset fast); the same checks, with launches of
   K4 34 and K5 2 per window and K1-K3 none;
7. DIS kernels vs plain end to end, as in 5;
8. device signal chain: a one-hour signal (108,000 samples at 30 fps)
   through ``compute_actions`` with ``signal_backend="auto"`` on the card,
   checked against the host chain (within 0.5 of its 0-100 curve);
9. with ``--profile DIR`` only: one full window of each flow algorithm
   timed and traced (torch.profiler), device time summed by kernel name,
   traces in DIR;
10. one JSON line listing the kernels, then the contract line.

Imports nothing of JAX; data is made from ``SEED`` on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12    # H100 SXM data sheet, float32 outside tensor cores
B_MAIN = 252               # pairs per full window: pair_batch 240 + 2 x 6 halo
LEVELS = (256, 128, 64, 32)
# launches per dispatched window of each main path; every other kernel 0
EXPECTED_PER_WINDOW = {
    "farneback": {"poly_exp": 8, "warp_bilinear": 12, "box_blur_solve": 12},
    # 17 = 16 descent steps + 1 densification sample, at 2 levels; one
    # refinement warp per level
    "dis": {"sample_abs": 34, "warp_planes": 2},
}
# DIS level shapes on 256x256 frames: source side h -> dense patch grid Ho
K4_SHAPES = {"fast": ((32, 56), (64, 120)),
             "medium": ((32, 72), (64, 152), (128, 328))}
K5_SIZES = {"fast": (32, 64), "medium": (32, 64, 128)}
SIGNAL_SAMPLES = 108_000  # one hour at 30 fps
FRAMES = 1800             # 60 s at 30 fps
SEED = 0
REPS = 10                 # timings per median

KERNEL_META = {
    "poly_exp": {
        "source": "funscript_flow_tpu_torch/csrc/polyexp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/polyexp.py:95",
        "bytes_px": 4 + 5 * 4, "flops_px": 198, "tol": "atol 1e-4",
    },
    "warp_bilinear": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:185",
        "bytes_px": 5 * 4 + 2 * 4 + 5 * 4, "flops_px": 53, "tol": "bitwise",
    },
    "box_blur_solve": {
        "source": "funscript_flow_tpu_torch/csrc/flow_step.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/flow_step.py:71",
        "bytes_px": 5 * 4 + 2 * 4, "flops_px": 158, "tol": "bitwise",
    },
    # per output pixel; the source plane's bytes are added per call
    "sample_abs": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:252",
        "bytes_px": 2 * 4 + 4, "flops_px": 17, "tol": "atol 2e-5",
    },
    "warp_planes": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:226",
        "bytes_px": 2 * 4 + 3 * 4 + 3 * 4, "flops_px": 35, "tol": "bitwise",
    },
}
# Odd shapes (B, H, W) for the edge phase: H and W that are not multiples of
# any kernel's tile, a single pixel, and a width under the blur's halo
EDGE_SHAPES = ((3, 45, 77), (3, 1, 1), (3, 40, 5), (2, 100, 140))
EDGE_WINSIZES = (1, 3, 15, 31)
# uniform displacement amplitudes for K2/K5 at the edge shapes: at +-1 px
# every tile's source box fits the kernel's shared-memory staging buffer;
# at +-60 px it overflows it on all tiles of the 100x140 shape but a corner
# one, which take the direct gather
EDGE_AMPLITUDES = (1.0, 60.0)


class Failure(Exception):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise Failure(msg)


def time_ms(torch, fn) -> float:
    """Median of ``REPS`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def device_ms(torch, fn, n: int = REPS) -> float:
    """Device time of one call of ``fn``: a CUDA graph of ``n`` calls,
    replayed five times, median over the replays divided by ``n``. Unlike
    :func:`time_ms` it holds none of the host's cost of issuing the call,
    which at the small levels is larger than the kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def host_us(torch, fn, n: int = 200) -> float:
    """Host time of issuing one call of ``fn`` (``n`` calls back to back,
    no synchronization inside), in microseconds."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def bound_ms(name: str, n_px: int, extra_bytes: int = 0):
    m = KERNEL_META[name]
    t_bytes = (n_px * m["bytes_px"] + extra_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * m["flops_px"] / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _row(out, name, shape, err, t_k, t_p, t_l, n_px, extra_bytes=0,
         summed=True, dev=None):
    """Print one kernel/shape line; add it to ``out[name]`` if ``summed``.
    ``dev``: (kernel, library) :func:`device_ms`, where measured."""
    b_ms, _ = bound_ms(name, n_px, extra_bytes)
    lib = "null" if t_l is None else f"{t_l:.4f}"
    dev_s = "" if dev is None else (
        f" device_ms={dev[0]:.4f} library_device_ms="
        + ("null" if dev[1] is None else f"{dev[1]:.4f}"))
    print(f"kernel {name} B={B_MAIN} {shape}: max_abs_err={err:.3g} "
          f"(tol {KERNEL_META[name]['tol']}) ms={t_k:.4f} "
          f"plain_ms={t_p:.4f} library_ms={lib} bound_ms={b_ms:.4f}{dev_s}")
    o = out.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                              "bound_ms": 0.0, "library_ms": 0.0, "px": 0,
                              "extra_bytes": 0, "device": None})
    o["max_abs_err"] = max(o["max_abs_err"], err)
    if summed and dev is not None:
        o["device"] = dev if o["device"] is None else tuple(
            None if a is None else a + b for a, b in zip(o["device"], dev))
    if summed:
        o["ms"] += t_k
        o["plain_ms"] += t_p
        o["bound_ms"] += b_ms
        o["library_ms"] = None if t_l is None else o["library_ms"] + t_l
        o["px"] += n_px
        o["extra_bytes"] += extra_bytes


def smooth_field(torch, gen, B: int, S: int, dev):
    """(u, v) [B, S, S] like the flow of ``make_clip``'s clip: a zoom about
    the centre reaching up to +-8 px at the border of a 256 px frame, plus a
    1 px low-frequency wobble, both scaled to the level (S / 256)."""
    c = (S - 1) / 2
    ys = torch.arange(S, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(S, device=dev, dtype=torch.float32)[None, :]
    amp = (torch.rand((B, 1, 1), generator=gen, device=dev) * 2 - 1) * 8
    phase = torch.rand((B, 1, 1), generator=gen, device=dev) * (2 * np.pi)
    k = 2 * np.pi / S
    u = (amp * (xs - c) / c + torch.sin(k * ys + phase)) * (S / 256)
    v = (amp * (ys - c) / c + torch.cos(k * xs + phase)) * (S / 256)
    return u.contiguous(), v.contiguous()


def grid_of(torch, u, v):
    """``F.grid_sample``'s grid (align_corners=True) for the relative
    displacement (u, v) [B, H, W]."""
    H, W = u.shape[1], u.shape[2]
    ys = torch.arange(H, device=u.device, dtype=torch.float32)[:, None]
    xs = torch.arange(W, device=u.device, dtype=torch.float32)[None, :]
    return torch.stack([(xs + u) / (W - 1) * 2 - 1,
                        (ys + v) / (H - 1) * 2 - 1], dim=-1)


def kernel_phase(torch, dev) -> dict:
    """Each kernel against its plain twin at every level size; returns
    per-kernel sums over the four levels."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import flow_step, polyexp, warp

    gen = torch.Generator(device=dev).manual_seed(SEED)
    g, xg, xxg, (ig11, ig03, ig33, ig55) = fb._poly_exp_tables(5, 1.2)
    # one 11x11 filter per output plane, for the conv2d yardstick
    bank = np.stack([np.outer(g, xg) * ig11, np.outer(xg, g) * ig11,
                     np.outer(g, g) * ig03 + np.outer(g, xxg) * ig33,
                     np.outer(g, g) * ig03 + np.outer(xxg, g) * ig33,
                     np.outer(xg, xg) * ig55])
    bank = torch.from_numpy(bank.astype(np.float32))[:, None].to(dev)

    out = {}
    # K2 on the smooth field: ms, plain, library, bound, device, library
    # device
    smooth_sums = [0.0] * 6
    for S in LEVELS:
        B = B_MAIN
        n_px = B * S * S
        # --- K1 poly_exp
        img = torch.rand((B, S, S), generator=gen, device=dev) * 255
        got = polyexp.poly_exp(img, 5, 1.2)
        want = torch.stack(fb.poly_exp(img, 5, 1.2), 1)
        torch.cuda.synchronize()
        err1 = float((got - want).abs().max())
        check(err1 <= 1e-4, f"poly_exp {S}px: max abs err {err1}")
        t_k = time_ms(torch, lambda: polyexp.poly_exp(img, 5, 1.2))
        t_p = time_ms(torch, lambda: fb.poly_exp(img, 5, 1.2))
        t_l = time_ms(torch, lambda: F.conv2d(
            F.pad(img[:, None], (5, 5, 5, 5), mode="replicate"), bank))
        del got, want
        rows = [("poly_exp", err1, t_k, t_p, t_l, None)]

        # --- K2 warp_bilinear on two fields: random displacements (sigma
        # 5 px, every level; the JSON line's sums) and the smooth field of
        # a real window (printed apart, summed on a line of its own)
        R = torch.randn((B, 5, S, S), generator=gen, device=dev)
        random_uv = (torch.randn((B, S, S), generator=gen, device=dev) * 5,
                     torch.randn((B, S, S), generator=gen, device=dev) * 5)
        for field, (u, v) in (("random", random_uv),
                              ("smooth", smooth_field(torch, gen, B, S, dev))):
            got = warp.warp_bilinear(R, u, v)
            want = fb.warp_bilinear(R, u, v)
            torch.cuda.synchronize()
            err2 = float((got - want).abs().max())
            check(torch.equal(got, want),
                  f"warp_bilinear {S}px field={field}: max abs err {err2}")
            grid = grid_of(torch, u, v)

            def k2():
                return warp.warp_bilinear(R, u, v)

            def lib2():
                return F.grid_sample(R, grid, mode="bilinear",
                                     padding_mode="border", align_corners=True)
            t_k = time_ms(torch, k2)
            t_p = time_ms(torch, lambda: fb.warp_bilinear(R, u, v))
            t_l = time_ms(torch, lib2)
            dev2 = (device_ms(torch, k2), device_ms(torch, lib2))
            del got, want
            if field == "random":
                rows.append(("warp_bilinear", err2, t_k, t_p, t_l, dev2))
            else:
                smooth = (err2, t_k, t_p, t_l, dev2)
            if S == LEVELS[-1] and field == "random":
                t_h = (host_us(torch, k2), host_us(torch, lib2),
                       host_us(torch, lambda: flow_step.box_blur_solve(
                           (u,) * 5, 15)))
                print("host cost per call at {0}x{0}: warp_bilinear {1:.1f} "
                      "us, F.grid_sample {2:.1f} us, box_blur_solve {3:.1f} "
                      "us".format(S, *t_h))
            del grid
        del R, random_uv, u, v

        # --- K3 box_blur_solve (random constraint planes, as in the tests)
        M = tuple(torch.randn((B, S, S), generator=gen, device=dev) * 2
                  for _ in range(5))
        gu, gv = flow_step.box_blur_solve(M, 15)
        wu, wv = fb.solve_flow(M, 15)
        torch.cuda.synchronize()
        err3 = max(float((gu - wu).abs().max()), float((gv - wv).abs().max()))
        check(torch.equal(gu, wu) and torch.equal(gv, wv),
              f"box_blur_solve {S}px: max abs err {err3}")
        t_k = time_ms(torch, lambda: flow_step.box_blur_solve(M, 15))
        t_p = time_ms(torch, lambda: fb.solve_flow(M, 15))
        dev3 = (device_ms(torch, lambda: flow_step.box_blur_solve(M, 15)),
                None)
        del gu, gv, wu, wv, M
        rows.append(("box_blur_solve", err3, t_k, t_p, None, dev3))

        for name, err, t_k, t_p, t_l, dev_t in rows:
            field = " field=random" if name == "warp_bilinear" else ""
            _row(out, name, f"{S}x{S}{field}", err, t_k, t_p, t_l, n_px,
                 dev=dev_t)
        err2, t_k, t_p, t_l, dev2 = smooth
        _row(out, "warp_bilinear", f"{S}x{S} field=smooth", err2, t_k, t_p,
             t_l, n_px, summed=False, dev=dev2)
        for i, t in enumerate((t_k, t_p, t_l,
                               bound_ms("warp_bilinear", n_px)[0]) + dev2):
            smooth_sums[i] += t
        torch.cuda.empty_cache()
    print("kernel warp_bilinear field=smooth, summed over the levels: "
          "ms={:.4f} plain_ms={:.4f} library_ms={:.4f} bound_ms={:.4f} "
          "device_ms={:.4f} library_device_ms={:.4f}".format(*smooth_sums))
    out.update(dis_kernel_phase(torch, dev, gen))
    for name, o in out.items():
        o["bound_by"] = bound_ms(name, o["px"], o["extra_bytes"])[1]
        if o["device"] is not None:
            t_d, t_ld = o["device"]
            print(f"kernel {name}, summed as in the JSON line: device_ms="
                  f"{t_d:.4f} library_device_ms="
                  + ("null" if t_ld is None else f"{t_ld:.4f}"))
    return out


def dis_kernel_phase(torch, dev, gen) -> dict:
    """K4 and K5 against their plain twins at the DIS level shapes of the
    three presets on 256x256 frames, B=252. Sums (for the JSON line) cover
    the fast preset's shapes, the ones the DIS main path runs; each preset's
    sums are printed."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.models import dis
    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import warp

    B = B_MAIN
    out = {}
    per_preset = {}
    shapes = sorted({s for v in K4_SHAPES.values() for s in v})
    for h, Ho in shapes:
        img = torch.rand((B, h, h), generator=gen, device=dev) * 255
        fy = torch.rand((B, Ho, Ho), generator=gen, device=dev) * (h - 1)
        fx = torch.rand((B, Ho, Ho), generator=gen, device=dev) * (h - 1)
        got = warp.sample_abs(img, fy, fx)
        want = dis.bilinear_abs(img, fy, fx)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err <= 2e-5, f"sample_abs {h}->{Ho}: max abs err {err}")
        grid = torch.stack([fx / (h - 1) * 2 - 1, fy / (h - 1) * 2 - 1], -1)
        t_k = time_ms(torch, lambda: warp.sample_abs(img, fy, fx))
        t_p = time_ms(torch, lambda: dis.bilinear_abs(img, fy, fx))
        t_l = time_ms(torch, lambda: F.grid_sample(
            img[:, None], grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        n_px, src = B * Ho * Ho, B * h * h * 4
        in_fast = (h, Ho) in K4_SHAPES["fast"]
        _row(out, "sample_abs", f"{h}x{h}->{Ho}x{Ho}", err, t_k, t_p, t_l,
             n_px, src, summed=in_fast)
        for preset, shp in K4_SHAPES.items():
            if (h, Ho) in shp:
                acc = per_preset.setdefault(("sample_abs", preset), [0.0] * 4)
                for i, t in enumerate((t_k, t_p, t_l,
                                       bound_ms("sample_abs", n_px, src)[0])):
                    acc[i] += t
        del img, fy, fx, got, want, grid

    for S in sorted({s for v in K5_SIZES.values() for s in v}):
        planes = [torch.randn((B, S, S), generator=gen, device=dev) * 40
                  for _ in range(3)]
        ys = torch.arange(S, device=dev, dtype=torch.float32)[:, None]
        xs = torch.arange(S, device=dev, dtype=torch.float32)[None, :]
        u = torch.randn((B, S, S), generator=gen, device=dev) * 2
        v = torch.randn((B, S, S), generator=gen, device=dev) * 2
        # pre-clamped as in dis.variational_refinement
        u = (torch.clamp(xs + u, 0.0, S - 1.0) - xs).contiguous()
        v = (torch.clamp(ys + v, 0.0, S - 1.0) - ys).contiguous()
        got = warp.warp_planes(planes, u, v)
        want = fb.warp_bilinear(torch.stack(planes, 1), u, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want), f"warp_planes {S}px: max abs err {err}")
        stacked = torch.stack(planes, 1)
        grid = grid_of(torch, u, v)

        def k5():
            return warp.warp_planes(planes, u, v)

        def lib5():
            return F.grid_sample(stacked, grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)
        t_k = time_ms(torch, k5)
        t_p = time_ms(torch, lambda: fb.warp_bilinear(
            torch.stack(planes, 1), u, v))
        t_l = time_ms(torch, lib5)
        n_px = B * S * S
        _row(out, "warp_planes", f"{S}x{S}", err, t_k, t_p, t_l, n_px,
             summed=S in K5_SIZES["fast"],
             dev=(device_ms(torch, k5), device_ms(torch, lib5)))
        for preset, sizes in K5_SIZES.items():
            if S in sizes:
                acc = per_preset.setdefault(("warp_planes", preset), [0.0] * 4)
                for i, t in enumerate((t_k, t_p, t_l,
                                       bound_ms("warp_planes", n_px)[0])):
                    acc[i] += t
        del planes, u, v, got, want, stacked, grid
        torch.cuda.empty_cache()
    for (name, preset), (t_k, t_p, t_l, b) in sorted(per_preset.items()):
        print(f"kernel {name} preset {preset}, summed over its levels: "
              f"ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={t_l:.4f} "
              f"bound_ms={b:.4f}")
    return out


def edge_phase(torch, dev) -> None:
    """K3 at every ``EDGE_SHAPES`` shape and ``EDGE_WINSIZES`` window, and
    K2 (P=5) and K5 (P=3) at every shape and ``EDGE_AMPLITUDES`` field, each
    held bitwise against its plain twin."""
    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import flow_step, warp

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n = 0
    for B, H, W in EDGE_SHAPES:
        M = tuple(torch.randn((B, H, W), generator=gen, device=dev) * 2
                  for _ in range(5))
        for win in EDGE_WINSIZES:
            got = flow_step.box_blur_solve(M, win)
            want = fb.solve_flow(M, win)
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"box_blur_solve B={B} {H}x{W} winsize {win}: max abs "
                  f"err {err}")
            n += 1
        for P, name in ((5, "warp_bilinear"), (3, "warp_planes")):
            R = torch.randn((B, P, H, W), generator=gen, device=dev)
            for amp in EDGE_AMPLITUDES:
                u, v = ((torch.rand((B, H, W), generator=gen, device=dev)
                         * 2 - 1) * amp for _ in range(2))
                got = (warp.warp_bilinear(R, u, v) if P == 5
                       else warp.warp_planes(R.unbind(1), u, v))
                want = fb.warp_bilinear(R, u, v)
                err = float((got - want).abs().max())
                check(torch.equal(got, want),
                      f"{name} B={B} {H}x{W} +-{amp} px: max abs err {err}")
                n += 1
    print(f"edge shapes: {n} cases of box_blur_solve (winsize "
          f"{EDGE_WINSIZES}), warp_bilinear and warp_planes (+-"
          f"{EDGE_AMPLITUDES} px) at B,H,W {EDGE_SHAPES}: all bitwise equal "
          f"to their twins")


def make_clip(torch, dev, n: int = FRAMES, seed: int = SEED) -> list:
    """``n`` uint8 256x256 frames: a blurred-noise texture zoomed about the
    centre with scale 1 + 0.06 sin(2 pi t / 30) (period 1 s at 30 fps)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(rng.random((1, 1, 512, 512), dtype=np.float32)).to(dev)
    r = torch.arange(-9, 10, dtype=torch.float32, device=dev)
    k = torch.exp(-(r * r) / (2 * 3.0 ** 2))
    k = k / k.sum()
    tex = F.conv2d(F.pad(tex, (9, 9, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    tex = F.conv2d(F.pad(tex, (0, 0, 9, 9), mode="reflect"), k.view(1, 1, -1, 1))
    tex = ((tex - tex.mean()) / tex.std() * 40 + 128).clamp(0, 255)
    p = torch.arange(256, dtype=torch.float32, device=dev) - 127.5
    frames = []
    for s0 in range(0, n, 100):
        t = torch.arange(s0, min(n, s0 + 100), dtype=torch.float32, device=dev)
        s = 1 + 0.06 * torch.sin(2 * np.pi * t / 30)
        X = 255.5 + p[None, None, :] / s[:, None, None]      # texture coords
        Y = 255.5 + p[None, :, None] / s[:, None, None]
        grid = torch.stack([(X / 511 * 2 - 1).expand(-1, 256, 256),
                            (Y / 511 * 2 - 1).expand(-1, 256, 256)], dim=-1)
        img = F.grid_sample(tex.expand(len(t), -1, -1, -1), grid,
                            mode="bilinear", align_corners=True)
        frames.extend(img[:, 0].round().clamp(0, 255).to(torch.uint8).cpu().numpy())
    return frames


class ListSource:
    """A decoded-frame source over an in-memory list (``get_batch``/``close``,
    the interface ``process_video(preopened=...)`` reads)."""

    def __init__(self, frames):
        self._frames = frames
        self._i = 0

    def get_batch(self, n):
        out = self._frames[self._i : self._i + n]
        self._i += len(out)
        return out

    def close(self):
        self._i = len(self._frames)


def main_path(torch, dev, frames, params=None, fps: float = 30.0) -> dict:
    """The clip through ``process_video`` (default Params unless given);
    returns the funscript, the log and the launch counts of the run."""
    from funscript_flow_tpu_torch.io.decode import VideoMeta
    from funscript_flow_tpu_torch.io.funscript import load_funscript
    from funscript_flow_tpu_torch.ops import cuda as kcuda
    from funscript_flow_tpu_torch.runner import process_video
    from funscript_flow_tpu_torch.utils.params import Params

    meta = VideoMeta(total_frames=len(frames), fps=fps, width=256, height=256)
    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "smoke_clip.mp4")
        logs = []
        kcuda.reset_launches()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = process_video(video, params or Params(overwrite=True),
                            logs.append,
                            preopened=(meta, ListSource(frames)),
                            device=str(dev))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kcuda.launch_counts()
        check(not err, "process_video reported an error:\n" + "\n".join(logs))
        fs = load_funscript(os.path.join(tmp, "smoke_clip.funscript"))
    m = next((re.search(r"Flow windows dispatched: (\d+) \((\d+) pairs\)", ln)
              for ln in logs if "Flow windows dispatched" in ln), None)
    check(m is not None, "no window count in the log:\n" + "\n".join(logs))
    return {"funscript": fs, "logs": logs, "wall": wall, "counts": counts,
            "windows": int(m.group(1)), "pairs": int(m.group(2))}


def check_funscript(fs: dict) -> float:
    """Contract checks; returns the median keyframe gap in ms."""
    check(fs.get("version") == "1.0", f"funscript version {fs.get('version')}")
    acts = fs["actions"]
    check(len(acts) >= 3, f"only {len(acts)} actions")
    ats = [a["at"] for a in acts]
    check(all(b > a for a, b in zip(ats, ats[1:])), "'at' not increasing")
    check(all(0 <= a["pos"] <= 100 for a in acts), "'pos' outside 0-100")
    return float(np.median(np.diff(ats)))


# median keyframe gap of the default clip (1800 frames, seed 0): the
# motion period is 1 s, so extrema are 500 ms apart. A CPU run of the same
# clip through the same entry point — main_path(torch, cpu,
# make_clip(torch, cpu, 1800, 0), Params(overwrite=True, pair_batch=64)),
# results being batch-size invariant — gave 123 actions, gaps of 14 and
# 16 frames (467 / 533 ms) and a median of 467 ms: the tolerance covers
# that one-frame quantization and a frame more.
GAP_MS = 500.0
GAP_TOL_MS = 70.0
# The same for the DIS main path: main_path(torch, cpu, make_clip(torch,
# cpu, 1800, 0), Params(overwrite=True, backend="DIS", pair_batch=64))
# gave 123 actions, 117 of the gaps 467 or 533 ms, median 467 ms.
DIS_GAP_MS = 500.0
DIS_GAP_TOL_MS = 70.0


def check_launches(counts: dict, windows: int, algorithm: str) -> None:
    """Each kernel of ``algorithm``'s path launched its count per window,
    every other kernel not at all."""
    per = EXPECTED_PER_WINDOW[algorithm]
    for name in KERNEL_META:
        want = per.get(name, 0) * windows
        check(counts[name] == want,
              f"{algorithm}: {name} launched {counts[name]} times, "
              f"expected {want}")


def run_main_path(torch, dev, frames, algorithm: str) -> dict:
    """The main path through ``process_video`` twice, with its checks on
    each run: the first run (cold: it pays the first windows' allocations,
    pinned buffers included) and a second, warm one. Returns the warm run."""
    from funscript_flow_tpu_torch.utils.params import Params

    backend = "DIS" if algorithm == "dis" else "CUDA"
    want, tol = ((DIS_GAP_MS, DIS_GAP_TOL_MS) if algorithm == "dis"
                 else (GAP_MS, GAP_TOL_MS))
    for run in ("cold", "warm"):
        mp = main_path(torch, dev, frames,
                       Params(overwrite=True, backend=backend))
        gap = check_funscript(mp["funscript"])
        print(f"main path {algorithm} ({run} run): {mp['pairs']} pairs in "
              f"{mp['windows']} windows, wall {mp['wall']:.3f} s, "
              f"{mp['pairs'] / mp['wall']:.1f} pairs/s, "
              f"{len(mp['funscript']['actions'])} actions, median keyframe "
              f"gap {gap:.1f} ms; launches {mp['counts']}")
        check_launches(mp["counts"], mp["windows"], algorithm)
        check(abs(gap - want) <= tol, f"{algorithm}: median keyframe gap "
                                      f"{gap} ms, expected {want} +- {tol}")
    return mp


def kernels_vs_plain(torch, dev, frames, algorithm: str) -> dict:
    """First two full windows through the flow program, kernels vs plain;
    returns the max abs difference per output (bars of tests/test_flow.py:
    centers 1.0, dots 5e-3, mean_mag 1e-3)."""
    from funscript_flow_tpu_torch.models.pipeline import (FlowAnalyzer,
                                                          PipelineConfig)

    clip = np.stack(frames[: 2 * 240 + 1])
    res = {k: FlowAnalyzer(PipelineConfig(flow_algorithm=algorithm,
                                          kernels=k), device=dev)
           .analyze_video_pairs(clip) for k in ("auto", "plain")}
    a, p = res["auto"], res["plain"]
    diff = {k: float(np.abs(a[k].astype(np.float64) - p[k]).max())
            for k in ("dots", "centers", "mean_mag")}
    check(bool((a["cuts"] == p["cuts"]).all()), f"{algorithm}: cuts differ")
    for k, tol in (("centers", 1.0), ("dots", 5e-3), ("mean_mag", 1e-3)):
        check(diff[k] <= tol,
              f"{algorithm}: {k}: kernels vs plain {diff[k]} > {tol}")
    return diff


def signal_chain_phase(torch, dev) -> None:
    """A one-hour signal through ``compute_actions`` with
    ``signal_backend="auto"`` on the card: it must route to the device
    chain and stay within 0.5 of the host chain's 0-100 curve
    (tests/test_signal_jax.py:109). Prints both chains' times."""
    from funscript_flow_tpu_torch.runner import compute_actions
    from funscript_flow_tpu_torch.utils.params import Params

    rng = np.random.default_rng(SEED)
    n = SIGNAL_SAMPLES
    t = np.arange(n)
    dots = (np.sin(2 * np.pi * t / 45.0) * 3 + rng.normal(0, 0.2, n)
            ).astype(np.float32)
    cuts = np.zeros(n, bool)
    cuts[[9_000, 40_000, 77_000]] = True  # scene cuts: the curve restarts
    ts = np.arange(n)
    times = {}
    for backend in ("auto", "auto", "host"):  # the first auto run warms up
        logs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acts, norm = compute_actions(dots, cuts, ts, 30.0, 30.0,
                                     Params(signal_backend=backend),
                                     logs.append, device=dev)
        times[backend] = time.perf_counter() - t0
        if backend == "auto":
            check(any("Signal chain: device" in m for m in logs),
                  f"the one-hour signal did not take the device chain: {logs}")
            dev_acts, dev_norm = acts, norm
    err = float(np.abs(dev_norm - norm).max())
    print(f"signal chain, {n} samples: device {times['auto']:.4f} s "
          f"({len(dev_acts)} actions), host {times['host']:.4f} s "
          f"({len(acts)} actions); max |norm - host norm| {err:.3g}")
    check(err <= 0.5, f"device signal chain off the host chain by {err}")
    check(len(dev_acts) > 1000 and all(0 <= a["pos"] <= 100 for a in dev_acts),
          "device signal chain: implausible actions")


HAND_KERNELS = ("poly_exp_kernel", "warp_bilinear_kernel",
                "box_blur_solve_kernel", "sample_abs_kernel")


def profile_window(torch, dev, frames, out_dir: str, algorithm: str) -> None:
    """Where one full window's time goes: the flow program on 253 frames
    (252 pairs), timed with CUDA events for kernels="auto" and "plain",
    then one traced run whose device time is summed by kernel name.
    Writes the chrome trace to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from funscript_flow_tpu_torch.models.pipeline import (PipelineConfig,
                                                          flow_chunk_program)

    win = torch.from_numpy(np.stack(frames[: B_MAIN + 1])).to(dev)
    for k in ("auto", "plain"):
        cfg = PipelineConfig(flow_algorithm=algorithm, kernels=k)
        ms = time_ms(torch, lambda: flow_chunk_program(win, B_MAIN, cfg))
        print(f"profile {algorithm}: flow program, one {B_MAIN}-pair window, "
              f"kernels={k}: {ms:.3f} ms ({B_MAIN / ms * 1e3:.1f} pairs/s)")
    from torch.autograd import DeviceType

    cfg = PipelineConfig(flow_algorithm=algorithm)
    for cycle in range(2):  # the first cycle pays the tracer's start-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flow_chunk_program(win, B_MAIN, cfg)["dots"].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir,
                                          f"window_trace_{algorithm}.json"))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a host op's row repeats its kernels' time
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile {algorithm}: traced window wall {wall_ms:.3f} ms, device "
          f"time {total / 1e3:.3f} ms ({total / 1e3 / wall_ms:.1%} busy), "
          f"{sum(r[2] for r in rows)} device events")
    for name in HAND_KERNELS:
        hit = [r for r in rows if name in r[1]]
        if hit:
            print(f"profile {algorithm}: {name} "
                  f"{sum(r[0] for r in hit) / 1e3:.3f} ms in "
                  f"{sum(r[2] for r in hit)} launches")
    mine = sum(r[0] for r in rows if any(o in r[1] for o in HAND_KERNELS))
    print(f"profile {algorithm}: hand kernels {mine / 1e3:.3f} ms "
          f"({mine / max(total, 1e-9):.1%} of device time)")
    for us, key, count in rows[:15]:
        print(f"profile {algorithm}: {us / 1e3:9.3f} ms {count:5d}x "
              f"{key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="also profile one full window of each flow "
                         "algorithm; traces written here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from funscript_flow_tpu_torch.ops.cuda import _build
    except ImportError as e:
        print(f"FAIL: the port's package is not importable: {e}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
        check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
        print(card)

        _build.load()
        info = _build.build_info
        print(f"build: {info['seconds']:.2f} s (rebuilt={info['rebuilt']})")
        for ln in info["log"].splitlines():
            entry = re.search(r"Compiling entry function '\w*?\d([a-z_]+"
                              r"_kernel)(?:I\w*?Li(\d+)E)?", ln)
            if entry:
                print("ptxas: {}{}".format(entry.group(1), "" if entry.group(2)
                                           is None else f"<{entry.group(2)}>"))
            elif "registers" in ln or "spill" in ln:
                print("ptxas:", ln.strip())

        kern = kernel_phase(torch, dev)
        edge_phase(torch, dev)

        frames = make_clip(torch, dev)
        paths = {}
        for algorithm in ("farneback", "dis"):
            paths[algorithm] = run_main_path(torch, dev, frames, algorithm)
            diff = kernels_vs_plain(torch, dev, frames, algorithm)
            print(f"kernels vs plain {algorithm}, first two windows: "
                  f"max abs diff {diff}")
        signal_chain_phase(torch, dev)
        if args.profile:
            for algorithm in ("farneback", "dis"):
                profile_window(torch, dev, frames, args.profile, algorithm)
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": KERNEL_META[name]["source"],
         "replaces": KERNEL_META[name]["replaces"],
         "launches": paths["dis" if name in EXPECTED_PER_WINDOW["dis"]
                             else "farneback"]["counts"][name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in kern.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
