#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Exits non-zero, with no ``ok`` line, when
CUDA is unavailable, when the port's package is not beside this script, or
when any phase fails. Phases, in order:

1. the card's name and power limit (nvidia-smi), then the decode probe
   (``decode_probe``, one JSON line; installs nothing): ffmpeg/ffprobe on
   PATH, libav's shared objects and headers, NVDEC's ``libnvcuvid.so``,
   ``cv2``, ``torchvision.io`` and ``torchaudio.io``, and whether the
   port's native pump builds (it is built here, with ``g++``), with which
   engines and encoders. A pump that fails to build where libav's headers
   are fails the run;
2. build: the port's CUDA kernels are compiled from ``csrc/`` (nvcc);
3. kernels: each kernel's wrapper against its plain PyTorch twin on the
   card, at B=252, bitwise (``torch.equal``): K1 (``poly_n`` 5 and 7),
   K2 and K3 at every Farnebäck pyramid level of a 256x256 frame, K2 on a
   random (sigma 5 px) and on a smooth displacement field, K4 in both
   forms (the dense ``sample_abs`` on random coordinates, the patch
   sampler ``sample_patches`` on the patch grids of the DIS presets, with
   offsets of a few px and some far out of range) and K5 at the DIS level
   shapes of the three presets. Per kernel and shape: the kernel's time,
   the plain twin's time and, where one PyTorch call computes the same
   function, that call's time (CUDA events around one call, median of
   ``REPS``: the host's cost of issuing the call included); the device
   time of the kernel and of the library call (a CUDA graph of ``REPS``
   calls); beside the bound: the larger of its bytes at 3.35 TB/s and its
   float32 operations at 33.5e12 per second (see ``F32_OPS_PER_S``). The
   host's cost of one call of every wrapper (and of ``F.grid_sample``) at
   32 px is printed on one line. The JSON line sums each kernel over the
   shapes its main path runs (all four levels for K1-K3, K2 on the random
   field; the ``fast`` preset's two levels for K4 and K5); K2's
   smooth-field sums are printed on a line of their own;
3b. edge shapes: K3 at odd shapes and every winsize class, K2 and K5 at
   the same shapes on a tiny and a huge field, K1 at the same shapes for
   every ``poly_n`` 1-8, and both forms of K4 at odd source sizes (and
   one too large to stage) for the patch strides of all three DIS presets
   and one other patch size, bitwise against the twins;
4. Farnebäck main path: a synthetic clip of ``FRAMES`` 256x256 frames (a
   smooth texture zoomed about the centre with scale
   1 + 0.06 sin(2 pi t / 30)) through the port's entry point
   ``process_video`` with default Params, twice (a cold and a warm run,
   each timed); checks on each run the funscript, the
   keyframe period and that every dispatched window launched each kernel
   its expected number of times (``EXPECTED_PER_WINDOW``);
5. Farnebäck kernels vs plain end to end: the first two full windows of the
   clip through the flow program with ``kernels="auto"`` and ``"plain"``;
6. DIS main path: the same clip through ``process_video`` with
   ``backend="DIS"`` (preset fast); the same checks;
7. DIS kernels vs plain end to end, as in 5;
8. device signal chain: a one-hour signal (108,000 samples at 30 fps)
   through ``compute_actions`` with ``signal_backend="auto"`` on the card,
   checked against the host chain (within 0.5 of its 0-100 curve);
8b. file, where the pump builds (else one line naming what the machine
   lacks, and no file is decoded another way): a ``FILE_SIZE`` clip of
   ``FRAMES`` frames of the zoom texture at 30 fps, encoded by the port's
   encoder (h264 where libx264 opens, else mpeg4), through
   ``process_video(use_native_decode="on")``, cold and warm: the pump's
   fast engine decodes it, 8/12/12 launches per window, the funscript
   within 2 ``pos`` (same ``at``) of the same pump frames through
   ``preopened``; pairs/s with decode included, the stage timers and the
   decode rate alone. Then the BatchWorker phase (9b) on three encoded
   256x256 files of ``FOLDER_CLIPS``' lengths;
9. folder: three clips (``FOLDER_CLIPS``: 900, 1200 and 1800 frames)
   through the runner's folder workers (``_run_videos_parallel``) on
   ``cuda:0``, with 1 and with 3 workers, for Farnebäck and for DIS
   (fast): each clip's funscript byte-identical across the runs, each
   kernel launched its expected count per window summed over the clips;
   the folder's pairs/s per run. The card has no OpenCV, so the clips are
   placeholder files that a replaced ``runner._open_video`` serves from
   memory, from any ``start_sample``;
9b. BatchWorker (here, on the same placeholder clips, where the pump does
   not build): the three clips through ``worker.BatchWorker`` on the card,
   Farnebäck and then DIS: all three generated, the run's log file
   written, progress at 100, each funscript byte-identical to a direct
   ``process_video`` of the clip, launches per window as in 4 and 6;
10. checkpoint: the 1800-frame clip with ``checkpoint=True`` and a
   sidecar every ``CKPT_EVERY_PAIRS`` pairs, cancelled after the runner's
   third poll, then resumed: the resume is logged, the funscript is the
   uninterrupted run's bytes and the sidecar is gone;
11. profile: a ``PROFILE_FRAMES``-frame clip with ``profile_dir``: one
   chrome trace, naming ``poly_exp_kernel``; ``utils.devprof.
   device_profile`` of one full Farnebäck window beside the device time
   of one traced window summed as phase 12 sums it;
12. mesh and SP: the 1800-frame clip through ``StreamingFlowAnalyzer``
   with a mesh of two devices (``cuda:0`` and ``cuda:1`` when the machine
   has two cards, else ``cuda:0`` twice), bitwise equal to no mesh; the
   one-hour signal through ``signal_chain_sharded`` over ``cuda:0`` four
   times (and through ``compute_actions`` with that mesh), within 1e-3 of
   the two-device run and 0.5 of the host chain;
13. with ``--profile DIR`` only: one full window of each flow algorithm
   timed and traced (torch.profiler), device time summed by kernel name,
   traces in DIR; the folder of each flow algorithm with 1 and with 3
   workers once more, traced: the card's busy share of each; and the host's
   launch rate of small eager ops from 1 and from 3 threads;
14. one JSON line listing the kernels, then the contract line.

Every line of phases 8b-12 ends with the card's name and power limit.

Imports nothing of JAX; data is made from ``SEED`` on the card (the file
phases encode it into files first).
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
# The data sheet's 67 TFLOP/s float32 counts a fused multiply-add as two
# operations. The kernels are built with --fmad=false, as their twins'
# roundings require, so every multiply and every add is an instruction of
# its own: 33.5e12 of them per second.
F32_OPS_PER_S = 33.5e12
B_MAIN = 252               # pairs per full window: pair_batch 240 + 2 x 6 halo
LEVELS = (256, 128, 64, 32)
POLY = ((5, 1.2), (7, 1.5))  # (poly_n, poly_sigma) checked; the first is timed
# launches per dispatched window of each main path; every other kernel 0
EXPECTED_PER_WINDOW = {
    "farneback": {"poly_exp": 8, "warp_bilinear": 12, "box_blur_solve": 12},
    # 17 = 16 descent steps + 1 densification sample, at 2 levels; one
    # refinement warp per level
    "dis": {"sample_abs": 0, "sample_patches": 34, "warp_planes": 2},
}
# DIS level shapes on 256x256 frames: source side h -> dense patch grid Ho
K4_SHAPES = {"fast": ((32, 56), (64, 120)),
             "medium": ((32, 72), (64, 152), (128, 328))}
# the same levels as patch grids: (source side h, patch stride), patch 8
PATCH = 8
K4P_GRIDS = {"fast": ((32, 4), (64, 4)),
             "medium": ((32, 3), (64, 3), (128, 3))}
K5_SIZES = {"fast": (32, 64), "medium": (32, 64, 128)}
SIGNAL_SAMPLES = 108_000  # one hour at 30 fps
FRAMES = 1800             # 60 s at 30 fps
SEED = 0
REPS = 10                 # timings per median
# the folder phase's clips: (frames, seed); the last is the main clip
FOLDER_CLIPS = ((900, SEED + 1), (1200, SEED + 2), (FRAMES, SEED))
FOLDER_WORKERS = (1, 3)
CKPT_EVERY_PAIRS = 240
PROFILE_FRAMES = 300
SP_SHARDS = 4
FILE_SIZE = (720, 1280)   # (h, w) of the file phase's clip

KERNEL_META = {
    "poly_exp": {
        "source": "funscript_flow_tpu_torch/csrc/polyexp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/polyexp.py:95",
        "bytes_px": 4 + 5 * 4, "flops_px": 198,
    },
    "warp_bilinear": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:185",
        "bytes_px": 5 * 4 + 2 * 4 + 5 * 4, "flops_px": 53,
    },
    "box_blur_solve": {
        "source": "funscript_flow_tpu_torch/csrc/flow_step.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/flow_step.py:71",
        "bytes_px": 5 * 4 + 2 * 4, "flops_px": 158,
    },
    # per output pixel; the source plane's bytes are added per call
    "sample_abs": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:252",
        "bytes_px": 2 * 4 + 4, "flops_px": 17,
    },
    # per output pixel; 8 B of offsets per patch and the source plane are
    # added per call
    "sample_patches": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:252",
        "bytes_px": 4, "flops_px": 17,
    },
    "warp_planes": {
        "source": "funscript_flow_tpu_torch/csrc/warp.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/warp.py:226",
        "bytes_px": 2 * 4 + 3 * 4 + 3 * 4, "flops_px": 35,
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
# K4's edge sources (h, w): odd, and too large for the staging buffer
EDGE_K4 = ((40, 48), (45, 77), (200, 232))
# (patch size, stride): ultrafast and fast (8, 4), medium (8, 3), and a
# patch size that takes the kernel's run-time-size instance
EDGE_PATCHES = ((8, 4), (8, 3), (5, 2))


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
    t_ops = n_px * m["flops_px"] / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def _row(out, name, shape, err, t_k, t_p, t_l, dev, n_px, extra_bytes=0,
         summed=True):
    """Print one kernel/shape line; add it to ``out[name]`` if ``summed``.
    ``dev``: (kernel, library) :func:`device_ms`, the library's None where
    there is no library call."""
    b_ms, _ = bound_ms(name, n_px, extra_bytes)
    lib = "null" if t_l is None else f"{t_l:.4f}"
    lib_dev = "null" if dev[1] is None else f"{dev[1]:.4f}"
    print(f"kernel {name} B={B_MAIN} {shape}: max_abs_err={err:.3g} "
          f"(tol bitwise) ms={t_k:.4f} plain_ms={t_p:.4f} library_ms={lib} "
          f"bound_ms={b_ms:.4f} device_ms={dev[0]:.4f} "
          f"library_device_ms={lib_dev}")
    o = out.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                              "bound_ms": 0.0, "library_ms": 0.0, "px": 0,
                              "extra_bytes": 0, "device": None})
    o["max_abs_err"] = max(o["max_abs_err"], err)
    if summed:
        o["device"] = dev if o["device"] is None else tuple(
            None if a is None else a + b for a, b in zip(o["device"], dev))
        o["ms"] += t_k
        o["plain_ms"] += t_p
        o["bound_ms"] += b_ms
        o["library_ms"] = None if t_l is None else o["library_ms"] + t_l
        o["px"] += n_px
        o["extra_bytes"] += extra_bytes


def _add_preset(per_preset, name, presets, t_k, t_p, t_l, b, dev):
    """Add one shape's times to the sums of each preset that runs it."""
    for preset in presets:
        acc = per_preset.setdefault((name, preset), [0.0] * 6)
        for i, t in enumerate((t_k, t_p, t_l, b) + tuple(dev)):
            acc[i] += t


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


def patch_offsets(torch, gen, B: int, ny: int, nx: int, h: int, w: int, dev):
    """Patch offsets (pu, pv) [B, ny, nx] like a real window's (sigma 2 px),
    one in 16 replaced by one up to twice the source size away, so that
    both corner clamps are hit."""
    near = torch.randn((2, B, ny, nx), generator=gen, device=dev) * 2
    far = torch.rand((2, B, ny, nx), generator=gen, device=dev) * 2 - 1
    far = far * torch.tensor([2.0 * w, 2.0 * h], device=dev)[:, None, None,
                                                              None]
    pick = torch.rand((2, B, ny, nx), generator=gen, device=dev) < 1 / 16
    pu, pv = torch.where(pick, far, near)
    return pu.contiguous(), pv.contiguous()


def patch_grid(torch, dis, h, w, pu, pv, ps, stride):
    """``F.grid_sample``'s grid (align_corners=True) of the dense
    [B, ny*ps, nx*ps] coordinates that the patch sampler's twin forms."""
    grid = []

    def keep(img, fy, fx):
        grid.append(torch.stack([fx / (w - 1) * 2 - 1,
                                 fy / (h - 1) * 2 - 1], dim=-1))
        return fy

    ny, nx = pu.shape[1:]
    py, px = dis._patch_origins(ny, nx, stride, pu.device)
    dis._sample_patches_dense(torch.empty((pu.shape[0], h, w),
                                          device=pu.device),
                              py, px, pv, pu, ps, keep)
    return grid[0]


# ---------------------------------------------------------- kernel phase
#
# One section per wrapper entry point: section(torch, dev, gen, out, host,
# per_preset) checks the kernel against its twin at each shape, prints a
# row per shape (summed into ``out`` for the JSON line where the main path
# runs that shape) and records the wrapper's host cost at 32 px in
# ``host``.

def k1_section(torch, dev, gen, out, host, per_preset) -> None:
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import polyexp

    n0, s0 = POLY[0]
    g, xg, xxg, (ig11, ig03, ig33, ig55) = fb._poly_exp_tables(n0, s0)
    # one filter per output plane, for the conv2d yardstick
    bank = np.stack([np.outer(g, xg) * ig11, np.outer(xg, g) * ig11,
                     np.outer(g, g) * ig03 + np.outer(g, xxg) * ig33,
                     np.outer(g, g) * ig03 + np.outer(xxg, g) * ig33,
                     np.outer(xg, xg) * ig55])
    bank = torch.from_numpy(bank.astype(np.float32))[:, None].to(dev)
    for S in LEVELS:
        img = torch.rand((B_MAIN, S, S), generator=gen, device=dev) * 255
        err = 0.0
        for n, sigma in POLY:
            got = polyexp.poly_exp(img, n, sigma)
            want = torch.stack(fb.poly_exp(img, n, sigma), 1)
            torch.cuda.synchronize()
            err = max(err, max_err(got, want))
            check(torch.equal(got, want),
                  f"poly_exp {S}px poly_n {n}: max abs err {max_err(got, want)}")
            del got, want

        def k1():
            return polyexp.poly_exp(img, n0, s0)

        def lib1():
            return F.conv2d(F.pad(img[:, None], (n0,) * 4, mode="replicate"),
                            bank)
        t = (time_ms(torch, k1), time_ms(torch, lambda: fb.poly_exp(
            img, n0, s0)), time_ms(torch, lib1))
        _row(out, "poly_exp", f"{S}x{S} poly_n={n0}", err, *t,
             (device_ms(torch, k1), device_ms(torch, lib1)), B_MAIN * S * S)
        if S == 32:
            host["poly_exp"] = host_us(torch, k1)
        del img
        torch.cuda.empty_cache()


def k2_section(torch, dev, gen, out, host, per_preset) -> None:
    """K2 on two fields: random displacements (sigma 5 px, every level; the
    JSON line's sums) and the smooth field of a real window (printed apart,
    summed on a line of its own)."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import warp

    smooth_sums = [0.0] * 6
    for S in LEVELS:
        B = B_MAIN
        R = torch.randn((B, 5, S, S), generator=gen, device=dev)
        random_uv = (torch.randn((B, S, S), generator=gen, device=dev) * 5,
                     torch.randn((B, S, S), generator=gen, device=dev) * 5)
        for field, (u, v) in (("random", random_uv),
                              ("smooth", smooth_field(torch, gen, B, S, dev))):
            got = warp.warp_bilinear(R, u, v)
            want = fb.warp_bilinear(R, u, v)
            torch.cuda.synchronize()
            err = max_err(got, want)
            check(torch.equal(got, want),
                  f"warp_bilinear {S}px field={field}: max abs err {err}")
            del got, want
            grid = grid_of(torch, u, v)

            def k2():
                return warp.warp_bilinear(R, u, v)

            def lib2():
                return F.grid_sample(R, grid, mode="bilinear",
                                     padding_mode="border", align_corners=True)
            t = (time_ms(torch, k2),
                 time_ms(torch, lambda: fb.warp_bilinear(R, u, v)),
                 time_ms(torch, lib2))
            dev2 = (device_ms(torch, k2), device_ms(torch, lib2))
            _row(out, "warp_bilinear", f"{S}x{S} field={field}", err, *t,
                 dev2, B * S * S, summed=field == "random")
            if field == "smooth":
                for i, x in enumerate(t + (bound_ms("warp_bilinear",
                                                    B * S * S)[0],) + dev2):
                    smooth_sums[i] += x
            if S == 32 and field == "random":
                host["warp_bilinear"] = host_us(torch, k2)
                host["F.grid_sample"] = host_us(torch, lib2)
            del grid
        del R, random_uv, u, v
        torch.cuda.empty_cache()
    print("kernel warp_bilinear field=smooth, summed over the levels: "
          "ms={:.4f} plain_ms={:.4f} library_ms={:.4f} bound_ms={:.4f} "
          "device_ms={:.4f} library_device_ms={:.4f}".format(*smooth_sums))


def k3_section(torch, dev, gen, out, host, per_preset) -> None:
    """K3 on random constraint planes, as in the tests."""
    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import flow_step

    for S in LEVELS:
        M = tuple(torch.randn((B_MAIN, S, S), generator=gen, device=dev) * 2
                  for _ in range(5))
        gu, gv = flow_step.box_blur_solve(M, 15)
        wu, wv = fb.solve_flow(M, 15)
        torch.cuda.synchronize()
        err = max(max_err(gu, wu), max_err(gv, wv))
        check(torch.equal(gu, wu) and torch.equal(gv, wv),
              f"box_blur_solve {S}px: max abs err {err}")
        del gu, gv, wu, wv

        def k3():
            return flow_step.box_blur_solve(M, 15)
        t = (time_ms(torch, k3), time_ms(torch, lambda: fb.solve_flow(M, 15)),
             None)
        _row(out, "box_blur_solve", f"{S}x{S}", err, *t,
             (device_ms(torch, k3), None), B_MAIN * S * S)
        if S == 32:
            host["box_blur_solve"] = host_us(torch, k3)
        del M
        torch.cuda.empty_cache()


def k4_dense_section(torch, dev, gen, out, host, per_preset) -> None:
    """K4's dense form on random coordinates at the DIS level shapes of the
    three presets; sums over the fast preset's shapes."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.models import dis
    from funscript_flow_tpu_torch.ops.cuda import warp

    B = B_MAIN
    for h, Ho in sorted({s for v in K4_SHAPES.values() for s in v}):
        img = torch.rand((B, h, h), generator=gen, device=dev) * 255
        fy = torch.rand((B, Ho, Ho), generator=gen, device=dev) * (h - 1)
        fx = torch.rand((B, Ho, Ho), generator=gen, device=dev) * (h - 1)
        got = warp.sample_abs(img, fy, fx)
        want = dis.bilinear_abs(img, fy, fx)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.equal(got, want), f"sample_abs {h}->{Ho}: max abs err "
                                      f"{err}")
        grid = torch.stack([fx / (h - 1) * 2 - 1, fy / (h - 1) * 2 - 1], -1)

        def k4():
            return warp.sample_abs(img, fy, fx)

        def lib4():
            return F.grid_sample(img[:, None], grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)
        t = (time_ms(torch, k4),
             time_ms(torch, lambda: dis.bilinear_abs(img, fy, fx)),
             time_ms(torch, lib4))
        dev4 = (device_ms(torch, k4), device_ms(torch, lib4))
        n_px, src = B * Ho * Ho, B * h * h * 4
        _row(out, "sample_abs", f"{h}x{h}->{Ho}x{Ho}", err, *t, dev4, n_px,
             src, summed=(h, Ho) in K4_SHAPES["fast"])
        _add_preset(per_preset, "sample_abs",
                    [p for p, s in K4_SHAPES.items() if (h, Ho) in s], *t,
                    bound_ms("sample_abs", n_px, src)[0], dev4)
        if (h, Ho) == K4_SHAPES["fast"][0]:
            host["sample_abs"] = host_us(torch, k4)
        del img, fy, fx, got, want, grid
        torch.cuda.empty_cache()


def k4_patch_section(torch, dev, gen, out, host, per_preset) -> None:
    """K4's patch form at the DIS patch grids of the three presets, offsets
    as ``patch_offsets``; library: ``F.grid_sample`` on the pre-built dense
    coordinate grid. Sums over the fast preset's grids."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.models import dis
    from funscript_flow_tpu_torch.ops.cuda import warp

    B, ps = B_MAIN, PATCH
    for h, st in sorted({s for v in K4P_GRIDS.values() for s in v}):
        ny = nx = (h - ps) // st + 1
        img = torch.rand((B, h, h), generator=gen, device=dev) * 255
        pu, pv = patch_offsets(torch, gen, B, ny, nx, h, h, dev)
        got = warp.sample_patches(img, pu, pv, ps, st)
        want = dis._sample_patches_plain(img, pu, pv, ps, st)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.equal(got, want),
              f"sample_patches {h}px stride {st}: max abs err {err}")
        grid = patch_grid(torch, dis, h, h, pu, pv, ps, st)

        def k4p():
            return warp.sample_patches(img, pu, pv, ps, st)

        def lib4p():
            return F.grid_sample(img[:, None], grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)
        t = (time_ms(torch, k4p),
             time_ms(torch, lambda: dis._sample_patches_plain(img, pu, pv,
                                                              ps, st)),
             time_ms(torch, lib4p))
        dev4 = (device_ms(torch, k4p), device_ms(torch, lib4p))
        n_px = B * ny * nx * ps * ps
        extra = B * ny * nx * 8 + B * h * h * 4
        _row(out, "sample_patches", f"{h}x{h} stride {st} ({ny}x{nx} "
             f"patches)", err, *t, dev4, n_px, extra,
             summed=(h, st) in K4P_GRIDS["fast"])
        _add_preset(per_preset, "sample_patches",
                    [p for p, s in K4P_GRIDS.items() if (h, st) in s], *t,
                    bound_ms("sample_patches", n_px, extra)[0], dev4)
        if (h, st) == K4P_GRIDS["fast"][0]:
            host["sample_patches"] = host_us(torch, k4p)
        del img, pu, pv, got, want, grid
        torch.cuda.empty_cache()


def k5_section(torch, dev, gen, out, host, per_preset) -> None:
    """K5 at the DIS level sizes of the three presets, flow pre-clamped as
    in ``dis.variational_refinement``; sums over the fast preset's sizes."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import warp

    B = B_MAIN
    for S in sorted({s for v in K5_SIZES.values() for s in v}):
        planes = [torch.randn((B, S, S), generator=gen, device=dev) * 40
                  for _ in range(3)]
        ys = torch.arange(S, device=dev, dtype=torch.float32)[:, None]
        xs = torch.arange(S, device=dev, dtype=torch.float32)[None, :]
        u = torch.randn((B, S, S), generator=gen, device=dev) * 2
        v = torch.randn((B, S, S), generator=gen, device=dev) * 2
        u = (torch.clamp(xs + u, 0.0, S - 1.0) - xs).contiguous()
        v = (torch.clamp(ys + v, 0.0, S - 1.0) - ys).contiguous()
        got = warp.warp_planes(planes, u, v)
        want = fb.warp_bilinear(torch.stack(planes, 1), u, v)
        torch.cuda.synchronize()
        err = max_err(got, want)
        check(torch.equal(got, want), f"warp_planes {S}px: max abs err {err}")
        stacked = torch.stack(planes, 1)
        grid = grid_of(torch, u, v)

        def k5():
            return warp.warp_planes(planes, u, v)

        def lib5():
            return F.grid_sample(stacked, grid, mode="bilinear",
                                 padding_mode="border", align_corners=True)
        t = (time_ms(torch, k5), time_ms(torch, lambda: fb.warp_bilinear(
            torch.stack(planes, 1), u, v)), time_ms(torch, lib5))
        dev5 = (device_ms(torch, k5), device_ms(torch, lib5))
        n_px = B * S * S
        _row(out, "warp_planes", f"{S}x{S}", err, *t, dev5, n_px,
             summed=S in K5_SIZES["fast"])
        _add_preset(per_preset, "warp_planes",
                    [p for p, s in K5_SIZES.items() if S in s], *t,
                    bound_ms("warp_planes", n_px)[0], dev5)
        if S == 32:
            host["warp_planes"] = host_us(torch, k5)
        del planes, u, v, got, want, stacked, grid
        torch.cuda.empty_cache()


SECTIONS = {"poly_exp": k1_section, "warp_bilinear": k2_section,
            "box_blur_solve": k3_section, "sample_abs": k4_dense_section,
            "sample_patches": k4_patch_section, "warp_planes": k5_section}


def kernel_phase(torch, dev) -> dict:
    """Every kernel's section; returns per-kernel sums for the JSON line."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out, host, per_preset = {}, {}, {}
    for section in SECTIONS.values():
        section(torch, dev, gen, out, host, per_preset)
    for (name, preset), sums in sorted(per_preset.items()):
        print(f"kernel {name} preset {preset}, summed over its levels: "
              "ms={:.4f} plain_ms={:.4f} library_ms={:.4f} bound_ms={:.4f} "
              "device_ms={:.4f} library_device_ms={:.4f}".format(*sums))
    for name, o in out.items():
        o["bound_by"] = bound_ms(name, o["px"], o["extra_bytes"])[1]
        t_d, t_ld = o["device"]
        print(f"kernel {name}, summed as in the JSON line: ms={o['ms']:.4f} "
              f"device_ms={t_d:.4f} library_device_ms="
              + ("null" if t_ld is None else f"{t_ld:.4f}")
              + f" bound_ms={o['bound_ms']:.4f}")
    print("host cost per call at 32 px: " + ", ".join(
        f"{k} {v:.1f} us" for k, v in host.items()))
    return out


def edge_phase(torch, dev) -> None:
    """K3 at every ``EDGE_SHAPES`` shape and ``EDGE_WINSIZES`` window, K2
    (P=5) and K5 (P=3) at every shape and ``EDGE_AMPLITUDES`` field, K1 at
    every shape for ``poly_n`` 1-8, and both forms of K4 at the
    ``EDGE_K4`` sources for every ``EDGE_PATCHES`` patch size and stride,
    each held bitwise against its plain twin."""
    from funscript_flow_tpu_torch.models import dis
    from funscript_flow_tpu_torch.ops import farneback as fb
    from funscript_flow_tpu_torch.ops.cuda import flow_step, polyexp, warp

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    counts = dict.fromkeys(("box_blur_solve", "warp_bilinear", "warp_planes",
                            "poly_exp", "sample_abs", "sample_patches"), 0)
    for B, H, W in EDGE_SHAPES:
        M = tuple(torch.randn((B, H, W), generator=gen, device=dev) * 2
                  for _ in range(5))
        for win in EDGE_WINSIZES:
            got = flow_step.box_blur_solve(M, win)
            want = fb.solve_flow(M, win)
            err = max(max_err(a, b) for a, b in zip(got, want))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"box_blur_solve B={B} {H}x{W} winsize {win}: max abs "
                  f"err {err}")
            counts["box_blur_solve"] += 1
        for P, name in ((5, "warp_bilinear"), (3, "warp_planes")):
            R = torch.randn((B, P, H, W), generator=gen, device=dev)
            for amp in EDGE_AMPLITUDES:
                u, v = ((torch.rand((B, H, W), generator=gen, device=dev)
                         * 2 - 1) * amp for _ in range(2))
                got = (warp.warp_bilinear(R, u, v) if P == 5 else
                       warp.warp_planes([p.contiguous() for p in R.unbind(1)],
                                        u, v))
                want = fb.warp_bilinear(R, u, v)
                check(torch.equal(got, want),
                      f"{name} B={B} {H}x{W} +-{amp} px: max abs err "
                      f"{max_err(got, want)}")
                counts[name] += 1
        img = torch.rand((B, H, W), generator=gen, device=dev) * 255
        for n in range(1, polyexp.MAX_POLY_N + 1):
            sigma = 0.3 * n + 0.3
            got = polyexp.poly_exp(img, n, sigma)
            want = torch.stack(fb.poly_exp(img, n, sigma), 1)
            check(torch.equal(got, want),
                  f"poly_exp B={B} {H}x{W} poly_n {n}: max abs err "
                  f"{max_err(got, want)}")
            counts["poly_exp"] += 1
    for h, w in EDGE_K4:
        B = 3
        img = torch.rand((B, h, w), generator=gen, device=dev) * 255
        fy = torch.rand((B, h + 3, w - 5), generator=gen, device=dev) * (h - 1)
        fx = torch.rand((B, h + 3, w - 5), generator=gen, device=dev) * (w - 1)
        got = warp.sample_abs(img, fy, fx)
        want = dis.bilinear_abs(img, fy, fx)
        check(torch.equal(got, want), f"sample_abs {h}x{w}: max abs err "
                                      f"{max_err(got, want)}")
        counts["sample_abs"] += 1
        for ps, st in EDGE_PATCHES:
            ny, nx = (h - ps) // st + 1, (w - ps) // st + 1
            pu, pv = patch_offsets(torch, gen, B, ny, nx, h, w, dev)
            got = warp.sample_patches(img, pu, pv, ps, st)
            want = dis._sample_patches_plain(img, pu, pv, ps, st)
            check(torch.equal(got, want),
                  f"sample_patches {h}x{w} patch {ps} stride {st}: max abs "
                  f"err {max_err(got, want)}")
            counts["sample_patches"] += 1
    torch.cuda.synchronize()
    print(f"edge shapes: {sum(counts.values())} cases ({counts}) at B,H,W "
          f"{EDGE_SHAPES} (winsize {EDGE_WINSIZES}, +-{EDGE_AMPLITUDES} px "
          f"fields, poly_n 1-8) and K4 sources {EDGE_K4} (patch, stride "
          f"{EDGE_PATCHES}): all bitwise equal to their twins")


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


def signal_chain_phase(torch, dev):
    """A one-hour signal through ``compute_actions`` with
    ``signal_backend="auto"`` on the card: it must route to the device
    chain and stay within 0.5 of the host chain's 0-100 curve
    (tests/test_signal_jax.py:109). Prints both chains' times; returns the
    signal (dots, cuts) and the host chain's curve."""
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
    return dots, cuts, norm


def device_rows(prof) -> list:
    """(device us, name, count) of each kernel (and copy) of a finished
    ``torch.profiler`` trace, largest first: device-side rows only, since a
    host op's row repeats its kernels' time."""
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    return sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)


# the hand kernels' symbols, as the profiler names them: K1, K2/K5, K3,
# K4's patch form, K4's dense form
HAND_KERNELS = ("poly_exp_kernel", "warp_bilinear_kernel",
                "box_blur_solve_kernel", "sample_kernel<true",
                "sample_kernel<false")


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
    rows = device_rows(prof)
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


# ------------------------------------------ folder, checkpoint, profile, mesh

def serve_clips(folder: str, clips: dict) -> None:
    """Put a placeholder file for each clip name of ``clips`` (name ->
    frames) into ``folder`` and make the runner open each such file as
    (VideoMeta, ListSource) from any ``start_sample``: the card has no
    OpenCV to decode a file."""
    from funscript_flow_tpu_torch import runner
    from funscript_flow_tpu_torch.io.decode import VideoMeta

    for name in clips:
        open(os.path.join(folder, name), "wb").close()

    def open_clip(video_path, params, cancel_flag, start_sample=0):
        frames = clips[os.path.basename(video_path)]
        return (VideoMeta(total_frames=len(frames), fps=30.0, width=256,
                          height=256), ListSource(frames[start_sample:]))

    runner._open_video = open_clip


def _read_log(logs) -> tuple:
    """(windows, pairs) summed over the "Flow windows dispatched" lines."""
    hits = [re.search(r"Flow windows dispatched: (\d+) \((\d+) pairs\)", m)
            for m in logs]
    hits = [h for h in hits if h]
    return (sum(int(h.group(1)) for h in hits),
            sum(int(h.group(2)) for h in hits))


def busy_share(prof, wall_s: float) -> tuple:
    """(union of the device events' intervals, their sum), in ms, of a
    finished trace; the union over the wall time is the card's busy
    share."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e3, sum(b - a for a, b in spans) / 1e3


def folder_phase(torch, dev, card, files, algorithm, trace=False) -> dict:
    """The clips through ``_run_videos_parallel`` with each
    ``FOLDER_WORKERS`` count on ``dev``; returns the funscripts' bytes (the
    same for every count, checked). With ``trace``: one more run with 3 and
    with 1 workers under ``torch.profiler``, printing the card's busy
    share."""
    from funscript_flow_tpu_torch import runner
    from funscript_flow_tpu_torch.io.funscript import funscript_path
    from funscript_flow_tpu_torch.ops import cuda as kcuda
    from funscript_flow_tpu_torch.utils.params import Params

    params = Params(overwrite=True,
                    backend="DIS" if algorithm == "dis" else "CUDA")
    outs = None

    def run(workers):
        logs = []
        kcuda.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        err = runner._run_videos_parallel(files, params, logs.append, None,
                                          workers, n_devices=1,
                                          device=str(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not err, f"folder {algorithm}, {workers} workers: an error:\n"
              + "\n".join(logs))
        return logs, wall, kcuda.launch_counts()

    for workers in FOLDER_WORKERS:
        logs, wall, counts = run(workers)
        windows, pairs = _read_log(logs)
        check_launches(counts, windows, algorithm)
        got = {f: open(funscript_path(f), "rb").read() for f in files}
        if outs is None:
            outs = got
        for f in files:
            check(got[f] == outs[f], f"folder {algorithm}: "
                  f"{os.path.basename(f)} differs with {workers} workers")
        print(f"folder {algorithm}, {workers} worker(s) on {dev}: "
              f"{len(files)} clips, {pairs} pairs in {windows} windows, "
              f"wall {wall:.3f} s, {pairs / wall:.1f} pairs/s; launches "
              f"{counts}; funscripts byte-identical ({card})")
    if trace:
        from torch.profiler import ProfilerActivity, profile

        for workers in reversed(FOLDER_WORKERS):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _, wall, _ = run(workers)
            union, total = busy_share(prof, wall)
            print(f"folder {algorithm}, {workers} worker(s), traced: wall "
                  f"{wall:.3f} s, device busy {union:.1f} ms "
                  f"({union / 1e3 / wall:.1%} of the wall), device events "
                  f"{total:.1f} ms summed ({card})")
    return outs


def launch_rate(torch, dev, card, n: int = 20_000) -> None:
    """Host launch throughput of small eager ops (``torch.add`` into a
    preallocated output, 1024 floats) launched from 1 and from 3 threads
    at once, each thread on a stream of its own: the folder workers' launch
    path without their clips. Prints launches/s for each."""
    import threading

    def launch_loop(stream, x, y, k):
        with torch.cuda.stream(stream):
            for _ in range(k):
                torch.add(x, 1.0, out=y)

    for threads in (1, 3, 1, 3):
        bufs = [(torch.cuda.Stream(device=dev),
                 torch.zeros(1024, device=dev), torch.empty(1024, device=dev))
                for _ in range(threads)]
        for b in bufs:
            launch_loop(*b, 100)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts = [threading.Thread(target=launch_loop, args=(*b, n)) for b in bufs]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"launch rate, {threads} thread(s): {threads * n} launches in "
              f"{wall:.3f} s, {threads * n / wall:.0f} launches/s ({card})")


def checkpoint_phase(torch, dev, card, video, baseline: bytes) -> None:
    """``video`` with ``checkpoint=True``, a sidecar every
    ``CKPT_EVERY_PAIRS`` pairs, cancelled after the third poll, then
    resumed: it must log the resume, write ``baseline`` and clear the
    sidecar."""
    from funscript_flow_tpu_torch.io import checkpoint as ck
    from funscript_flow_tpu_torch.io.funscript import funscript_path
    from funscript_flow_tpu_torch.runner import process_video
    from funscript_flow_tpu_torch.utils.params import Params

    out = funscript_path(video)
    sidecar = ck.sidecar_path(out)
    os.remove(out)
    params = Params(overwrite=True, checkpoint=True)
    polls = {"n": 0}

    def cancel():
        polls["n"] += 1
        return polls["n"] > 3

    every, ck.CHECKPOINT_EVERY_PAIRS = ck.CHECKPOINT_EVERY_PAIRS, \
        CKPT_EVERY_PAIRS
    try:
        logs = []
        err = process_video(video, params, logs.append, cancel_flag=cancel,
                            device=str(dev))
        check(not err and not os.path.exists(out)
              and os.path.exists(sidecar),
              "checkpoint: the cancelled run left no sidecar (or an "
              "output):\n" + "\n".join(logs))
        with np.load(sidecar) as z:
            saved = len(z["dots"])
        logs = []
        t0 = time.perf_counter()
        err = process_video(video, params, logs.append, device=str(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ck.CHECKPOINT_EVERY_PAIRS = every
    resumed = [m for m in logs if m.startswith("Resuming from checkpoint")]
    check(not err and resumed, "checkpoint: no resume:\n" + "\n".join(logs))
    same = open(out, "rb").read() == baseline
    check(same, "checkpoint: the resumed funscript differs from the "
                "uninterrupted run's")
    check(not os.path.exists(sidecar), "checkpoint: sidecar not cleared")
    print(f"checkpoint: cancelled after poll 3 with {saved} pairs saved; "
          f"{resumed[0]} Resumed run {wall:.3f} s; funscript byte-identical "
          f"to the uninterrupted run, sidecar cleared ({card})")


def profile_phase(torch, dev, card, video, frames) -> None:
    """``video`` through ``process_video`` with ``profile_dir``: one chrome
    trace that names ``poly_exp_kernel``. Then ``device_profile`` of one
    full Farnebäck window beside one traced window's summed device
    events."""
    from torch.profiler import ProfilerActivity, profile

    from funscript_flow_tpu_torch.models.pipeline import (PipelineConfig,
                                                          flow_chunk_program)
    from funscript_flow_tpu_torch.runner import process_video
    from funscript_flow_tpu_torch.utils.devprof import device_profile
    from funscript_flow_tpu_torch.utils.params import Params

    with tempfile.TemporaryDirectory() as prof_dir:
        logs = []
        t0 = time.perf_counter()
        err = process_video(video, Params(overwrite=True,
                                          profile_dir=prof_dir),
                            logs.append, device=str(dev))
        wall = time.perf_counter() - t0
        check(not err, "profile: process_video failed:\n" + "\n".join(logs))
        traces = os.listdir(prof_dir)
        check(len(traces) == 1, f"profile: traces {traces}")
        path = os.path.join(prof_dir, traces[0])
        size = os.path.getsize(path)
        with open(path) as f:
            named = "poly_exp_kernel" in f.read()
    check(named, "profile: the trace does not name poly_exp_kernel")
    print(f"profile: {PROFILE_FRAMES}-frame clip with profile_dir in "
          f"{wall:.3f} s; trace {traces[0]} ({size} bytes) names "
          f"poly_exp_kernel ({card})")
    win = torch.from_numpy(np.stack(frames[: B_MAIN + 1])).to(dev)
    cfg = PipelineConfig()
    ms = device_profile(flow_chunk_program, win, B_MAIN, cfg, runs=3,
                        label=f"profile: device_profile, one {B_MAIN}-pair "
                              f"Farnebäck window ({card})")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        flow_chunk_program(win, B_MAIN, cfg)["dots"].cpu()
    traced = sum(r[0] for r in device_rows(prof)) / 1e3
    check(ms > 0 and traced > 0, "profile: no device time")
    print(f"profile: device_profile {ms:.3f} ms per window; one traced "
          f"window's device events {traced:.3f} ms ({card})")


def mesh_phase(torch, dev, card, frames) -> None:
    """The clip through ``StreamingFlowAnalyzer`` with no mesh and with a
    mesh of two devices: every output bitwise equal."""
    from funscript_flow_tpu_torch.models.pipeline import (
        PipelineConfig, StreamingFlowAnalyzer)

    if torch.cuda.device_count() >= 2:
        mesh, which = [torch.device("cuda", i) for i in range(2)], \
            "cuda:0 and cuda:1"
    else:
        mesh, which = [dev, dev], "cuda:0 twice (one card)"
    out, times = {}, {}
    for label, kw in (("none", {"device": dev}), ("mesh", {"mesh": mesh})):
        an = StreamingFlowAnalyzer(PipelineConfig(),
                                   n_pairs_total=len(frames) - 1, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = []
        for s in range(0, len(frames), 240):
            res.extend(an.push(frames[s : s + 240]))
        res.extend(an.flush())
        times[label] = (time.perf_counter() - t0, an.windows_dispatched)
        out[label] = {k: np.concatenate([r[k] for r in res]) for k in an.KEYS}
    diff = [k for k in out["none"]
            if not np.array_equal(out["none"][k], out["mesh"][k])]
    print(f"mesh: {len(frames) - 1} pairs, no mesh {times['none'][0]:.3f} s "
          f"in {times['none'][1]} windows, mesh of {which} "
          f"{times['mesh'][0]:.3f} s in {times['mesh'][1]} windows; "
          f"outputs differing: {diff or 'none'} ({card})")
    check(not diff, f"mesh: outputs {diff} not bitwise equal to no mesh")


def sp_phase(torch, dev, card, signal) -> None:
    """The one-hour signal through ``signal_chain_sharded`` over
    ``SP_SHARDS`` shards on ``dev`` (and through ``compute_actions`` with
    that mesh): within 1e-3 of the two-shard run and 0.5 of the host chain
    (tests/test_parallel.py:51,67-68)."""
    from funscript_flow_tpu_torch.parallel.signal_sp import \
        signal_chain_sharded
    from funscript_flow_tpu_torch.runner import compute_actions
    from funscript_flow_tpu_torch.utils.params import Params

    dots, cuts, host_norm = signal
    win, nwin = int(2.0 * 30), int(3.0 * 30)  # Params' 2 s and 3 s at 30 fps
    mesh = [dev] * SP_SHARDS
    signal_chain_sharded(dots, cuts, mesh, win, nwin)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    norm, mask = signal_chain_sharded(dots, cuts, mesh, win, nwin)
    wall = time.perf_counter() - t0
    two, _ = signal_chain_sharded(dots, cuts, [dev] * 2, win, nwin)
    logs = []
    acts, routed = compute_actions(dots, cuts, np.arange(len(dots)), 30.0,
                                   30.0, Params(), logs.append, device=dev,
                                   mesh=mesh)
    check(any("time-axis sharded" in m for m in logs),
          f"sp: compute_actions did not take the sharded chain: {logs}")
    e2, eh = (float(np.abs(norm - two).max()),
              float(np.abs(norm - host_norm).max()))
    er = float(np.abs(routed - norm).max())
    print(f"sp: {len(dots)} samples over {SP_SHARDS} shards on {dev}: "
          f"{wall:.4f} s, {int(mask.sum())} keyframes, {len(acts)} actions "
          f"through compute_actions; max |norm - 2-shard| {e2:.3g} (tol "
          f"1e-3), max |norm - host| {eh:.3g} (tol 0.5), compute_actions "
          f"{er:.3g} ({card})")
    check(e2 <= 1e-3 and eh <= 0.5 and er <= 1e-6,
          f"sp: off its references: {e2}, {eh}, {er}")


LIB_DIRS = ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib",
            "/usr/local/lib", "/lib/x86_64-linux-gnu", "/usr/local/cuda/lib64",
            "/usr/lib/aarch64-linux-gnu")
LIBAV = ("avcodec", "avformat", "swscale", "avutil")


def _shared_objects(name: str) -> list:
    """The files ``lib<name>.so*`` in ``LIB_DIRS`` and what the dynamic
    loader's cache names for ``name``."""
    import ctypes.util
    import glob

    found = sorted({os.path.realpath(p) for d in LIB_DIRS
                    for p in glob.glob(os.path.join(d, f"lib{name}.so*"))})
    cached = ctypes.util.find_library(name)
    return found + ([f"ldconfig: {cached}"] if cached else [])


def decode_probe() -> dict:
    """What the machine offers to decode a video file, found without
    installing anything: ffmpeg/ffprobe on PATH, libav's shared objects and
    headers, NVDEC's ``libnvcuvid.so``, ``cv2``, ``torchvision.io`` and
    ``torchaudio.io``, a C++ compiler, and whether the port's native pump
    built (and with which engines, and which encoders it can open)."""
    import importlib.util
    import shutil

    from funscript_flow_tpu_torch import runtime
    from funscript_flow_tpu_torch.runtime import _build as rt_build

    probe = {"ffmpeg": shutil.which("ffmpeg"),
             "ffprobe": shutil.which("ffprobe"),
             "libav_so": {n: _shared_objects(n) for n in LIBAV},
             "libav_headers": rt_build.find_libav(),
             "opencv_headers": rt_build.find_opencv(),
             "nvcuvid_so": _shared_objects("nvcuvid"),
             "cxx": shutil.which(rt_build.CXX)}
    for mod in ("cv2", "torchvision", "torchaudio", "av"):
        probe[mod] = importlib.util.find_spec(mod) is not None
    if probe["cv2"]:
        import glob

        try:
            import cv2

            ffmpeg = [ln.strip() for ln in cv2.getBuildInformation()
                      .splitlines() if "FFMPEG" in ln]
            site = os.path.dirname(os.path.dirname(cv2.__file__))
            probe["cv2"] = {
                "version": cv2.__version__, "ffmpeg": ffmpeg,
                "bundled_libav": sorted(os.path.basename(p) for p in
                                        glob.glob(os.path.join(
                                            site, "*.libs", "libav*")))}
        except Exception as e:  # report whatever stops the import
            probe["cv2"] = f"import fails: {type(e).__name__}: {e}"[:200]
    for mod, attr in (("torchvision.io", "VideoReader"),
                      ("torchaudio.io", "StreamReader")):
        if probe[mod.split(".")[0]]:
            try:
                m = __import__(mod, fromlist=[attr])
                probe[mod] = f"imports; {attr}: {hasattr(m, attr)}"
            except Exception as e:  # report whatever stops the import
                probe[mod] = f"import fails: {type(e).__name__}: {e}"[:200]
    t0 = time.perf_counter()
    built = runtime.available()
    probe["pump"] = {
        "built": built, "seconds": round(time.perf_counter() - t0, 3),
        "reason": runtime.unavailable_reason(),
        "engines": (["fast"] + (["exact"] if runtime.has_exact() else [])
                    if built else []),
        "library": runtime.library_path(),
        "encoders": ([c for c in ("libx264", "mpeg4")
                      if runtime.encoder_available(c)] if built else [])}
    return probe


def pump_missing(probe: dict) -> str:
    """What the machine lacks to build the native pump, in one line."""
    return (f"file phase skipped: the native pump does not build here "
            f"({probe['pump']['reason'].splitlines()[0]}); ffmpeg "
            f"{'on PATH' if probe['ffmpeg'] else 'not on PATH'}, libav "
            f"shared objects {'found' if any(probe['libav_so'].values()) else 'none'}"
            f", C++ compiler {probe['cxx'] or 'none'}")


def write_zoom_clip(torch, dev, path: str, n: int, h: int, w: int,
                    seed: int = SEED) -> str:
    """Encode ``n`` frames of ``make_clip``'s zoomed texture at ``h``x``w``
    (the texture's central 256x256 view stretched to the frame, so the
    pump's 256x256 analysis frames show ``make_clip``'s motion) with the
    port's encoder: ``libx264`` where it opens, else ``mpeg4``. Returns the
    codec."""
    import torch.nn.functional as F

    from funscript_flow_tpu_torch import runtime

    codec = "libx264" if runtime.encoder_available("libx264") else "mpeg4"
    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(rng.random((1, 1, 512, 512), dtype=np.float32)).to(dev)
    r = torch.arange(-9, 10, dtype=torch.float32, device=dev)
    k = torch.exp(-(r * r) / (2 * 3.0 ** 2))
    k = k / k.sum()
    tex = F.conv2d(F.pad(tex, (9, 9, 0, 0), mode="reflect"), k.view(1, 1, 1, -1))
    tex = F.conv2d(F.pad(tex, (0, 0, 9, 9), mode="reflect"), k.view(1, 1, -1, 1))
    tex = ((tex - tex.mean()) / tex.std() * 40 + 128).clamp(0, 255)
    px = (torch.arange(w, dtype=torch.float32, device=dev) - (w - 1) / 2) * 256 / w
    py = (torch.arange(h, dtype=torch.float32, device=dev) - (h - 1) / 2) * 256 / h
    with runtime.VideoEncoder(path, w, h, 30.0, codec=codec) as enc:
        for s0 in range(0, n, 25):
            t = torch.arange(s0, min(n, s0 + 25), dtype=torch.float32,
                             device=dev)
            s = 1 + 0.06 * torch.sin(2 * np.pi * t / 30)
            X = 255.5 + px[None, None, :] / s[:, None, None]
            Y = 255.5 + py[None, :, None] / s[:, None, None]
            grid = torch.stack([(X / 511 * 2 - 1).expand(-1, h, w),
                                (Y / 511 * 2 - 1).expand(-1, h, w)], dim=-1)
            img = F.grid_sample(tex.expand(len(t), -1, -1, -1), grid,
                                mode="bilinear", align_corners=True)
            gray = img[:, 0].round().clamp(0, 255).to(torch.uint8)
            for f in gray.unsqueeze(-1).expand(-1, -1, -1, 3).contiguous() \
                    .cpu().numpy():
                enc.write(f)
    return codec


def file_phase(torch, dev, card, n: int = FRAMES, size=FILE_SIZE) -> dict:
    """A ``size`` (h, w) clip of ``n`` frames at 30 fps, encoded by the
    port's encoder, through ``process_video(use_native_decode="on")`` on
    ``dev``, cold and then warm: the pump's fast engine decodes it, each
    window launches the Farnebäck kernels 8/12/12 times, and the funscript
    keeps its contract and is within 2 ``pos`` (the same ``at``) of the
    same pump frames pushed through ``preopened``. Prints pairs/s with
    decode included, the stage timers and the decode rate alone."""
    from funscript_flow_tpu_torch import runtime
    from funscript_flow_tpu_torch.io.funscript import load_funscript
    from funscript_flow_tpu_torch.ops import cuda as kcuda
    from funscript_flow_tpu_torch.runner import process_video
    from funscript_flow_tpu_torch.utils.params import Params

    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "file_clip.mp4")
        t0 = time.perf_counter()
        codec = write_zoom_clip(torch, dev, video, n, *size)
        enc_s = time.perf_counter() - t0
        print(f"file: {n} frames {size[1]}x{size[0]} at 30 fps encoded with "
              f"{codec} in {enc_s:.3f} s, {os.path.getsize(video)} bytes "
              f"({card})")
        for run in ("cold", "warm"):
            logs = []
            kcuda.reset_launches()
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            err = process_video(video, Params(overwrite=True,
                                              use_native_decode="on"),
                                logs.append, device=str(dev))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = kcuda.launch_counts()
            check(not err, "file: process_video failed:\n" + "\n".join(logs))
            engine = [m for m in logs if m.startswith("Decode: ")]
            check(len(engine) == 1 and engine[0].startswith(
                "Decode: native pump, fast engine"),
                f"file: not the pump's fast engine: {engine}")
            windows, pairs = _read_log(logs)
            if dev.type == "cuda":
                check_launches(counts, windows, "farneback")
            timers = next(m for m in logs if m.startswith("Stage timers"))
            got = load_funscript(os.path.join(tmp, "file_clip.funscript"))
            gap = check_funscript(got)
            print(f"file ({run} run): {pairs} pairs in {windows} windows, "
                  f"wall {wall:.3f} s, {pairs / wall:.1f} pairs/s with decode "
                  f"included; {engine[0]} {timers}; launches {counts}; "
                  f"median keyframe gap {gap:.1f} ms ({card})")
        t0 = time.perf_counter()
        src = runtime.NativeFrameSource(video, None, False, gray=True,
                                        fast=True)
        meta = src.meta
        check(src.is_fast, "file: the pump did not take the fast engine")
        frames = []
        while True:
            batch = src.get_batch(256)
            if not batch:
                break
            frames.extend(f.copy() for f in batch)
        src.close()
        dec_s = time.perf_counter() - t0
    print(f"file: decode alone (one pump, fast engine): {len(frames)} frames "
          f"in {dec_s:.3f} s, {len(frames) / dec_s:.1f} frames/s ({card})")
    want = main_path(torch, dev, frames, Params(overwrite=True),
                     fps=meta.fps)["funscript"]
    a, b = got["actions"], want["actions"]
    check([x["at"] for x in a] == [x["at"] for x in b],
          "file: 'at' differs from the preopened run of the pump's frames")
    dpos = max((abs(x["pos"] - y["pos"]) for x, y in zip(a, b)), default=0)
    check(dpos <= 2, f"file: pos differs by {dpos} from the preopened run")
    print(f"file: {len(a)} actions, same 'at' as the pump's frames through "
          f"preopened, max |pos delta| {dpos} (tol 2) ({card})")
    return {"pairs": pairs, "wall": wall}


def batch_worker_phase(torch, dev, card, files, algorithm) -> None:
    """The clips through ``BatchWorker`` on ``dev``: every clip generated,
    the log file written, progress at 100, and each funscript
    byte-identical to a direct ``process_video`` of the clip."""
    from funscript_flow_tpu_torch.io.funscript import funscript_path
    from funscript_flow_tpu_torch.ops import cuda as kcuda
    from funscript_flow_tpu_torch.runner import process_video
    from funscript_flow_tpu_torch.utils.params import Params
    from funscript_flow_tpu_torch.worker import BatchWorker

    params = Params(overwrite=True,
                    backend="DIS" if algorithm == "dis" else "CUDA")
    with tempfile.TemporaryDirectory() as logs_dir:
        progress, logs, done = [], [], []
        kcuda.reset_launches()
        t0 = time.perf_counter()
        w = BatchWorker(files, params, on_progress=progress.append,
                        on_log=logs.append,
                        on_finished=lambda e, g: done.append((e, g)),
                        logs_dir=logs_dir, device=str(dev))
        w.start()
        w.join(timeout=600)
        wall = time.perf_counter() - t0
        counts = kcuda.launch_counts()
        check(not w.is_alive() and done, "batch worker: did not finish")
        err, generated = done[0]
        check(not err, "batch worker: an error:\n" + "\n".join(logs))
        check(sorted(g[0] for g in generated) == sorted(files),
              f"batch worker: generated {generated}")
        check(progress and progress[-1] == 100,
              f"batch worker: progress ended at {progress[-1:]}")
        log_text = open(w.log_path).read() if w.log_path else ""
        check("Batch processing complete." in log_text,
              "batch worker: the log file is missing or incomplete")
    windows, pairs = _read_log(logs)
    if dev.type == "cuda":
        check_launches(counts, windows, algorithm)
    outs = {f: open(funscript_path(f), "rb").read() for f in files}
    for f in files:
        os.remove(funscript_path(f))
        check(not process_video(f, params, lambda m: None, device=str(dev)),
              f"batch worker: direct process_video of {f} failed")
        check(open(funscript_path(f), "rb").read() == outs[f],
              f"batch worker {algorithm}: {os.path.basename(f)} differs "
              f"from a direct process_video")
    engine = sorted({m.split("Decode: ", 1)[1].rstrip(".") for m in logs
                     if "Decode: " in m}) or ["the runner's replaced opener"]
    print(f"batch worker {algorithm} on {dev}: {len(files)} clips generated, "
          f"{pairs} pairs in {windows} windows, wall {wall:.3f} s, "
          f"{pairs / wall:.1f} pairs/s, progress "
          f"{progress[-1]}, log file written; decode: {', '.join(engine)}; "
          f"funscripts byte-identical to direct process_video ({card})")


def print_build(info: dict) -> None:
    """The build's time and ptxas's resource lines, one per kernel
    instance (its template arguments decoded from the mangled name)."""
    print(f"build: {info['seconds']:.2f} s (rebuilt={info['rebuilt']})")
    for ln in info["log"].splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d([a-z_]+_kernel)"
                          r"((?:I(?:L[bi]\d+E)+E)?)", ln)
        if entry:
            args = [("true" if v == "1" else "false") if t == "b" else v
                    for t, v in re.findall(r"L([bi])(\d+)E", entry.group(2))]
            print("ptxas: " + entry.group(1)
                  + (f"<{', '.join(args)}>" if args else ""))
        elif "registers" in ln or "spill" in ln:
            print("ptxas:", ln.strip())


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
        probe = decode_probe()
        print("decode probe: " + json.dumps(probe))
        check(probe["pump"]["built"] or not probe["libav_headers"],
              "the native pump failed to build where libav's headers are: "
              + probe["pump"]["reason"])

        _build.load()
        print_build(_build.build_info)
        kern = kernel_phase(torch, dev)
        edge_phase(torch, dev)

        frames = make_clip(torch, dev)
        paths = {}
        for algorithm in ("farneback", "dis"):
            paths[algorithm] = run_main_path(torch, dev, frames, algorithm)
            diff = kernels_vs_plain(torch, dev, frames, algorithm)
            print(f"kernels vs plain {algorithm}, first two windows: "
                  f"max abs diff {diff}")
        signal = signal_chain_phase(torch, dev)
        if probe["pump"]["built"]:
            file_phase(torch, dev, card)
            with tempfile.TemporaryDirectory() as folder:
                files = [os.path.join(folder, f"bw_{n}.mp4")
                         for n, _ in FOLDER_CLIPS]
                for f, (n, seed) in zip(files, FOLDER_CLIPS):
                    write_zoom_clip(torch, dev, f, n, 256, 256, seed)
                for algorithm in ("farneback", "dis"):
                    batch_worker_phase(torch, dev, card, files, algorithm)
        else:
            print(pump_missing(probe))
        from funscript_flow_tpu_torch import runner

        open_video = runner._open_video
        with tempfile.TemporaryDirectory() as folder:
            clips = {f"clip_{n}.mp4": (frames if seed == SEED else
                                       make_clip(torch, dev, n, seed))
                     for n, seed in FOLDER_CLIPS}
            clips["profile_clip.mp4"] = frames[:PROFILE_FRAMES]
            serve_clips(folder, clips)
            files = [os.path.join(folder, f"clip_{n}.mp4")
                     for n, _ in FOLDER_CLIPS]
            base = {algorithm: folder_phase(torch, dev, card, files,
                                            algorithm, bool(args.profile))
                    for algorithm in ("farneback", "dis")}
            if not probe["pump"]["built"]:
                for algorithm in ("farneback", "dis"):
                    batch_worker_phase(torch, dev, card, files, algorithm)
            if args.profile:
                launch_rate(torch, dev, card)
            checkpoint_phase(torch, dev, card, files[-1],
                             base["farneback"][files[-1]])
            profile_phase(torch, dev, card,
                          os.path.join(folder, "profile_clip.mp4"), frames)
        runner._open_video = open_video
        mesh_phase(torch, dev, card, frames)
        sp_phase(torch, dev, card, signal)
        if args.profile:
            for algorithm in ("farneback", "dis"):
                profile_window(torch, dev, frames, args.profile, algorithm)
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    rows = []
    for name, k in kern.items():
        path = paths["dis" if name in EXPECTED_PER_WINDOW["dis"]
                     else "farneback"]
        rows.append({
            "name": name, "route": "cuda",
            "source": KERNEL_META[name]["source"],
            "replaces": KERNEL_META[name]["replaces"],
            "launches": path["counts"][name],
            "launches_per_window": path["counts"][name] / path["windows"],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
