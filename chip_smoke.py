#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout. Exits non-zero, with no ``ok`` line, when
CUDA is unavailable, when the port's package is not beside this script, or
when any phase fails. Phases, in order:

1. the card's name and power limit (nvidia-smi);
2. build: the port's CUDA kernels are compiled from ``csrc/`` (nvcc);
3. kernels: each kernel's wrapper against its plain PyTorch twin on the
   card, at B=252 and every pyramid level size of a 256x256 frame, with the
   stated tolerance; per kernel and level the kernel's time, the plain
   twin's time and, where one PyTorch call computes the same function, that
   call's time (CUDA events, median of ``REPS``), beside the bound: the
   larger of its bytes at 3.35 TB/s and its float32 operations at
   67 TFLOP/s (the H100 SXM data-sheet peaks);
4. main path: a synthetic clip of ``FRAMES`` 256x256 frames (a smooth
   texture zoomed about the centre with scale 1 + 0.06 sin(2 pi t / 30))
   through the port's entry point ``process_video`` with default Params;
   checks the funscript, the keyframe period and that every dispatched
   window launched each kernel its expected number of times (8 / 12 / 12);
5. kernels vs plain end to end: the first two full windows of the clip
   through the flow program with ``kernels="auto"`` and ``kernels="plain"``;
6. with ``--profile DIR`` only: one full window timed and traced
   (torch.profiler), device time summed by kernel name, trace in DIR;
7. one JSON line listing the kernels, then the contract line.

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
EXPECTED_PER_WINDOW = {"poly_exp": 8, "warp_bilinear": 12, "box_blur_solve": 12}
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
        "bytes_px": 5 * 4 + 2 * 4 + 5 * 4, "flops_px": 53, "tol": "atol 1e-5",
    },
    "box_blur_solve": {
        "source": "funscript_flow_tpu_torch/csrc/flow_step.cu",
        "replaces": "funscript_flow_tpu/ops/pallas/flow_step.py:71",
        "bytes_px": 5 * 4 + 2 * 4, "flops_px": 158,
        "tol": "rtol 2e-2, atol 1e-3",
    },
}


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


def bound_ms(name: str, n_px: int):
    m = KERNEL_META[name]
    t_bytes = n_px * m["bytes_px"] / HBM_BYTES_PER_S * 1e3
    t_ops = n_px * m["flops_px"] / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    out = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
               "bound_ms": 0.0, "library_ms": 0.0, "px": 0}
           for k in KERNEL_META}
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
        rows = [("poly_exp", err1, t_k, t_p, t_l)]

        # --- K2 warp_bilinear (flow of a few pixels, as on the main path)
        R = torch.randn((B, 5, S, S), generator=gen, device=dev)
        u = torch.randn((B, S, S), generator=gen, device=dev) * 5
        v = torch.randn((B, S, S), generator=gen, device=dev) * 5
        got = warp.warp_bilinear(R, u, v)
        want = fb.warp_bilinear(R, u, v)
        inb = fb.warp_inbounds(u, v)[:, None].expand_as(got)
        torch.cuda.synchronize()
        err2 = float((got - want)[inb].abs().max())
        check(err2 <= 1e-5, f"warp_bilinear {S}px: max abs err {err2}")
        ys = torch.arange(S, device=dev, dtype=torch.float32)[:, None]
        xs = torch.arange(S, device=dev, dtype=torch.float32)[None, :]
        grid = torch.stack([(xs + u) / (S - 1) * 2 - 1,
                            (ys + v) / (S - 1) * 2 - 1], dim=-1)
        t_k = time_ms(torch, lambda: warp.warp_bilinear(R, u, v))
        t_p = time_ms(torch, lambda: fb.warp_bilinear(R, u, v))
        t_l = time_ms(torch, lambda: F.grid_sample(
            R, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        del got, want, inb, grid, R
        rows.append(("warp_bilinear", err2, t_k, t_p, t_l))

        # --- K3 box_blur_solve (random constraint planes, as in the tests)
        M = tuple(torch.randn((B, S, S), generator=gen, device=dev) * 2
                  for _ in range(5))
        gu, gv = flow_step.box_blur_solve(M, 15)
        wu, wv = fb.solve_flow(M, 15)
        torch.cuda.synchronize()
        err3 = max(float((gu - wu).abs().max()), float((gv - wv).abs().max()))
        ok3 = all(bool(((a - b).abs() <= 1e-3 + 2e-2 * b.abs()).all())
                  for a, b in ((gu, wu), (gv, wv)))
        check(ok3, f"box_blur_solve {S}px: outside rtol 2e-2/atol 1e-3 "
                   f"(max abs err {err3})")
        t_k = time_ms(torch, lambda: flow_step.box_blur_solve(M, 15))
        t_p = time_ms(torch, lambda: fb.solve_flow(M, 15))
        del gu, gv, wu, wv, M
        rows.append(("box_blur_solve", err3, t_k, t_p, None))

        for name, err, t_k, t_p, t_l in rows:
            b_ms, _ = bound_ms(name, n_px)
            o = out[name]
            o["max_abs_err"] = max(o["max_abs_err"], err)
            o["ms"] += t_k
            o["plain_ms"] += t_p
            o["bound_ms"] += b_ms
            o["library_ms"] = None if t_l is None else o["library_ms"] + t_l
            o["px"] += n_px
            lib = "null" if t_l is None else f"{t_l:.4f}"
            print(f"kernel {name} B={B} {S}x{S}: max_abs_err={err:.3g} "
                  f"(tol {KERNEL_META[name]['tol']}) ms={t_k:.4f} "
                  f"plain_ms={t_p:.4f} library_ms={lib} bound_ms={b_ms:.4f}")
        torch.cuda.empty_cache()
    for name, o in out.items():
        o["bound_by"] = bound_ms(name, o["px"])[1]
    return out


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


def kernels_vs_plain(torch, dev, frames) -> dict:
    """First two full windows through the flow program, kernels vs plain;
    returns the max abs difference per output (bars of tests/test_flow.py:
    centers 1.0, dots 5e-3, mean_mag 1e-3)."""
    from funscript_flow_tpu_torch.models.pipeline import (FlowAnalyzer,
                                                          PipelineConfig)

    clip = np.stack(frames[: 2 * 240 + 1])
    res = {k: FlowAnalyzer(PipelineConfig(kernels=k), device=dev)
           .analyze_video_pairs(clip) for k in ("auto", "plain")}
    a, p = res["auto"], res["plain"]
    diff = {k: float(np.abs(a[k].astype(np.float64) - p[k]).max())
            for k in ("dots", "centers", "mean_mag")}
    check(bool((a["cuts"] == p["cuts"]).all()), "cuts differ")
    for k, tol in (("centers", 1.0), ("dots", 5e-3), ("mean_mag", 1e-3)):
        check(diff[k] <= tol, f"{k}: kernels vs plain {diff[k]} > {tol}")
    return diff


def profile_window(torch, dev, frames, out_dir: str) -> None:
    """Where one full window's time goes: the flow program on 253 frames
    (252 pairs), timed with CUDA events for kernels="auto" and "plain",
    then one traced run whose device time is summed by kernel name.
    Writes the chrome trace to ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile

    from funscript_flow_tpu_torch.models.pipeline import (PipelineConfig,
                                                          flow_chunk_program)

    win = torch.from_numpy(np.stack(frames[: B_MAIN + 1])).to(dev)
    for k in ("auto", "plain"):
        cfg = PipelineConfig(kernels=k)
        ms = time_ms(torch, lambda: flow_chunk_program(win, B_MAIN, cfg))
        print(f"profile: flow program, one {B_MAIN}-pair window, "
              f"kernels={k}: {ms:.3f} ms ({B_MAIN / ms * 1e3:.1f} pairs/s)")
    from torch.autograd import DeviceType

    cfg = PipelineConfig()
    for cycle in range(2):  # the first cycle pays the tracer's start-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            flow_chunk_program(win, B_MAIN, cfg)["dots"].cpu()
        wall_ms = (time.perf_counter() - t0) * 1e3
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "window_trace.json"))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side events only: a host op's row repeats its kernels' time
    rows = sorted(((dev_us(e), e.key, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profile: traced window wall {wall_ms:.3f} ms, device time "
          f"{total / 1e3:.3f} ms ({total / 1e3 / wall_ms:.1%} busy), "
          f"{sum(r[2] for r in rows)} device events")
    ours = {"poly_exp_kernel", "warp_bilinear_kernel", "box_blur_solve_kernel"}
    mine = sum(r[0] for r in rows if any(o in r[1] for o in ours))
    print(f"profile: hand kernels {mine / 1e3:.3f} ms "
          f"({mine / max(total, 1e-9):.1%} of device time)")
    for us, key, count in rows[:15]:
        print(f"profile: {us / 1e3:9.3f} ms {count:5d}x {key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="also profile one full window; trace written here")
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
            if "registers" in ln or "spill" in ln:
                print("ptxas:", ln.strip())

        kern = kernel_phase(torch, dev)

        frames = make_clip(torch, dev)
        mp = main_path(torch, dev, frames)
        gap = check_funscript(mp["funscript"])
        print(f"main path: {mp['pairs']} pairs in {mp['windows']} windows, "
              f"wall {mp['wall']:.3f} s, {mp['pairs'] / mp['wall']:.1f} pairs/s, "
              f"{len(mp['funscript']['actions'])} actions, median keyframe "
              f"gap {gap:.1f} ms; launches {mp['counts']}")
        for name, per in EXPECTED_PER_WINDOW.items():
            want = per * mp["windows"]
            check(mp["counts"][name] == want,
                  f"{name}: {mp['counts'][name]} launches, expected {want}")
        check(abs(gap - GAP_MS) <= GAP_TOL_MS,
              f"median keyframe gap {gap} ms, expected {GAP_MS} +- {GAP_TOL_MS}")

        diff = kernels_vs_plain(torch, dev, frames)
        print(f"kernels vs plain, first two windows: max abs diff {diff}")
        if args.profile:
            profile_window(torch, dev, frames, args.profile)
    except Failure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": KERNEL_META[name]["source"],
         "replaces": KERNEL_META[name]["replaces"],
         "launches": mp["counts"][name],
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
