"""One run of one cell: set-up, warm-up, the measured window (with
``trace``, a traced slice at its start), then the comparison with the
reference.

The window drives ``funscript_flow_tpu_torch.runner.process_video``, one
call per clip and one clip in flight: a closed loop, as ``run_headless``
converts a folder on one card. Clips come in blocks that hold the same
lengths for every seed (``bench.traffic``); a block starts while the time
since the window opened is under ``seconds``, and the window closes when
the last block started has returned, every funscript written. So every
window is whole blocks, and every seed's window holds the same lengths.
A clip reaches the program through ``preopened`` as frames in memory (no
decode).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import pkgutil
import re
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import correct, guard, manifest, trace as tracemod, traffic as trafmod

TRACE_SLICE_S = 5.0  # the traced slice: the blocks started in its first 5 s

_WINDOWS = re.compile(r"Flow windows dispatched: (\d+) \((\d+) pairs\)")


def say(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)


@dataclass
class ClipRun:
    """One clip as the window ran it."""

    spec: trafmod.ClipSpec
    frames: int
    funscript: str
    wall: float
    err: bool
    logs: list
    dots: np.ndarray | None = None
    pairs: int = 0
    windows: int = 0

    def __post_init__(self):
        for line in self.logs:
            m = _WINDOWS.search(line)
            if m:
                self.windows, self.pairs = int(m.group(1)), int(m.group(2))


@dataclass
class Ctx:
    """What a per-layer metric's reader gets: the traced slice's clips,
    every clip of the run's window (the slice's first), the slice's trace,
    the hand kernels' files, their launches in the slice and the chip's
    peaks."""

    clips: list
    trace: tracemod.Trace | None
    window_clips: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    launches: list = field(default_factory=list)
    peaks: dict = field(default_factory=dict)

    @property
    def pairs(self) -> int:
        return sum(c.pairs for c in self.clips)


class LaunchLog:
    """The hand kernels' launches, (kernel, launch arguments), in the order
    the device runs them. A launch made while a CUDA graph is captured
    runs only when the graph is replayed: it is kept with its graph and
    entered once for every replay."""

    def __init__(self):
        self.launches: list = []
        self._graphs: dict = {}
        self._capturing = None

    def launch(self, kernel: str, args: tuple) -> None:
        if self._capturing is None:
            self.launches.append((kernel, args))
        else:
            self._graphs[self._capturing].append((kernel, args))

    def capture_begin(self, graph) -> None:
        self._capturing = id(graph)
        self._graphs[id(graph)] = []

    def capture_end(self, graph) -> None:
        self._capturing = None

    def replay(self, graph) -> None:
        self.launches.extend(self._graphs.get(id(graph), ()))


@contextlib.contextmanager
def recorded_launches(log: LaunchLog):
    """Enter every hand-kernel launch into ``log`` while the block runs:
    the kernel wrappers' modules call ``ops.cuda._build.launch``, and CUDA
    graphs are captured and replayed through ``torch.cuda.CUDAGraph``;
    both are wrapped here and restored after."""
    from funscript_flow_tpu_torch.ops import cuda as kernels
    from funscript_flow_tpu_torch.ops.cuda import _build

    # every wrapper module first, so that none binds the stand-in below
    for info in pkgutil.iter_modules(kernels.__path__):
        importlib.import_module(f"{kernels.__name__}.{info.name}")
    orig = _build.launch

    def launch(kernel, fn_name, t, *args):
        log.launch(kernel, args)
        return orig(kernel, fn_name, t, *args)

    mods = [m for n, m in list(sys.modules.items())
            if n.startswith(kernels.__name__ + ".")
            and getattr(m, "launch", None) is orig]
    graph_cls = torch.cuda.CUDAGraph
    saved = {n: graph_cls.__dict__.get(n)
             for n in ("capture_begin", "capture_end", "replay")}

    def wrap(name, note):
        base = getattr(graph_cls, name)

        def method(self, *args, **kw):
            note(self)
            return base(self, *args, **kw)
        return method

    for m in mods:
        m.launch = launch
    graph_cls.capture_begin = wrap("capture_begin", log.capture_begin)
    graph_cls.capture_end = wrap("capture_end", log.capture_end)
    graph_cls.replay = wrap("replay", log.replay)
    try:
        yield log
    finally:
        for m in mods:
            m.launch = orig
        for n, f in saved.items():
            if f is None:
                delattr(graph_cls, n)
            else:
                setattr(graph_cls, n, f)


class Runner:
    """Converts clips of one cell through ``process_video``."""

    def __init__(self, cell: manifest.Cell, seed: int, device):
        from funscript_flow_tpu_torch import runner
        from funscript_flow_tpu_torch.io.decode import VideoMeta
        from funscript_flow_tpu_torch.utils.params import Params

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.traffic = cell.traffic
        if self.traffic["source"] != "generated":
            raise ValueError(f"unknown traffic source {self.traffic['source']!r}")
        self.params = Params(**cell.config["params"], overwrite=True)
        self._runner, self._meta = runner, VideoMeta
        self.workdir = tempfile.mkdtemp(prefix="perfbench-")
        self.pool = trafmod.pool(self.traffic, seed, self.device)
        self._specs = trafmod.plan(self.traffic, seed)
        self._block = len(trafmod.block_lengths(self.traffic))
        # the per-pair dots that the timed path hands its signal chain
        self._box: dict = {}
        orig = runner.compute_actions

        def compute_actions(dots, cuts, *args, **kw):
            self._box["dots"] = dots
            with torch.profiler.record_function("perfbench.signal_chain"):
                return orig(dots, cuts, *args, **kw)

        self._orig_compute = orig
        runner.compute_actions = compute_actions

    def close(self) -> None:
        self._runner.compute_actions = self._orig_compute
        shutil.rmtree(self.workdir, ignore_errors=True)

    def convert(self, spec: trafmod.ClipSpec, tag: str) -> ClipRun:
        path = os.path.join(self.workdir, f"{tag}.mp4")
        h, w = self.traffic["size"]
        meta = self._meta(total_frames=spec.frames,
                          fps=float(self.traffic["fps"]), width=w, height=h)
        pre = (meta, trafmod.PoolSource(self.pool, spec, self.traffic))
        logs: list = []
        self._box.clear()
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.clip"):
            err = self._runner.process_video(
                path, self.params, logs.append, preopened=pre,
                device=str(self.device))
        wall = time.perf_counter() - t0
        return ClipRun(spec=spec, frames=spec.frames,
                       funscript=os.path.splitext(path)[0] + ".funscript",
                       wall=wall, err=bool(err), logs=logs,
                       dots=self._box.get("dots"))

    def warm_up(self) -> None:
        """Every window size the cell's clips dispatch, once: clips of the
        traffic's ``warmup_frames`` lengths."""
        first = next(trafmod.plan(self.traffic, self.seed))
        for k, n in enumerate(self.traffic["warmup_frames"]):
            spec = dataclasses.replace(first, index=-1 - k, frames=n,
                                       cut_at=min(first.cut_at, n))
            run = self.convert(spec, f"warmup_{k}")
            if run.err:
                raise RuntimeError("warm-up clip failed:\n" + "\n".join(run.logs))

    def window(self, seconds: float) -> tuple:
        """(clips, seconds): whole blocks of clips, each block started
        while under ``seconds``; a later call goes on with the next
        block."""
        clips: list = []
        ends = []
        with torch.profiler.record_function(tracemod.WINDOW_SPAN):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds or len(clips) % self._block:
                spec = next(self._specs)
                clips.append(self.convert(spec, f"clip_{spec.index:05d}"))
                if len(clips) % self._block == 0:
                    ends.append(time.perf_counter() - t0)
            wall = time.perf_counter() - t0
        pairs = [sum(c.pairs for c in clips[k: k + self._block])
                 for k in range(0, len(clips), self._block)]
        say("blocks (pairs/s): " + " ".join(
            f"{p / (b - a):.1f}" for p, a, b in zip(pairs, [0.0] + ends, ends)))
        return clips, wall


def check(run: Runner, clips: list, seed: int) -> tuple:
    """(numbers, limits, compared clips) of the comparison with the
    reference: the window's longest clip and one more drawn from the
    seed, each against the reference run on the same frames."""
    from ..reference.clip import clip_actions, pair_signal

    params = run.cell.config["params"]
    limits = run.cell.config["correct_limits"]
    fps = float(run.traffic["fps"])
    ok = [c for c in clips if not c.err]
    picks = [ok[i] for i in correct.sample(ok, seed)]
    rows = []
    for clip in picks:
        frames = trafmod.clip_frames(run.pool, clip.spec, run.traffic)
        dots, cuts = pair_signal(frames, params, run.device)
        with open(clip.funscript) as f:
            actions = json.load(f)["actions"]
        rows.append(correct.compare(
            clip.dots, actions, (dots, clip_actions(dots, cuts, params, fps, 1))))
    return correct.worst(rows), limits, len(picks)


def _profiler(dev):
    """A ``torch.profiler.profile`` of host and device activity, its
    start-up paid once here, in set-up."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts):
        (torch.ones(8, device=dev) + 1).sum().item()
    return profile(activities=acts)


def run(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", time.perf_counter())]
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        from funscript_flow_tpu_torch.ops.cuda import _build

        _build.load()
    guard.check("after import")
    marks.append(("CUDA and kernel library", time.perf_counter()))
    r = Runner(cell, seed, dev)
    log = LaunchLog()
    recording = recorded_launches(log) if trace else contextlib.nullcontext()
    try:
        marks.append(("inputs", time.perf_counter()))
        with recording:
            r.warm_up()
            marks.append(("warm-up", time.perf_counter()))
            say("frames served from memory through preopened: no decode in "
                "the window")
            prof = _profiler(dev) if trace else None
            if dev.type == "cuda":
                torch.cuda.synchronize()
            setup_s = time.perf_counter() - t_start
            marks.append(("tracer" if trace else "sync", time.perf_counter()))
            say("set-up: " + ", ".join(
                f"{name} {b - a:.3f} s" for (_, a), (name, b)
                in zip([("start", t_start)] + marks[:-1], marks)))
            if trace:
                log.launches.clear()
                prof.start()
                traced, traced_wall = r.window(min(seconds, TRACE_SLICE_S))
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                prof.stop()
        if trace:
            say(f"traced slice: {len(traced)} clips, "
                f"{sum(c.pairs for c in traced)} pairs in {traced_wall:.6f} s")
            rest, rest_wall = r.window(seconds - traced_wall) \
                if seconds > traced_wall else ([], 0.0)
            clips, wall = traced + rest, traced_wall + rest_wall
        else:
            clips, wall = r.window(seconds)
        guard.check("after the window")
        pairs = sum(c.pairs for c in clips)
        failed = sum(1 for c in clips if c.err)
        say(f"window: {len(clips)} clips, {pairs} pairs in {wall:.6f} s "
            f"(ran past {seconds:g} s by {max(0.0, wall - seconds):.6f} s)")
        mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        out = {"attempted": len(clips), "failed": failed, "metrics": {},
               "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                          "kind": torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu",
                          "count": 1, "memory_peak_bytes": int(mem)}}
        if trace:
            t0 = time.perf_counter()
            tr = tracemod.from_profiler(prof)
            del prof
            say(f"trace: {len(tr.dev_names)} device and {len(tr.cpu_names)} "
                f"host events read in {time.perf_counter() - t0:.3f} s")
            ctx = Ctx(clips=traced, trace=tr, window_clips=clips,
                      kernels=manifest.kernels(), launches=log.launches,
                      peaks=manifest.peaks())
            for m in cell.per_layer:
                value = manifest.reader(m["name"])(ctx)
                if value is not None:
                    out["metrics"][m["name"]] = {"value": value,
                                                 "unit": m["unit"]}
            out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
            out["breakdown"] = {"device_ops": tr.device_ops(),
                                "idle_gaps": tr.idle_gaps()}
        else:
            # a rate split by configuration (``pairs_per_s.<qualifier>``)
            # is the same quantity
            values = {"pairs_per_s": pairs / wall, "setup_s": setup_s}
            for m in cell.end_to_end:
                out["metrics"][m["name"]] = {
                    "value": values[m["name"].split(".", 1)[0]],
                    "unit": m["unit"]}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        numbers, limits, n = check(r, clips, seed)
        say(f"reference: {n} clips compared in {time.perf_counter() - t0:.3f} s")
        out["correct"] = correct.verdict(numbers, limits, failed) and n > 0
        out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                         for k in correct.NUMBERS}
        return out
    finally:
        r.close()
