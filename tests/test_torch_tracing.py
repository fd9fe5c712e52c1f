"""The port's spans (utils.logging.span) through process_video on the CPU:
under torch.profiler every span of a clip is recorded and nests as the
runner documents; with no profiler none builds a record_function; the
``Stage timers`` line totals the same spans."""

import re
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import reference_cv as ref
from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.io.decode import VideoMeta
from funscript_flow_tpu_torch.utils import logging as flog
from funscript_flow_tpu_torch.utils.params import Params

torch.set_num_threads(1)

CLIP_SPANS = ("ff.clip", "ff.clip.setup", "ff.signal_chain", "ff.clip.write")
WINDOW_SPANS = ("ff.window.upload", "ff.window.program", "ff.window.wait")
BACKENDS = {"farneback": {}, "dis": {"backend": "DIS"}}


class ListSource:
    def __init__(self, frames):
        self._frames = list(frames)
        self._i = 0

    def get_batch(self, n):
        out = self._frames[self._i: self._i + n]
        self._i += len(out)
        return out

    def close(self):
        pass


@pytest.fixture(scope="module")
def gray40():
    frames = ref.make_synthetic_frames(40, h=64, w=64, period=12, seed=11)
    return [ref.rgb_to_gray(f) for f in frames]


def _clip(frames, path, backend="farneback"):
    """(error, log lines, wall seconds) of one 40-frame clip."""
    logs = []
    meta = VideoMeta(total_frames=len(frames), fps=30.0, width=64, height=64)
    t0 = time.perf_counter()
    err = trun.process_video(
        str(path), Params(overwrite=True, pair_batch=8, **BACKENDS[backend]),
        logs.append, preopened=(meta, ListSource(frames)), device="cpu")
    return err, logs, time.perf_counter() - t0


def _windows(logs):
    (line,) = [m for m in logs if m.startswith("Flow windows dispatched")]
    m = re.fullmatch(r"Flow windows dispatched: (\d+) \((\d+) pairs\)", line)
    assert m, line
    return int(m.group(1))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_spans_nest_in_the_profilers_trace(gray40, tmp_path, monkeypatch,
                                           backend):
    orig = trun.compute_actions

    def compute_actions(*args, **kw):
        # a caller's span around the call, as the benchmark records one
        with torch.profiler.record_function("caller.compute_actions"):
            return orig(*args, **kw)

    monkeypatch.setattr(trun, "compute_actions", compute_actions)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        err, logs, _ = _clip(gray40, tmp_path / "clip.mp4", backend)
    assert not err, logs
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith(("ff.", "caller.")):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    for name in CLIP_SPANS + ("caller.compute_actions",):
        assert len(spans.get(name, ())) == 1, (name, spans.keys())
    windows = _windows(logs)
    for name in WINDOW_SPANS:
        assert len(spans.get(name, ())) == windows, (name, spans.get(name))
    assert spans["ff.decode_wait"]

    (clip,) = spans["ff.clip"]

    def inside(outer, inner):
        return outer[0] <= inner[0] and inner[1] <= outer[1]

    for name, ivs in spans.items():
        assert all(inside(clip, iv) for iv in ivs), name
    (setup,) = spans["ff.clip.setup"]
    for name in WINDOW_SPANS + ("ff.decode_wait", "ff.signal_chain"):
        assert not any(inside(setup, iv) for iv in spans[name]), name
    # the signal chain's span is opened inside compute_actions itself
    assert inside(spans["caller.compute_actions"][0],
                  spans["ff.signal_chain"][0])
    # each window is uploaded before its program is issued
    for up, prog in zip(spans["ff.window.upload"], spans["ff.window.program"]):
        assert up[1] <= prog[0]


def test_no_profiler_builds_no_record_function(gray40, tmp_path, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    err, logs, _ = _clip(gray40, tmp_path / "clip.mp4")
    assert not err, logs
    assert calls == []
    # the stand-in is the one the spans would call: under a profile it runs
    with profile(activities=[ProfilerActivity.CPU]):
        with flog.span("ff.probe"):
            pass
    assert calls == ["ff.probe"]


def test_stage_timers_line(gray40, tmp_path):
    err, logs, wall = _clip(gray40, tmp_path / "clip.mp4")
    assert not err, logs
    (line,) = [m for m in logs if m.startswith("Stage timers: ")]
    pairs = re.findall(r"(\w+)=(\d+\.\d{3})s", line)
    assert [k for k, _ in pairs] == list(trun.STAGES)
    assert line == "Stage timers: " + " ".join(f"{k}={v}s" for k, v in pairs)
    total = sum(float(v) for _, v in pairs)
    assert 0.0 < total <= wall
    assert _windows(logs) == 5  # the line runner tests and benchmark read


def test_span_feeds_its_stage():
    timers = flog.StageTimers()
    with flog.span("ff.window.upload", timers):
        time.sleep(0.002)
    with flog.span("ff.window.upload", timers):
        pass
    with flog.span("ff.clip"):  # no timers: no stage
        pass
    with pytest.raises(ValueError):
        with flog.span("ff.clip.write", timers):
            raise ValueError("the write failed")
    t = timers.report()
    assert sorted(t) == ["upload", "write"]
    assert t["upload"] >= 0.002 and t["write"] >= 0.0


def test_span_records_under_a_running_profile():
    """A span entered while a profile runs is one event of that trace,
    nested under the span open around it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with flog.span("ff.outer"):
            with flog.span("ff.inner", flog.StageTimers()):
                torch.ones(8).sum()
    got = {e.name: (e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("ff.")}
    assert sorted(got) == ["ff.inner", "ff.outer"]
    assert got["ff.outer"][0] <= got["ff.inner"][0]
    assert got["ff.inner"][1] <= got["ff.outer"][1]
