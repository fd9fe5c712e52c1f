"""Long clips through the port's signal chain on the CPU: ``auto``'s
routing check and the device chain each run in a span of their own
(``ff.signal.route``, ``ff.signal.device``) inside ``ff.signal_chain``,
only where the runner takes those paths; and the device chain's actions
against the benchmark's plain float64 reference, read as its comparison
reads them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from funscript_flow_tpu_torch import runner as trun
from funscript_flow_tpu_torch.utils.params import Params
from perfbench.bench import correct
from perfbench.reference import signal as ref_signal

torch.set_num_threads(1)

LONG = 70_000    # over runner.AUTO_DEVICE_MIN_SAMPLES: auto checks the route
SHORT = 2_000
FPS = 30.0
SIGNAL_SPANS = ("ff.signal.route", "ff.signal.device")


def _signal(n, seed=14, step_at=None):
    """A seeded zoom-like oscillation with noise and two cuts; with
    ``step_at``, one pair whose integrated flow steps by more than the
    discontinuity threshold."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    dots = 3.0 * np.sin(2 * np.pi * t / 41.0) + rng.normal(0, 0.3, n)
    cuts = np.zeros(n, bool)
    cuts[[n // 5, 3 * n // 5]] = True
    if step_at is not None:
        dots[step_at] += 2500.0
    return dots, cuts


def _traced(dots, cuts):
    """(actions, logs, {span: [(start, end)]}) of compute_actions in
    ``auto`` on the CPU under a profiler."""
    logs = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        acts, _ = trun.compute_actions(dots, cuts, np.arange(len(dots)), FPS,
                                       FPS, Params(), logs.append,
                                       device="cpu")
    spans: dict = {}
    for e in prof.events():
        if e.name.startswith("ff."):
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return acts, logs, spans


@pytest.fixture(scope="module")
def long_clean():
    return _signal(LONG)


def test_long_clean_clip_records_route_and_device(long_clean):
    acts, logs, spans = _traced(*long_clean)
    assert any(m.startswith("Signal chain: device") for m in logs), logs
    assert acts
    (outer,) = spans["ff.signal_chain"]
    for name in SIGNAL_SPANS:
        (inner,) = spans[name]
        assert outer[0] <= inner[0] <= inner[1] <= outer[1], name
    # the route is decided before the device chain runs
    assert spans["ff.signal.route"][0][1] <= spans["ff.signal.device"][0][0]


def test_short_clip_records_neither():
    _, logs, spans = _traced(*_signal(SHORT))
    assert any(m.startswith("Signal chain: host") for m in logs), logs
    assert "ff.signal_chain" in spans
    assert not set(SIGNAL_SPANS) & set(spans)


def test_long_clip_with_a_step_records_the_route_only():
    dots, cuts = _signal(LONG, step_at=LONG // 2)
    acts, logs, spans = _traced(dots, cuts)
    assert any(m.startswith("Signal chain: host") for m in logs), logs
    assert len(spans["ff.signal.route"]) == 1
    assert "ff.signal.device" not in spans
    host, _ = trun.compute_actions(dots, cuts, np.arange(LONG), FPS, FPS,
                                   Params(signal_backend="host"))
    assert acts == host


def test_device_chain_matches_the_plain_reference(long_clean, record_property):
    """The device chain on CPU tensors against the benchmark's float64
    reference chain, both read as piecewise-linear pos curves
    (``bench.correct.pos_gap``), as a long cell's ``correct`` reads them."""
    dots, cuts = long_clean
    acts, logs, _ = _traced(dots, cuts)
    assert any(m.startswith("Signal chain: device") for m in logs), logs
    p = Params()
    want = ref_signal.actions(dots, cuts, 1, FPS, FPS, p.detrend_window,
                              p.norm_window, p.keyframe_reduction)
    gap = correct.pos_gap(acts, want)
    record_property("pos_gap", gap)
    assert gap <= 0.5


def _drifting(n, drift, amp, seed=5):
    """A zoom-like oscillation riding on a steady drift, so that the
    integrated flow climbs to tens of thousands (an hour cell's clip read
    32,007 at its end); no cut."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    period = 30 * rng.uniform(0.6, 2.0)
    dots = drift + amp * np.sin(2 * np.pi * t / period) \
        + rng.normal(0, 0.05, n)
    return dots.astype(np.float32), np.zeros(n, bool)


@pytest.mark.parametrize("drift,amp", [(0.45, 2.0), (0.3, 0.3)])
def test_device_chain_holds_a_drifting_clip(drift, amp, record_property):
    """As above where the integrated flow drifts to about 21,000-31,500:
    the device chain runs in float64, where a float32 chain strays from
    the reference by 5.6-7.7 on these signals."""
    dots, cuts = _drifting(LONG, drift, amp)
    acts, logs, _ = _traced(dots, cuts)
    assert any(m.startswith("Signal chain: device") for m in logs), logs
    p = Params()
    want = ref_signal.actions(dots, cuts, 1, FPS, FPS, p.detrend_window,
                              p.norm_window, p.keyframe_reduction)
    gap = correct.pos_gap(acts, want)
    record_property("pos_gap", gap)
    assert gap <= 0.5
