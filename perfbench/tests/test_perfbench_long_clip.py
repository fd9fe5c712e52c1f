"""The cells of whole clips at both ends of their length, ``hour`` and
``shorts``: their traffic files, the metrics they report, the warm-up that
covers their window shapes, and the three readers of the long-clip signal
chain (``signal.device_chain_share``, ``signal.route_us_per_pair``,
``signal.device_us_per_pair``) on synthetic logs and traces."""

from __future__ import annotations

from collections import Counter
from types import SimpleNamespace

import pytest

from perfbench.bench import manifest, trace as tr, traffic as trafmod
from perfbench.bench.cell import ClipRun, Ctx

HOUR, SHORTS = "farneback-default.hour", "farneback-default.shorts"
NEW = ("signal.device_chain_share.farneback",
       "signal.route_us_per_pair.farneback",
       "signal.device_us_per_pair.farneback")
BENCH = manifest.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_traffic_files_load_by_name():
    hour, shorts = manifest.cell(HOUR), manifest.cell(SHORTS)
    assert hour.traffic_name == "hour" and shorts.traffic_name == "shorts"
    assert trafmod.block_lengths(hour.traffic) == [72001]
    assert trafmod.block_lengths(shorts.traffic) == [188, 294, 460, 719]
    mixed = manifest.cell("farneback-default.mixed").traffic
    for t in (hour.traffic, shorts.traffic):
        assert t["source"] == "generated" and t["fps"] == 30.0
        assert t["size"] == [256, 256]
        for key in ("period_s", "amplitude", "textures", "scale_levels"):
            assert t[key] == mixed[key], key
    assert shorts.traffic["cut_share"] == mixed["cut_share"]


def test_hour_clips_reach_the_device_chain_and_shorts_do_not():
    from funscript_flow_tpu_torch.runner import AUTO_DEVICE_MIN_SAMPLES

    (n,) = trafmod.block_lengths(manifest.cell(HOUR).traffic)
    assert n - 1 >= AUTO_DEVICE_MIN_SAMPLES
    assert all(m - 1 < AUTO_DEVICE_MIN_SAMPLES for m in
               trafmod.block_lengths(manifest.cell(SHORTS).traffic))


def test_the_hour_configuration_is_the_default_one():
    """Nothing of the program's settings is cut or changed for the hour:
    its configuration runs the same ``Params`` and limits as
    ``farneback-default``."""
    hour = manifest.cell(HOUR).config
    default = manifest.cell("farneback-default.mixed").config
    assert hour["params"] == default["params"]
    assert hour["correct_limits"] == default["correct_limits"]
    assert hour["reduced"] == []


@pytest.mark.parametrize("name", [HOUR, SHORTS])
def test_new_cells_report_the_farneback_metrics(name):
    cell = manifest.cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == \
        {"pairs_per_s.farneback", "setup_s"}
    farneback = {m["name"] for m in BENCH["per_layer"]
                 if m["name"].endswith(".farneback") and m["name"] not in NEW}
    mine = {m["name"] for m in cell.per_layer}
    assert farneback <= mine
    assert (set(NEW) & mine) == (set(NEW) if name == HOUR else set())


def test_new_metrics_entries():
    entries = {m["name"]: m for m in BENCH["per_layer"] if m["name"] in NEW}
    assert sorted(entries) == sorted(NEW)
    layer = {m["layer"] for m in BENCH["per_layer"]
             if m["name"].startswith("signal.host_us_per_pair")}
    for name, m in entries.items():
        assert m["workloads"] == [HOUR]
        assert m["moves"] == "pairs_per_s.farneback"
        assert {m["layer"]} == layer
        assert callable(manifest.reader(name))
    assert entries[NEW[0]]["unit"] == "%" and entries[NEW[0]]["better"] == "higher"
    assert entries[NEW[0]]["source"] == "program_counter"
    for name in NEW[1:]:
        assert entries[name]["unit"] == "us/pair"
        assert entries[name]["better"] == "lower"
        assert entries[name]["source"] == "device_trace"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_listed_cell_runs_the_metrics_algorithm(metric):
    """A metric split by algorithm lists only cells whose configuration
    runs that algorithm, however many it lists."""
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    alg = metric.rsplit(".", 1)[1]
    assert m["moves"] == f"pairs_per_s.{alg}"
    backend = {"farneback": "CUDA", "dis": "DIS"}[alg]
    for name in m["workloads"]:
        assert manifest.cell(name).config["params"]["backend"] == backend


def _shapes(frames: int) -> Counter:
    """The window buckets the streaming analyzer dispatches for a clip of
    ``frames`` frames, pulled as the runner pulls them (the flow program
    not run)."""
    from funscript_flow_tpu_torch.models.pipeline import (
        PipelineConfig, StreamingFlowAnalyzer)

    class Shapes(StreamingFlowAnalyzer):
        def _dispatch(self, e, n_total):
            self.seen[self._tail_bucket(e - self._s)] += 1
            self.windows_dispatched += 1
            self._s = e
            drop = max(0, (self._s - self.radius) - self._base)
            del self._buf[:drop]
            self._base += drop

        def _drain(self, keep):
            return []

    a = Shapes(PipelineConfig(), device="cpu", n_pairs_total=frames - 1)
    a.seen = Counter()
    pull, done = a.ramp_pairs + a.radius + 1, 0
    while done < frames:
        n = min(pull, frames - done)
        a.push([None] * n)
        done, pull = done + n, a.cfg.pair_batch
    a.flush()
    return a.seen


@pytest.mark.parametrize("name", CELLS)
def test_warm_up_covers_every_window_shape(name):
    t = manifest.cell(name).traffic
    warm = set()
    for n in t["warmup_frames"]:
        warm |= set(_shapes(n))
    for n in trafmod.block_lengths(t):
        assert set(_shapes(n)) <= warm, (n, _shapes(n), warm)


def test_hour_windows_are_nearly_all_full():
    (n,) = trafmod.block_lengths(manifest.cell(HOUR).traffic)
    shapes = _shapes(n)
    assert shapes == {30: 2, 60: 1, 120: 1, 240: 299}
    assert 1000 * sum(shapes.values()) / (n - 1) == pytest.approx(4.2083, abs=1e-4)


# ---------------------------------------------------------------- readers

def clip(pairs, *lines):
    logs = [f"Flow windows dispatched: {max(1, pairs // 240)} ({pairs} pairs)",
            *lines]
    return ClipRun(spec=SimpleNamespace(index=0), frames=pairs + 1,
                   funscript="", wall=1.0, err=False, logs=logs)


DEVICE = "Signal chain: device (72000 samples on cuda:0)."
HOST = "Signal chain: host (1000 samples)."


def test_device_chain_share():
    read = manifest.reader(NEW[0])
    window = [clip(72000, DEVICE), clip(1000, HOST), clip(72000, DEVICE)]
    # traced or not: every clip of the window counts
    ctx = Ctx(clips=window[:1], trace=None, window_clips=window)
    assert read(ctx) == pytest.approx(100.0 * 144000 / 145000)
    assert read(Ctx(clips=[], trace=None, window_clips=window[::2])) == 100.0
    assert read(Ctx(clips=[], trace=None, window_clips=[clip(1000, HOST)])) == 0.0
    # no clip logs its route: nothing to read
    assert read(Ctx(clips=[], trace=None, window_clips=[clip(1000)])) is None
    assert read(Ctx(clips=[], trace=None)) is None


# one long clip (1,000 pairs) with both spans, one short clip (200 pairs)
# with neither, in a window of 0-1000 us
CPU = [
    (tr.WINDOW_SPAN, 0.0, 1000.0),
    ("ff.clip", 10.0, 600.0), ("ff.signal_chain", 400.0, 590.0),
    ("ff.signal.route", 405.0, 505.0), ("ff.signal.device", 506.0, 586.0),
    ("cudaMemcpyAsync", 580.0, 581.0),
    ("ff.clip", 650.0, 900.0), ("ff.signal_chain", 850.0, 890.0),
    # after the window: not read
    ("ff.signal.route", 1100.0, 1300.0),
]


def span_ctx(cpu):
    clips = [clip(1000, DEVICE), clip(200, HOST)]
    return Ctx(clips=clips, trace=tr.Trace.from_events([], cpu),
               window_clips=clips)


def test_route_and_device_span_readers():
    route, device = (manifest.reader(n) for n in NEW[1:])
    ctx = span_ctx(CPU)
    assert route(ctx) == pytest.approx(100.0 / 1200)
    assert device(ctx) == pytest.approx(80.0 / 1200)


def test_span_readers_read_nothing_without_their_span():
    """A program without the spans (the parent of this cell) or a slice
    of short clips only: nothing to read, and no reader raises."""
    cpu = [row for row in CPU if not row[0].startswith("ff.signal.")]
    for name in NEW[1:]:
        read = manifest.reader(name)
        assert read(span_ctx(cpu)) is None
        assert read(Ctx(clips=[], trace=None)) is None
