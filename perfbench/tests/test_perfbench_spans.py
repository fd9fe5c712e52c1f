"""The readers of the program's spans (``bench.spans`` and the six
``metrics/*`` files of host time and host syncs) on a synthetic slice,
and on a traced run of a tiny cell on the CPU."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench.bench import cell as cellmod, manifest, spans, trace as tr
from perfbench.bench.cell import ClipRun, Ctx

from conftest import SEED, tiny_cell

QUANTITIES = ("runner.host_us_per_pair", "streaming.upload_us_per_pair",
              "streaming.wait_us_per_pair", "flow.host_us_per_pair",
              "flow.host_syncs_per_window", "signal.host_us_per_pair")
CELLS = [w["name"] for w in manifest.benchmark()["workloads"]]

# two clips in a window of 0-1000 us, as the program records them: clip A
# (100 pairs, two windows) 10-410, clip B (60 pairs, one window) 500-700;
# runtime calls beside them, some of them synchronising
CPU = [
    (tr.WINDOW_SPAN, 0.0, 1000.0),
    ("perfbench.clip", 5.0, 415.0), ("ff.clip", 10.0, 410.0),
    ("ff.clip.setup", 10.0, 30.0),
    ("ff.decode_wait", 30.0, 40.0), ("perfbench.frames", 31.0, 39.0),
    ("ff.window.upload", 40.0, 50.0), ("cudaMemcpyAsync", 45.0, 46.0),
    ("ff.window.program", 50.0, 100.0),
    ("cudaStreamSynchronize", 60.0, 61.0),
    ("cudaStreamSynchronize", 70.0, 71.0), ("cudaLaunchKernel", 80.0, 81.0),
    ("ff.window.wait", 100.0, 150.0), ("cudaMemcpyAsync", 101.0, 102.0),
    ("cudaStreamSynchronize", 102.0, 149.0),
    ("ff.decode_wait", 150.0, 160.0),
    ("ff.window.upload", 160.0, 170.0),
    ("ff.window.program", 170.0, 220.0),
    ("cudaStreamSynchronize", 175.0, 176.0),
    ("ff.window.wait", 220.0, 260.0),
    ("cudaStreamSynchronize", 221.0, 259.0),
    ("perfbench.signal_chain", 295.0, 385.0),
    ("ff.signal_chain", 300.0, 380.0),
    ("cudaStreamSynchronize", 310.0, 311.0),   # not in a window span
    ("ff.clip.write", 385.0, 395.0),
    ("perfbench.clip", 495.0, 705.0), ("ff.clip", 500.0, 700.0),
    ("ff.clip.setup", 500.0, 510.0), ("ff.decode_wait", 510.0, 530.0),
    ("ff.window.upload", 530.0, 540.0),
    ("ff.window.program", 540.0, 600.0),
    ("cudaEventSynchronize", 550.0, 551.0), ("cudaMemcpy", 560.0, 561.0),
    ("ff.window.wait", 600.0, 650.0),
    ("cudaStreamSynchronize", 601.0, 649.0),
    ("ff.signal_chain", 660.0, 690.0), ("ff.clip.write", 690.0, 698.0),
    # after the window: not read
    ("ff.window.upload", 1200.0, 1210.0),
    ("cudaStreamSynchronize", 1205.0, 1206.0),
]
DEVICE = [("kernel", 55.0, 90.0), ("kernel", 180.0, 215.0)]
PAIRS, WINDOWS = 160, 3


def clip(pairs, windows):
    logs = [f"Flow windows dispatched: {windows} ({pairs} pairs)"]
    return ClipRun(spec=SimpleNamespace(index=0), frames=pairs + 1,
                   funscript="", wall=1.0, err=False, logs=logs)


def ctx_of(cpu, device=DEVICE):
    clips = [clip(100, 2), clip(60, 1)]
    return Ctx(clips=clips, trace=tr.Trace.from_events(device, cpu),
               window_clips=clips)


def readers():
    return {q: manifest.reader(q) for q in QUANTITIES}


def test_each_reader_on_a_synthetic_slice():
    read = readers()
    ctx = ctx_of(CPU)
    got = {q: read[q](ctx) for q in QUANTITIES}
    assert got == {
        # clip A 400 us less its children 310, clip B 200 less 170
        "runner.host_us_per_pair": pytest.approx((90 + 30) / PAIRS),
        "streaming.upload_us_per_pair": pytest.approx((10 + 10 + 10) / PAIRS),
        "streaming.wait_us_per_pair": pytest.approx((50 + 40 + 50) / PAIRS),
        "flow.host_us_per_pair": pytest.approx((50 + 50 + 60) / PAIRS),
        # five syncs in clip A's window spans, three in clip B's
        "flow.host_syncs_per_window": pytest.approx(8 / WINDOWS),
        "signal.host_us_per_pair": pytest.approx((80 + 30) / PAIRS),
    }
    # with the decode wait, the five host metrics account for the clips
    decode = spans.us_per_pair(ctx, "ff.decode_wait")
    assert decode == pytest.approx(40 / PAIRS)
    total = sum(v for q, v in got.items() if q.endswith("us_per_pair"))
    assert total + decode == pytest.approx((400 + 200) / PAIRS)


def test_self_time_subtracts_the_union_of_children():
    cpu = [(tr.WINDOW_SPAN, 0.0, 1000.0), ("ff.clip", 0.0, 100.0),
           # overlapping children count once; a child past the clip's end
           # counts only inside it; one after the clip not at all
           ("ff.window.program", 10.0, 30.0), ("ff.window.wait", 20.0, 40.0),
           ("ff.signal_chain", 90.0, 120.0), ("ff.decode_wait", 200.0, 210.0),
           # not a child: the runner's own
           ("ff.clip.setup", 0.0, 5.0)]
    t = tr.Trace.from_events([], cpu)
    assert spans.self_us(t, spans.CLIP, spans.CLIP_CHILDREN) == \
        pytest.approx(100 - 30 - 10)
    assert spans.self_us(t, "ff.no_such_span", spans.CLIP_CHILDREN) is None


def test_syncs_count_inside_window_spans_only():
    t = tr.Trace.from_events([], CPU)
    assert spans.calls_inside(t, spans.SYNC_CALLS, spans.WINDOW) == 8
    assert spans.calls_inside(t, {"cudaLaunchKernel"}, spans.WINDOW) == 1
    assert spans.calls_inside(t, spans.SYNC_CALLS, "ff.signal_chain") == 1


def test_no_sync_in_the_spans_reads_zero():
    cpu = [row for row in CPU if row[0] not in spans.SYNC_CALLS]
    assert readers()["flow.host_syncs_per_window"](ctx_of(cpu)) == 0.0


def test_no_span_reads_nothing():
    """A program that records no span of its own (as before it had them)
    leaves every reader with nothing to read, and none raises."""
    cpu = [row for row in CPU if not row[0].startswith("ff.")]
    read = readers()
    assert all(read[q](ctx_of(cpu)) is None for q in QUANTITIES)
    empty = Ctx(clips=[], trace=None)
    assert all(read[q](empty) is None for q in QUANTITIES)


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_each_metric_resolves_to_its_reader(quantity):
    bench = manifest.benchmark()
    entries = [m for m in bench["per_layer"]
               if m["name"].rsplit(".", 1)[0] == quantity]
    assert sorted(m["name"].rsplit(".", 1)[1] for m in entries) == \
        ["dis", "farneback"]
    for m in entries:
        alg = m["name"].rsplit(".", 1)[1]
        assert m["moves"] == f"pairs_per_s.{alg}"
        assert m["better"] == "lower" and m["source"] == "device_trace"
        assert manifest.reader(m["name"]).__module__ == \
            manifest.reader(quantity).__module__
        (cell,) = m["workloads"]
        assert manifest.cell(cell).config_name.startswith(
            "dis" if alg == "dis" else "farneback")


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_every_span_metric(name):
    """A traced run of a tiny cell on the CPU: the program's spans reach the
    harness's trace, and each new metric of the cell reads a number (no
    CUDA runtime call on the CPU: no sync)."""
    res = cellmod.run(tiny_cell(name), SEED, 0.01, True, device="cpu")
    assert res["correct"], res["checks"]
    metrics = res["metrics"]
    mine = {m["name"].rsplit(".", 1)[0]: m["name"]
            for m in manifest.cell(name).per_layer
            if m["name"].rsplit(".", 1)[0] in QUANTITIES}
    assert sorted(mine) == sorted(QUANTITIES)
    for q, full in mine.items():
        assert full in metrics, (full, sorted(metrics))
    assert metrics[mine["flow.host_syncs_per_window"]]["value"] == 0.0
    for q in QUANTITIES:
        if q.endswith("us_per_pair"):
            assert metrics[mine[q]]["value"] > 0, q
