"""The traced slice's arithmetic on a synthetic trace: busy and idle time
from intervals, launches per pair, idle gaps by host operation, and the
roofline share from bytes and operations, with launches replayed from
CUDA graphs."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from perfbench.bench import manifest, trace as tr
from perfbench.bench.cell import ClipRun, Ctx, LaunchLog, recorded_launches

# device events (name, start us, end us) in a window of 0-100 us: busy
# 10-30 (two overlapping kernels), 50-60 and 90-110 (clipped to 100)
DEVICE = [("poly_exp_kernel<5>", 10.0, 25.0), ("elementwise", 20.0, 30.0),
          ("warp_bilinear_kernel<5>", 50.0, 60.0), ("Memcpy DtoH", 90.0, 110.0)]
CPU = [(tr.WINDOW_SPAN, 0.0, 100.0), ("perfbench.clip", 1.0, 99.0),
       ("aten::mul", 32.0, 48.0), ("cudaLaunchKernel", 40.0, 41.0),
       ("cudaLaunchKernel", 45.0, 46.0), ("cudaMemcpyAsync", 85.0, 86.0),
       ("cudaLaunchKernel", 150.0, 151.0)]


def synthetic():
    return tr.Trace.from_events(DEVICE, CPU)


def test_busy_idle_and_device_time():
    t = synthetic()
    assert t.window == (0.0, 100.0) and t.window_s == pytest.approx(1e-4)
    a, b = t.busy_intervals()
    assert a.tolist() == [10.0, 50.0, 90.0] and b.tolist() == [30.0, 60.0, 100.0]
    assert t.busy_s() == pytest.approx(40e-6)
    assert t.device_time_s() == pytest.approx((15 + 10 + 10 + 10) * 1e-6)
    assert t.idle_share() == pytest.approx(60.0)


def test_launch_calls_count_the_window_only():
    assert synthetic().launch_calls() == 3


def test_gaps_and_their_names():
    t = synthetic()
    gs, ge = t.gaps()
    assert gs.tolist() == [0.0, 30.0, 60.0] and ge.tolist() == [10.0, 50.0, 90.0]
    # 0-10 and 60-90 fall inside the clip span only; 30-50's middle (40)
    # inside aten::mul (the runtime call is not a host op)
    assert t.idle_gaps() == [["perfbench.clip", pytest.approx(40e-6)],
                             ["aten::mul", pytest.approx(20e-6)]]


def test_device_ops_and_kernel_events():
    t = synthetic()
    ops = dict((n, s) for n, s in t.device_ops())
    assert ops["poly_exp_kernel<5>"] == pytest.approx(15e-6)
    assert ops["Memcpy DtoH"] == pytest.approx(10e-6)
    assert t.kernel_events("warp_bilinear_kernel") == [10.0]


def test_no_device_events():
    t = tr.Trace.from_events([], CPU)
    assert t.idle_share() is None and t.device_time_s() == 0.0


def test_roofline_from_bytes_and_operations():
    specs = {k["launch"]: k for k in manifest.kernels()}
    peaks = {"hbm_bytes_per_s": 1e12, "f32_ops_per_s": 1e12}
    # poly_exp at B=2, H=W=100: 24 B and 198 ops a pixel: ops-bound,
    # 2 * 1e4 * 198 / 1e12 s = 3.96 us; warp_bilinear at B=1, P=5,
    # 100x100: 48 B and 53 ops a pixel: ops-bound, 0.53 us
    launches = [("poly_exp", (0, 0, 2, 100, 100, 5, None, None)),
                ("warp_bilinear", (0, 0, 0, 0, 1, 5, 100, 100))]
    share = tr.roofline(synthetic(), [specs["poly_exp"], specs["warp_bilinear"]],
                        launches, peaks)
    assert share == pytest.approx(100 * (3.96 + 0.53) / (15 + 10))
    assert tr.launch_cost(specs["warp_bilinear"], launches[1][1]) == (48e4, 53e4)
    assert tr.launch_cost(specs["sample_patches"],
                          (0, 0, 0, 0, 2, 32, 32, 7, 7, 8, 4)) == \
        (4 * 2 * 49 * 64 + 8 * 2 * 49 + 4 * 2 * 32 * 32, 17 * 2 * 49 * 64)


def test_roofline_refuses_unpaired_launches():
    specs = [k for k in manifest.kernels() if k["launch"] == "poly_exp"]
    with pytest.raises(ValueError):
        tr.roofline(synthetic(), specs, [], {"hbm_bytes_per_s": 1.0,
                                             "f32_ops_per_s": 1.0})


def test_roofline_without_hand_kernels_is_none():
    t = tr.Trace.from_events([("elementwise", 0.0, 5.0)], CPU)
    assert tr.roofline(t, manifest.kernels(), [], manifest.peaks()) is None


def test_a_captured_launch_pairs_with_every_replay():
    """A launch captured into a CUDA graph runs once per replay: replayed
    three times, it pairs with three device events."""
    spec = [k for k in manifest.kernels() if k["launch"] == "poly_exp"]
    peaks = {"hbm_bytes_per_s": 1e12, "f32_ops_per_s": 1e12}
    args = (0, 0, 1, 100, 100, 5, None, None)   # 1.98 us bound
    log = LaunchLog()
    log.launch("poly_exp", args)                # a direct launch
    graph = object()
    log.capture_begin(graph)
    log.launch("poly_exp", args)                # captured: runs on replay
    log.capture_end(graph)
    log.launches.clear()                        # the slice starts here
    for _ in range(3):
        log.replay(graph)
    assert log.launches == [("poly_exp", args)] * 3
    events = [("poly_exp_kernel<5>", 10.0 * k, 10.0 * k + 4.0)
              for k in range(3)]
    t = tr.Trace.from_events(events, [(tr.WINDOW_SPAN, 0.0, 100.0)])
    assert tr.roofline(t, spec, log.launches, peaks) == \
        pytest.approx(100 * 3 * 1.98 / 12)
    # without the replays the events would not pair up
    with pytest.raises(ValueError):
        tr.roofline(t, spec, log.launches[:1], peaks)


def test_recorded_launches_wraps_and_restores_graphs(monkeypatch):
    """The CUDA graph methods are wrapped while recording, each call noted
    before the graph's own, and restored after."""
    calls = []

    class Graph:
        def capture_begin(self, *args, **kw):
            calls.append(("begin", args, kw))

        def capture_end(self):
            calls.append(("end",))

        def replay(self):
            calls.append(("replay",))

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    before = dict(Graph.__dict__)
    log = LaunchLog()
    with recorded_launches(log):
        g = Graph()
        g.capture_begin(None, capture_error_mode="global")
        log.launch("warp_planes", (1, 2))
        g.capture_end()
        g.replay()
        g.replay()
    assert calls == [("begin", (None,), {"capture_error_mode": "global"}),
                     ("end",), ("replay",), ("replay",)]
    assert log.launches == [("warp_planes", (1, 2))] * 2
    assert dict(Graph.__dict__) == before


def test_recorded_launches_restores_every_wrapper_module():
    """The wrappers' modules are imported before ``launch`` is stood in
    for, so none binds the stand-in, and all get the original back."""
    import importlib
    import pkgutil

    from funscript_flow_tpu_torch.ops import cuda as kernels
    from funscript_flow_tpu_torch.ops.cuda import _build

    orig = _build.launch
    with recorded_launches(LaunchLog()):
        mods = [importlib.import_module(f"{kernels.__name__}.{i.name}")
                for i in pkgutil.iter_modules(kernels.__path__)]
        users = [m for m in mods if hasattr(m, "launch")]
        assert len(users) >= 4 and all(m.launch is not orig for m in users)
    assert all(m.launch is orig for m in users)


@pytest.mark.cuda
def test_graph_replays_pair_with_their_events_on_the_card(cuda):
    """A hand kernel captured into a CUDA graph and replayed three times,
    beside one direct launch, traced: four device events, four launches."""
    from torch.profiler import ProfilerActivity, profile

    from funscript_flow_tpu_torch.ops.cuda import polyexp

    img = torch.rand((2, 64, 64), device=cuda)
    log = LaunchLog()
    with recorded_launches(log):
        polyexp.poly_exp(img)                   # loads the library
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            polyexp.poly_exp(img)
        torch.cuda.synchronize()
        log.launches.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(tr.WINDOW_SPAN):
                polyexp.poly_exp(img)
                for _ in range(3):
                    graph.replay()
                torch.cuda.synchronize()
    t = tr.from_profiler(prof)
    spec = [k for k in manifest.kernels() if k["launch"] == "poly_exp"]
    assert len(t.kernel_events(spec[0]["trace_name"])) == 4
    assert len(log.launches) == 4
    share = tr.roofline(t, spec, log.launches, manifest.peaks())
    assert 0 < share <= 105


def clip(pairs, windows):
    spec = SimpleNamespace(index=0)
    logs = [f"Flow windows dispatched: {windows} ({pairs} pairs)"]
    return ClipRun(spec=spec, frames=pairs + 1, funscript="", wall=1.0,
                   err=False, logs=logs)


def test_metric_readers_on_a_synthetic_slice():
    sliced = [clip(899, 6), clip(1101, 7)]
    ctx = Ctx(clips=sliced, trace=synthetic(),
              window_clips=sliced + [clip(1000, 4)], kernels=[], launches=[],
              peaks=manifest.peaks())
    read = {m["name"].rsplit(".", 1)[0]: manifest.reader(m["name"])
            for m in manifest.benchmark()["per_layer"]}
    # the counter reads every clip of the window, the trace's metrics the
    # slice's pairs
    assert read["streaming.windows_per_kpair"](ctx) == pytest.approx(17 / 3)
    assert read["flow.device_us_per_pair"](ctx) == pytest.approx(45e-6 * 1e6 / 2000)
    assert read["flow.host_launches_per_pair"](ctx) == pytest.approx(3 / 2000)
    assert read["device.idle_share"](ctx) == pytest.approx(60.0)
    # kernels named in the trace but no recorded launches: refused
    with pytest.raises(ValueError):
        read["kernels.roofline_share"](
            Ctx(clips=ctx.clips, trace=ctx.trace, kernels=manifest.kernels(),
                launches=[], peaks=ctx.peaks))
    empty = Ctx(clips=[], trace=None)
    assert all(r(empty) is None for r in read.values())
    assert not math.isnan(read["device.idle_share"](ctx))
