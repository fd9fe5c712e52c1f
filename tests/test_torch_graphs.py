"""The flow program through CUDA graphs (``models.pipeline.WindowGraphs``).

On the CPU: the valid-pair count as a 0-d tensor (a graph's static input)
gives the int form's results bit for bit, DIS's patch-centre tables are
the former host-built ones, graphed launches are counted apart, the CPU
path stays eager (a CPU mesh's too), a lease drops the idle graphs of other
configurations, a graph whose run raised is dropped, and the drain waits
on each window's copy-back event once, in order, and hands out copies.
On a card (the ``cuda`` marker; skipped without one): graphed windows
equal the eager program bit for bit for both flow algorithms and every
window bucket, their outputs land in pinned host memory, one
configuration's graphs share one pool, pending windows do not alias, a
drain returns while the next window's work still runs, threads on
streams of their own get graphs of their own, a replay counts the eager
program's launches, and another configuration's lease gives the first
one's memory back to the card.

This file imports nothing of JAX, so on a machine without it the card's
cases run with ``python -m pytest --noconftest tests/test_torch_graphs.py``.
"""

import threading

import numpy as np
import pytest
import torch

from funscript_flow_tpu_torch.models import dis as tdis
from funscript_flow_tpu_torch.models import pipeline
from funscript_flow_tpu_torch.models.pipeline import (
    KEYS, FlowAnalyzer, PipelineConfig, StreamingFlowAnalyzer, WindowGraphs,
    flow_chunk_program)
from funscript_flow_tpu_torch.ops import cuda as kcuda
from funscript_flow_tpu_torch.ops.cuda import _build
from funscript_flow_tpu_torch.ops.reductions import (CENTER_SMOOTH_RADIUS,
                                                     smooth_centers)
from funscript_flow_tpu_torch.parallel.mesh import make_mesh

# the tests run in several worker processes at once: one torch thread
# each keeps them from oversubscribing the cores
torch.set_num_threads(1)

R = CENTER_SMOOTH_RADIUS
BUCKETS = (240, 120, 60, 30)  # the window buckets of pair_batch 240


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: float32 compared as its bits, so that the NaN
    centres of padding pairs (an empty smoothing window) compare equal."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def moving_frames(n: int, size: int, seed: int) -> np.ndarray:
    """[n, size, size] uint8: a smoothed noise texture shifted by one or
    two pixels a frame."""
    rng = np.random.default_rng(seed)
    base = rng.random((size, size))
    for ax in (0, 1):  # a little smoothing, so that the flow has gradients
        base = (base + np.roll(base, 1, ax) + np.roll(base, -1, ax)) / 3
    base = (base * 255).astype(np.uint8)
    return np.stack([np.roll(base, (i, 2 * i), axis=(0, 1))
                     for i in range(n)])


# ------------------------------------------------------------------ CPU


@pytest.mark.parametrize("n_valid", [1, 7, 36, 246, 252])
def test_tensor_n_valid_equals_int(n_valid):
    """``smooth_centers`` and the program's ``valid`` mask with a 0-d
    tensor ``n_valid`` are bitwise the int form, on a B = 252 window."""
    B = 252
    g = torch.Generator().manual_seed(n_valid)
    centers = torch.rand((B, 2), generator=g) * 255
    nv = torch.tensor(n_valid, dtype=torch.int64)
    assert same_bits(smooth_centers(centers, nv),
                     smooth_centers(centers, n_valid))
    frames = torch.from_numpy(moving_frames(B + 1, 32, seed=n_valid))
    cfg = PipelineConfig(pair_batch=B - 2 * R)
    want = flow_chunk_program(frames, n_valid, cfg)
    got = flow_chunk_program(frames, nv, cfg)
    assert set(got) == set(want)
    for k in want:
        assert same_bits(got[k], want[k]), k
    assert not want["dots"][n_valid:].any()


@pytest.mark.parametrize("n,stride,ps", [(15, 4, 8), (7, 4, 8), (40, 3, 8),
                                         (1, 4, 8), (9, 2, 5)])
def test_dis_patch_centres_table(n, stride, ps):
    """The cached patch-centre tables are the former host-built
    ``np.arange(n) * stride + ps // 2``, built once per device."""
    got = tdis._patch_centres(n, stride, ps, torch.device("cpu"))
    want = torch.from_numpy(np.arange(n) * stride + ps // 2)
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)
    assert tdis._patch_centres(n, stride, ps, torch.device("cpu")) is got


def test_captured_launches_are_counted_apart():
    """Launches counted while a thread captures go to the graph's tally,
    not to ``launch_counts()``; another thread's launches meanwhile count
    as usual; ``add_launches`` adds a tally once per replay."""
    kcuda.reset_launches()
    with _build.captured_launches() as tally:
        _build.count_launch("poly_exp")
        _build.count_launch("poly_exp")
        other = threading.Thread(
            target=_build.count_launch, args=("warp_bilinear",))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    assert tally == {"poly_exp": 2}
    assert kcuda.launch_counts()["poly_exp"] == 0
    assert kcuda.launch_counts()["warp_bilinear"] == 1
    _build.count_launch("poly_exp")  # outside the capture: counted
    _build.add_launches(tally)
    _build.add_launches(tally)
    assert kcuda.launch_counts()["poly_exp"] == 5
    kcuda.reset_launches()


@pytest.mark.parametrize("where", ["cpu", "mesh"])
def test_cpu_and_mesh_stay_eager(where, monkeypatch):
    """On the CPU and over a (CPU) mesh the analyzer takes the eager path:
    no graph is leased, and its counts say so."""
    def no_graphs(*a, **kw):
        raise AssertionError("a graph was leased off the CUDA path")

    monkeypatch.setattr(WindowGraphs, "lease", no_graphs)
    frames = moving_frames(75, 32, seed=3)
    cfg = PipelineConfig(pair_batch=16)
    kw = ({"device": "cpu"} if where == "cpu"
          else {"mesh": make_mesh(2, device="cpu")})
    an = StreamingFlowAnalyzer(cfg, **kw)
    assert an._graphs is None
    results = []
    for i in range(0, len(frames), 20):
        results.extend(an.push(list(frames[i: i + 20])))
    results.extend(an.flush())
    want = FlowAnalyzer(cfg, device="cpu").analyze_video_pairs(frames)
    for k in KEYS:
        got = np.concatenate([r[k] for r in results])
        np.testing.assert_array_equal(got, want[k], err_msg=k)
    assert an.windows_dispatched > 0
    assert an.windows_replayed == 0 and an.graphs_captured == 0


class _Stream:
    """A stand-in for a CUDA stream: records what it was asked to do."""

    def __init__(self):
        self.waited, self.synced = [], 0

    def wait_stream(self, other):
        self.waited.append(other)

    def synchronize(self):
        self.synced += 1


def test_lease_drops_other_configurations(monkeypatch):
    """A lease of one configuration drops the idle sets of every other
    configuration on its device (after their last work) and empties the
    allocator's cache once; sets that are leased, and sets on another
    device, stay. A set leased from another stream waits for the last."""
    streams = {0: _Stream(), 1: _Stream()}
    cur = {"s": streams[0]}
    emptied = []
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: cur["s"])
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: emptied.append(1))
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    a, b = PipelineConfig(), PipelineConfig(cut_threshold=5.0)
    graphs = WindowGraphs()

    set_a = graphs.lease(a, d0)
    set_a.graphs[(253, 256, 256)] = "graph"  # stands for a capture
    busy_a = graphs.lease(a, d0)   # leased meanwhile: not dropped
    far_a = graphs.lease(a, d1)    # another device: not dropped
    assert len({id(set_a), id(busy_a), id(far_a)}) == 3
    graphs.release(set_a)
    graphs.release(far_a)
    assert graphs.lease(a, d0) is set_a and not emptied  # same config: kept
    graphs.release(set_a)

    cur["s"] = streams[1]
    set_b = graphs.lease(b, d0)
    assert set_a.graphs == {} and set_a.pool is None
    assert streams[0].synced == 1  # set_a's last work, before the drop
    assert emptied == [1]
    assert busy_a.stream is streams[0]
    assert len(graphs) == 1  # far_a
    graphs.release(set_b)
    graphs.release(busy_a)
    again = graphs.lease(b, d0)  # busy_a, now idle, is dropped
    assert again is set_b and emptied == [1, 1]
    assert streams[1].waited == []  # set_b ran on this stream last
    graphs.release(again)
    assert graphs.lease(a, d1) is far_a
    assert streams[1].waited == [streams[0]]  # far_a ran on stream 0


def test_failed_run_drops_the_graph():
    """A graph whose capture or replay raised leaves its set: the next
    window of its shape builds and captures a new one."""
    class Failing:
        def run(self, n_valid, pool, side):
            raise RuntimeError("capture failed")

    gset = pipeline._GraphSet(None, PipelineConfig(), torch.device("cpu"))
    gset._side = "side"
    bad, good = Failing(), object()
    gset.graphs = {(73, 8, 8): bad, (43, 8, 8): good}
    with pytest.raises(RuntimeError, match="capture failed"):
        gset.run(bad, 5)
    assert gset.graphs == {(43, 8, 8): good}
    assert gset.pool is None


class _Event:
    """A stand-in for a window's copy-back event: logs each wait and
    gives the window's host buffers back to their ring."""

    def __init__(self, window, log, ring, buf):
        self.window, self.log, self.ring, self.buf = window, log, ring, buf

    def synchronize(self):
        self.log.append(self.window)
        self.ring.append(self.buf)


class _RingSet:
    """A stand-in graph set on the CPU: runs the program eagerly and puts
    each window's outputs into host buffers from a ring, which a window's
    event gives back once waited on, as the caching host allocator does
    with a drained window's pinned buffers."""

    def __init__(self, cfg):
        self.cfg, self.log, self.ring, self.windows = cfg, [], [], 0

    def load(self, host):
        return host

    def run(self, frames, n_valid):
        res = flow_chunk_program(frames, n_valid, self.cfg)
        buf = (self.ring.pop(0) if self.ring
               else {k: torch.empty_like(res[k]) for k in KEYS})
        for k in KEYS:
            buf[k].copy_(res[k])
        event = _Event(self.windows, self.log, self.ring, buf)
        self.windows += 1
        return buf, event, True


class _OneSet:
    """A stand-in for the process's graphs that leases one set."""

    def __init__(self, gset):
        self.gset, self.released = gset, 0

    def lease(self, cfg, device):
        return self.gset

    def release(self, gset):
        assert gset is self.gset
        self.released += 1


@pytest.mark.parametrize("n_frames,total", [(75, True), (75, False),
                                            (130, True)])
def test_drain_waits_on_each_event_once(n_frames, total, monkeypatch):
    """The graph path's drain waits on each window's copy-back event
    exactly once, in dispatch order, copies nothing back itself (no
    ``.cpu()``, no stream or device sync) and hands out arrays that keep
    their window's values after later windows reuse its buffers: the
    clip equals the eager program's bit for bit."""
    frames = moving_frames(n_frames, 32, seed=n_frames)
    cfg = PipelineConfig(pair_batch=16)
    want = FlowAnalyzer(cfg, device="cpu").analyze_video_pairs(frames)
    gset = _RingSet(cfg)
    an = StreamingFlowAnalyzer(
        cfg, device="cpu", n_pairs_total=n_frames - 1 if total else None)
    an._graphs = _OneSet(gset)
    stage = pipeline.stage_window
    monkeypatch.setattr(pipeline, "stage_window",  # no pinned memory here
                        lambda views, need, pin: stage(views, need, False))

    def no_sync(*a, **kw):
        raise AssertionError("the drain copied back or synchronised")

    monkeypatch.setattr(torch.Tensor, "cpu", no_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.cuda, "current_stream", no_sync)
    results = []
    for i in range(0, len(frames), 20):
        results.extend(an.push(list(frames[i: i + 20])))
        assert len(gset.log) == max(0, gset.windows - 1)  # one pending
    first = {k: results[0][k].copy() for k in KEYS}
    results.extend(an.flush())
    monkeypatch.undo()
    assert gset.windows == an.windows_dispatched > 2
    assert gset.log == list(range(gset.windows))
    assert len(gset.ring) < gset.windows  # buffers were reused
    assert an.windows_replayed == an.windows_dispatched
    assert an._graphs.released == 1
    for k in KEYS:
        np.testing.assert_array_equal(results[0][k], first[k], err_msg=k)
        got = np.concatenate([r[k] for r in results])
        np.testing.assert_array_equal(got, want[k], err_msg=k)


class _ListSource:
    def __init__(self, frames):
        self._frames, self._i = list(frames), 0

    def get_batch(self, n):
        out = self._frames[self._i: self._i + n]
        self._i += len(out)
        return out

    def close(self):
        pass


def test_runner_logs_the_graph_count(tmp_path):
    """``process_video`` logs, beside the window count, how many windows
    replayed a graph and how many graphs were captured: none on the CPU."""
    from funscript_flow_tpu_torch.io.decode import VideoMeta
    from funscript_flow_tpu_torch.runner import process_video
    from funscript_flow_tpu_torch.utils.params import Params

    frames = moving_frames(60, 32, seed=9)
    logs = []
    meta = VideoMeta(total_frames=len(frames), fps=30.0, width=32, height=32)
    err = process_video(str(tmp_path / "clip.mp4"),
                        Params(overwrite=True, pair_batch=16), logs.append,
                        preopened=(meta, _ListSource(frames)), device="cpu")
    assert not err, logs
    windows = [m for m in logs if m.startswith("Flow windows dispatched: ")]
    graphs = [m for m in logs if m.startswith("Flow graphs: ")]
    assert len(windows) == len(graphs) == 1
    n = int(windows[0].split(": ")[1].split(" ")[0])
    assert n > 1
    assert graphs[0] == f"Flow graphs: 0 of {n} windows replayed (0 captured)"


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs of the flow program)")
    return torch.device("cuda", 0)


def _window(gset, frames: np.ndarray, n_valid: int):
    """One window through the leased set ``gset``: copy in, run, wait for
    its copy-back; (its outputs in pinned host memory, whether a graph
    was replayed)."""
    host, event, replayed = gset.run(
        gset.load(torch.from_numpy(frames).pin_memory()), n_valid)
    event.synchronize()
    assert all(host[k].is_pinned() for k in KEYS)
    return host, replayed


def _eager(frames: np.ndarray, n_valid: int, cfg, dev) -> dict:
    res = flow_chunk_program(torch.from_numpy(frames).to(dev), n_valid, cfg)
    return {k: res[k] for k in KEYS}


def _assert_equal(got: dict, want: dict, what: str) -> None:
    for k in KEYS:
        assert same_bits(got[k].cpu(), want[k].cpu()), f"{what}: {k} differs"


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["farneback", "dis"])
def test_graphed_equals_eager(cuda_device, algorithm):
    """Every bucket: the first window runs eagerly and is captured, later
    windows replay; each window's outputs equal the eager program's bit
    for bit, a tail ``n_valid`` never seen at capture included."""
    cfg = PipelineConfig(flow_algorithm=algorithm)
    graphs = WindowGraphs()
    gset = graphs.lease(cfg, cuda_device)
    for b in BUCKETS:
        need = b + 2 * R + 1
        clip = moving_frames(need + 8, 256, seed=b)
        runs = [(clip[:need], b + 2 * R, False),   # eager, then captured
                (clip[4: 4 + need], b + 2 * R, True),
                (clip[8: 8 + need], b // 2 + 3, True)]  # a tail n_valid
        for frames, n_valid, replay in runs:
            got, replayed = _window(gset, frames, n_valid)
            assert replayed is replay
            _assert_equal(got, _eager(frames, n_valid, cfg, cuda_device),
                          f"{algorithm}, bucket {b}, n_valid {n_valid}")
    # the later buckets' windows again: replays in another order than the
    # captures', in the one pool of the set
    for b in reversed(BUCKETS):
        need = b + 2 * R + 1
        frames = moving_frames(need + 8, 256, seed=b)[2: 2 + need]
        got, replayed = _window(gset, frames, b + R)
        assert replayed
        _assert_equal(got, _eager(frames, b + R, cfg, cuda_device),
                      f"{algorithm}, bucket {b} again")
    assert len(gset.graphs) == len(BUCKETS)
    assert {g.graph.pool() for g in gset.graphs.values()} == {gset.pool}
    graphs.release(gset)
    assert len(graphs) == 1


def _stream_clip(frames: np.ndarray, cfg, dev, graphed: bool):
    """``frames`` through a streaming analyzer on ``dev`` (its eager path
    unless ``graphed``), 100 frames a push; (per-key results, analyzer)."""
    an = StreamingFlowAnalyzer(cfg, device=dev, n_pairs_total=len(frames) - 1)
    if not graphed:
        an._graphs = None
    results = []
    for i in range(0, len(frames), 100):
        results.extend(an.push(list(frames[i: i + 100])))
    results.extend(an.flush())
    return {k: np.concatenate([r[k] for r in results]) for k in KEYS}, an


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["farneback", "dis"])
def test_pending_windows_do_not_alias(cuda_device, algorithm):
    """The streaming analyzer keeps one window pending while the next
    replays: a clip of several full windows, run twice through the
    process's graphs (``pipeline.GRAPHS``; the second run replays every
    window), equals the same schedule run eagerly, bit for bit."""
    frames = moving_frames(900, 256, seed=7)
    cfg = PipelineConfig(flow_algorithm=algorithm)
    want, _ = _stream_clip(frames, cfg, cuda_device, graphed=False)
    for run in range(2):
        got, an = _stream_clip(frames, cfg, cuda_device, graphed=True)
        assert an._graphs is pipeline.GRAPHS
        for k in KEYS:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"run {run}: {k}")
        if run:
            assert an.windows_replayed == an.windows_dispatched
            assert an.graphs_captured == 0


def _push_all(an, frames: np.ndarray, sizes) -> list:
    """``frames`` through the analyzer ``an`` in pushes of ``sizes``
    frames (the rest in the last), then its flush; the result dicts."""
    results, i = [], 0
    for n in sizes:
        results.extend(an.push(list(frames[i: i + n])))
        i += n
    results.extend(an.push(list(frames[i:])))
    return results + an.flush()


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["farneback", "dis"])
def test_drain_returns_before_the_next_window_ends(cuda_device, algorithm):
    """Draining window k waits for window k alone: with window k+1 and a
    long spin queued behind it on the analyzer's stream, the drain
    returns while the spin still runs. Its results, and the clip's, equal
    the eager program's bit for bit, on the first run (window k eager,
    then captured) and on the second (every window replayed)."""
    frames = moving_frames(400, 256, seed=13)
    cfg = PipelineConfig(flow_algorithm=algorithm)
    sizes = (40, 240)  # the ramp window, then a full window
    eager = StreamingFlowAnalyzer(cfg, device=cuda_device)
    eager._graphs = None
    want = _push_all(eager, frames, sizes)
    graphs = WindowGraphs()
    for run in range(2):
        an = StreamingFlowAnalyzer(cfg, device=cuda_device)
        an._graphs = graphs
        assert an.push(list(frames[:sizes[0]])) == []  # window 0 pending
        spin_end = torch.cuda.Event()

        def dispatch_then_spin(e, n_total, dispatch=an._dispatch):
            dispatch(e, n_total)
            torch.cuda._sleep(2_000_000_000)  # about a second
            spin_end.record()

        an._dispatch = dispatch_then_spin
        drained = an.push(list(frames[sizes[0]: sum(sizes)]))
        assert not spin_end.query(), f"run {run}: the drain waited"
        del an._dispatch
        assert len(drained) == 1 and len(an._pending) == 1
        got = drained + _push_all(an, frames[sum(sizes):], ())
        assert len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            for k in KEYS:
                np.testing.assert_array_equal(
                    g[k], w[k], err_msg=f"run {run}, window {i}: {k}")
        assert an.graphs_captured == (0 if run else 2)  # 30 and 240 pairs
        if run:
            assert an.windows_replayed == an.windows_dispatched


@pytest.mark.cuda
def test_threads_on_their_own_streams(cuda_device):
    """Two threads that hold a window shape at once, each on a CUDA stream
    of its own, get a graph each; their windows equal the eager program."""
    cfg = PipelineConfig(flow_algorithm="dis")
    graphs = WindowGraphs()
    need = 30 + 2 * R + 1
    clips = [moving_frames(need + 8, 256, seed=s) for s in (1, 2)]
    barrier = threading.Barrier(2, timeout=120)
    held, errors, outs = [None, None], [], [[], []]

    def worker(t):
        try:
            with torch.cuda.stream(torch.cuda.Stream(cuda_device)):
                gset = graphs.lease(cfg, cuda_device)
                held[t] = gset
                barrier.wait()  # both hold a set of the configuration
                for shift in (0, 4, 8):
                    frames = clips[t][shift: shift + need]
                    out, replayed = _window(gset, frames, need - 1 - shift)
                    assert replayed is (shift > 0)
                    outs[t].append(out)
                graphs.release(gset)
                torch.cuda.current_stream(cuda_device).synchronize()
        except BaseException as e:  # reported by the main thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(t,)) for t in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert held[0] is not held[1]
    assert len(graphs) == 2
    for t in (0, 1):
        for shift, got in zip((0, 4, 8), outs[t]):
            frames = clips[t][shift: shift + need]
            _assert_equal(got, _eager(frames, need - 1 - shift, cfg,
                                      cuda_device), f"thread {t}")


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["farneback", "dis"])
def test_replay_counts_the_eager_launches(cuda_device, algorithm):
    """A capture counts no launch; each replay adds the launches of the
    eager program to ``launch_counts()``."""
    cfg = PipelineConfig(flow_algorithm=algorithm)
    frames = moving_frames(60 + 2 * R + 1, 256, seed=5)
    kcuda.reset_launches()
    _eager(frames, 60 + 2 * R, cfg, cuda_device)
    eager = kcuda.launch_counts()
    assert sum(eager.values()) > 0
    gset = WindowGraphs().lease(cfg, cuda_device)
    for replay in (False, True, True):
        kcuda.reset_launches()
        _, replayed = _window(gset, frames, 60 + 2 * R)
        assert replayed is replay
        assert kcuda.launch_counts() == eager
    kcuda.reset_launches()


@pytest.mark.cuda
def test_other_configuration_frees_the_graphs(cuda_device):
    """A lease of another configuration drops the first one's idle graphs
    and gives their memory back to the card."""
    graphs = WindowGraphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(cuda_device)
    cfg = PipelineConfig(flow_algorithm="farneback")
    gset = graphs.lease(cfg, cuda_device)
    for b in (240, 30):
        need = b + 2 * R + 1
        frames = moving_frames(need, 256, seed=b)
        for _ in range(2):  # eager and captured, then replayed
            _window(gset, frames, need - 1)
    graphs.release(gset)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the eager windows' cached blocks
    held = torch.cuda.memory_reserved(cuda_device)
    assert held - before > 1 << 30  # the 240-pair window's pool: ~2.6 GB
    other = graphs.lease(PipelineConfig(flow_algorithm="farneback",
                                        cut_threshold=5.0), cuda_device)
    assert other is not gset and not gset.graphs and len(graphs) == 0
    assert torch.cuda.memory_reserved(cuda_device) - before < 64 << 20
    graphs.release(other)
