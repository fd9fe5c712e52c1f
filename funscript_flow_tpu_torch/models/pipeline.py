"""The flow program: gray frame window -> per-pair motion scalars.

The port of ``funscript_flow_tpu.models.pipeline``. ``flow_chunk_program``
takes a ``[B+1, H, W]`` uint8 frame window on the device and returns only
``[B]`` scalars + ``[B, 2]`` centers; the flow fields never leave the card.

Chunking contract (fixes the reference's chunk-boundary defects, SURVEY.md
§5): callers process pair micro-batches with a ``CENTER_SMOOTH_RADIUS``-pair
halo on each side, so the flow pair spanning two chunks is computed and the
+/-6-pair center smoothing only truncates at true video edges. Results are
bitwise independent of the batch size and of the dispatch partition.

On a CUDA device, ``StreamingFlowAnalyzer`` runs the program through CUDA
graphs (:class:`WindowGraphs`), one per window shape: the first window of
a shape runs eagerly and the program is captured after it; every later
window of that shape is a copy into the graph's static input and one
replay of the same kernels in the same order, so its results are bitwise
those of the eager program. Each window's outputs are copied to pinned
host memory right behind its program, and an event behind the copies
tells the analyzer when they have landed.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .. import default_device
from ..ops.farneback import FarnebackConfig, farneback_flow_planes
from .dis import DISConfig, dis_flow_planes
from ..ops.cuda._build import add_launches, captured_launches
from ..ops.reductions import (
    CENTER_SMOOTH_RADIUS,
    max_divergence_center,
    mean_flow_magnitude,
    radial_motion_weighted,
    smooth_centers,
)
from ..utils.logging import span

__all__ = ["PipelineConfig", "rgb_to_gray_cv", "flow_chunk_program",
           "stage_window", "WindowGraphs", "FlowAnalyzer",
           "StreamingFlowAnalyzer"]

ANALYSIS_SIZE = 256  # reference analyses at 256x256 gray (FunscriptFlow.pyw:1057)
KEYS = ("dots", "cuts", "centers", "mean_mag", "val_pos")


@dataclass(frozen=True)
class PipelineConfig:
    """Flow-program parameters. ``kernels``: "auto" (the CUDA kernels on a
    CUDA device) or "plain" (the plain PyTorch twins; the reference run of
    the kernel checks), for either flow algorithm."""

    pov_mode: bool = False
    cut_threshold: float = 7.0  # reference :876 (config-only key, default 7)
    pair_batch: int = 240      # device micro-batch of pairs
    flow_algorithm: str = "farneback"  # farneback | dis (reference "DNN" backend)
    dis_preset: str = "fast"           # ultrafast | fast | medium (cv2 presets)
    kernels: str = "auto"
    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2

    def __post_init__(self):
        if self.flow_algorithm not in ("farneback", "dis"):
            raise ValueError(f"Unknown flow_algorithm: {self.flow_algorithm}")

    def farneback(self) -> FarnebackConfig:
        return FarnebackConfig(self.pyr_scale, self.levels, self.winsize,
                               self.iterations, self.poly_n, self.poly_sigma,
                               kernels=self.kernels)

    def dis(self) -> DISConfig:
        return DISConfig.preset(self.dis_preset, kernels=self.kernels)


def rgb_to_gray_cv(rgb: torch.Tensor) -> torch.Tensor:
    """Exact cv2.cvtColor(RGB2GRAY) on uint8: fixed-point BT.601.

    Y = (R*9798 + G*19235 + B*3735 + 2^14) >> 15, OpenCV's integer path bit
    for bit (FunscriptFlow.pyw:1079-1082). Returns float32.
    """
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    y = (r * 9798 + g * 19235 + b * 3735 + (1 << 14)) >> 15
    return y.to(torch.float32)


@functools.lru_cache(maxsize=None)
def _pov_center(w: int, h: int, device: torch.device) -> torch.Tensor:
    """The fixed bottom-center [1, 2] of POV mode, built once per device."""
    return torch.tensor([[w // 2, h - 1]], dtype=torch.float32, device=device)


@torch.inference_mode()
def flow_chunk_program(frames: torch.Tensor, n_pairs,
                       cfg: PipelineConfig) -> dict:
    """frames [B+1, H, W] uint8 gray (or [B+1, H, W, 3] RGB) on the device,
    ``n_pairs`` valid-pair count -> dict(dots [B], cuts [B], centers [B,2],
    raw_centers [B,2], mean_mag [B], val_pos [B]), on the same device.

    gray -> batched Farnebäck (or DIS) flow -> divergence-argmax centers (or
    fixed bottom-center in POV mode, reference :880-882) -> cut flags -> +/-6
    temporal center smoothing -> weighted radial projection. Pairs at or
    past ``n_pairs`` are padding: their scalars are zeroed. ``n_pairs``: an
    int, or a 0-d int64 tensor on the device (a CUDA graph's static input);
    the results are the same bit for bit. Nothing here copies from the host
    or waits for the device, so the program can be captured.
    """
    gray = frames.to(torch.float32) if frames.dim() == 3 else rgb_to_gray_cv(frames)
    f0, f1 = gray[:-1], gray[1:]
    if cfg.flow_algorithm == "dis":
        u, v = dis_flow_planes(f0, f1, cfg.dis())
    else:
        u, v = farneback_flow_planes(f0, f1, cfg.farneback())

    B, H, W = f0.shape
    dev = u.device
    if cfg.pov_mode:
        centers = _pov_center(W, H, dev).expand(B, 2)
        val_pos = torch.zeros((B,), dtype=torch.float32, device=dev)
    else:
        centers, val_pos = max_divergence_center(u, v)

    mean_mag = mean_flow_magnitude(u, v)
    cuts = mean_mag > cfg.cut_threshold

    sm_centers = smooth_centers(centers, n_pairs)
    dots = radial_motion_weighted(u, v, sm_centers, cuts, cfg.pov_mode)

    valid = torch.arange(B, device=dev) < n_pairs
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {
        "dots": torch.where(valid, dots, zero),
        "cuts": cuts & valid,
        "centers": sm_centers,
        "raw_centers": centers,
        "mean_mag": torch.where(valid, mean_mag, zero),
        "val_pos": torch.where(valid, val_pos, zero),
    }


def stage_window(views, need: int, pin: bool) -> torch.Tensor:
    """The frames ``views`` padded to ``need`` with the last one, in host
    memory (pinned with ``pin``)."""
    host = torch.empty((need,) + views[0].shape, dtype=torch.uint8,
                       pin_memory=pin)
    arr = host.numpy()
    np.stack(views, out=arr[: len(views)])
    arr[len(views):] = arr[len(views) - 1]  # pad with the last frame
    return host


def _to_host(res: dict) -> dict:
    return {k: res[k].cpu().numpy() for k in KEYS}


def _copy_back(res: dict) -> tuple:
    """Enqueue copies of the ``KEYS`` outputs ``res`` (on a CUDA device)
    into new pinned host tensors, on that device's current stream, and an
    event behind them: (host tensors, event). Nothing waits here: the
    host tensors hold the outputs once the event has completed. The
    caching host allocator hands a buffer out again only after the
    copies into it have run."""
    stream = torch.cuda.current_stream(res["dots"].device)
    host = {}
    for k in KEYS:
        host[k] = torch.empty(res[k].shape, dtype=res[k].dtype,
                              pin_memory=True)
        host[k].copy_(res[k], non_blocking=True)
    event = torch.cuda.Event()
    event.record(stream)
    return host, event


# one capture at a time in a process (captures are set-up, rare and short)
_capture_lock = threading.Lock()


class _WindowGraph:
    """The flow program of one window shape, captured into a CUDA graph:
    the static input (the frames and the valid-pair count), the graph,
    its outputs, and the hand-kernel launches that each replay runs."""

    def __init__(self, shape, cfg: PipelineConfig, device):
        self.cfg = cfg
        # normal tensors, updated in place in and out of inference mode
        with torch.inference_mode(False):
            self.frames = torch.empty(shape, dtype=torch.uint8, device=device)
            self.n_valid = torch.zeros((), dtype=torch.int64, device=device)
        self.graph = None
        self.out: dict = {}
        self.launches: dict = {}

    @torch.inference_mode()
    def run(self, n_valid: int, pool, side) -> tuple:
        """(the program's ``KEYS`` outputs in pinned host memory, the event
        behind their copies, whether a graph was replayed). Uncaptured,
        the program runs eagerly for its result and is then captured on
        the stream ``side`` into the memory pool ``pool`` (``None``: a new
        one); captured, the graph is replayed. Either way the outputs'
        copies to the host are enqueued at once, behind the program on
        the current stream, so the next replay, which overwrites the
        graph's outputs, runs after them (:func:`_copy_back`)."""
        self.n_valid.fill_(n_valid)
        if self.graph is None:
            res = flow_chunk_program(self.frames, self.n_valid, self.cfg)
            host, event = _copy_back(res)
            self._capture(pool, side)
            return host, event, False
        self.graph.replay()
        add_launches(self.launches)
        return (*_copy_back(self.out), True)

    def _capture(self, pool, side) -> None:
        """Capture the program, one capture at a time. Thread-local
        capture mode: other threads go on issuing work meanwhile. The
        launches counted while capturing are the graph's (counted again
        at each replay)."""
        graph = torch.cuda.CUDAGraph()
        with _capture_lock, torch.cuda.stream(side), \
                captured_launches() as tally:
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = flow_chunk_program(self.frames, self.n_valid, self.cfg)
            finally:
                graph.capture_end()
        self.graph, self.launches = graph, tally
        self.out = {k: out[k] for k in KEYS}


class _GraphSet:
    """The flow program of one configuration on one CUDA device, captured
    once per window shape. Its graphs share one memory pool and one
    capture stream (the caching allocator reuses a block only on the
    stream that freed it): a replay's intermediates may take memory that
    another graph of the set also uses, so the set holds about its
    largest window's pool rather than the sum of them. That is safe
    because the set is leased to one caller at a time and its graphs run
    one after another on that caller's stream, each replay's outputs
    copied to the host on that stream before the next replay."""

    def __init__(self, key, cfg: PipelineConfig, device: torch.device):
        self.key, self.cfg, self.device = key, cfg, device
        self.graphs: dict = {}  # window shape -> _WindowGraph
        self.pool = None        # the first capture's pool, then shared
        self._side = None       # the capture stream
        self.stream = None      # the stream of the last window run

    def follow(self, stream) -> None:
        """Run the next windows on ``stream``, after the work of the last
        one on another stream."""
        if self.stream is not None and self.stream != stream:
            stream.wait_stream(self.stream)
        self.stream = stream

    def load(self, host: torch.Tensor) -> _WindowGraph:
        """The graph of the pinned window ``host``'s shape (a new one if
        the set has none), its static input loaded with ``host`` without
        blocking, behind the last replay that read it."""
        self.follow(torch.cuda.current_stream(self.device))
        shape = tuple(host.shape)
        wg = self.graphs.get(shape)
        if wg is None:
            wg = self.graphs[shape] = _WindowGraph(shape, self.cfg,
                                                   self.device)
        wg.frames.copy_(host, non_blocking=True)
        return wg

    def run(self, wg: _WindowGraph, n_valid: int) -> tuple:
        """:meth:`_WindowGraph.run` in this set's pool. A graph whose
        capture or replay raised is dropped: the next window of its shape
        starts anew."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        try:
            host, event, replayed = wg.run(n_valid, self.pool, self._side)
        except BaseException:
            self.graphs = {s: g for s, g in self.graphs.items()
                           if g is not wg}
            raise
        if self.pool is None:
            self.pool = wg.graph.pool()
        return host, event, replayed

    def drop(self) -> None:
        """Let the graphs go, once the card has run their last work."""
        if self.stream is not None:
            self.stream.synchronize()
        self.graphs, self.pool = {}, None


class WindowGraphs:
    """The captured flow programs of a process, a :class:`_GraphSet` per
    (CUDA device, pipeline configuration), each leased to one caller at a
    time, so no two windows share its static buffers at once. Callers
    that run together (folder workers, each on a CUDA stream of its own)
    get one each, and a later caller on another stream waits for the
    last one's work on it first. So the sets of a configuration number
    the most callers that ran it at once, whatever their streams.

    A lease drops the idle sets of other configurations on its device
    and returns their memory to the card: a process that changes a
    setting (the GUI) would otherwise keep a set of every configuration
    it ever ran. Two configurations run at once on one device may then
    capture anew in each clip; the results are the same."""

    def __init__(self):
        self._lock = threading.Lock()
        self._idle: list = []  # [_GraphSet], the last released last

    def lease(self, cfg: PipelineConfig, device: torch.device) -> _GraphSet:
        """A set of ``cfg`` on ``device`` (its graphs captured or not),
        for the caller's current stream, until :meth:`release`."""
        key = (device, cfg)
        with self._lock:
            mine = next((s for s in reversed(self._idle) if s.key == key),
                        None)
            stale = [s for s in self._idle
                     if s.key[0] == device and s.key != key]
            self._idle = [s for s in self._idle
                          if s is not mine and s not in stale]
        if stale:
            for s in stale:
                s.drop()
            torch.cuda.empty_cache()
        if mine is None:
            mine = _GraphSet(key, cfg, device)
        mine.follow(torch.cuda.current_stream(device))
        return mine

    def release(self, graphs: _GraphSet) -> None:
        with self._lock:
            self._idle.append(graphs)

    def __len__(self) -> int:
        """The sets held and not leased."""
        with self._lock:
            return len(self._idle)


# the process's graphs: kept across clips, so that only the first windows
# of a shape and configuration in a process run eagerly
GRAPHS = WindowGraphs()


class FlowAnalyzer:
    """Whole-clip driver: halo stitching + micro-batching.

    Feed it every analysis frame (uint8 gray [N, H, W] or RGB [N, H, W, 3]);
    it returns per-pair scalars for all N-1 pairs, bitwise independent of
    the micro-batch size, with center smoothing windows truncated only at
    true video edges.
    """

    def __init__(self, cfg: PipelineConfig | None = None, device=None):
        self.cfg = cfg or PipelineConfig()
        self.device = default_device(device)
        self.radius = CENTER_SMOOTH_RADIUS

    def analyze_video_pairs(self, frames: np.ndarray) -> dict:
        """frames [N, H, W(, 3)] uint8 -> dict of np arrays of length N-1."""
        n_total = frames.shape[0] - 1
        if n_total <= 0:
            return {
                "dots": np.zeros(0, np.float32),
                "cuts": np.zeros(0, bool),
                "centers": np.zeros((0, 2), np.float32),
                "mean_mag": np.zeros(0, np.float32),
                "val_pos": np.zeros(0, np.float32),
            }
        B = self.cfg.pair_batch
        out = {k: [] for k in KEYS}
        for s in range(0, n_total, B):
            e = min(s + B, n_total)
            a = max(0, s - self.radius)
            b = min(n_total, e + self.radius)
            window = frames[a : b + 1]  # pairs [a, b) need frames [a, b]
            n_valid = b - a
            pad = B + 2 * self.radius - n_valid
            if pad > 0:
                window = np.concatenate(
                    [window, np.repeat(window[-1:], pad, axis=0)], axis=0
                )
            res = _to_host(flow_chunk_program(
                torch.from_numpy(np.ascontiguousarray(window)).to(self.device),
                n_valid, self.cfg))
            lo, hi = s - a, e - a
            for k in out:
                out[k].append(res[k][lo:hi])
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}


class StreamingFlowAnalyzer:
    """Streaming variant: push decoded frames, collect per-pair results.

    Holds only a rolling window of ``pair_batch + 2*radius + 1`` frames —
    constant memory regardless of video length. Results are bitwise
    identical to ``FlowAnalyzer.analyze_video_pairs``.

    On a card, each window is assembled in pinned host memory and uploaded
    with a non-blocking copy; the program is enqueued behind it, and
    behind that the copies of its ``[B]`` outputs to pinned host memory
    and an event. One window stays pending: window k+1 is enqueued before
    window k is drained, and draining window k waits for window k's event
    alone, so the card runs window k+1 while the host decodes, assembles
    and issues window k+2. On the CPU a window's outputs are copied back
    when it is drained.

    ``device``: ``None`` means ``cuda:0`` (raises without CUDA); the tests
    pass ``"cpu"``. ``n_pairs_total``: the video's known pair count (upper
    bound — a truncated container may deliver fewer, which flush() handles
    with real counts); knowing it enables the tail ramp-down.

    ``mesh``: optional list of devices (``parallel.mesh.make_mesh``),
    mutually exclusive with ``device``, which is a mesh of one. The
    windows are those of the one-device schedule, and window k runs on
    ``mesh[k % len(mesh)]``, issued from the caller's thread; one window
    per device stays pending. So the results, and the windows dispatched,
    are the one device's.

    ``timers``: optional ``utils.logging.StageTimers``. Each window's
    upload, program (its copy-back enqueued with it) and drain run in the
    spans ``ff.window.upload``, ``ff.window.program`` and
    ``ff.window.wait`` (``utils.logging.span``), whose wall times add to
    its ``upload``, ``program`` and ``wait`` stages.

    On a CUDA device, windows run through CUDA graphs, one per window
    shape: the analyzer leases a set of them from the process's
    (:data:`GRAPHS`) for each device at that device's first window and
    returns them at :meth:`flush` or :meth:`close`. The pinned window is
    copied straight into the graph's static input and the graph is
    replayed. ``windows_replayed`` and ``graphs_captured`` count this
    analyzer's replays and captures; every other window ran eagerly. On
    the CPU every window runs eagerly.
    """

    KEYS = KEYS

    def __init__(self, cfg: PipelineConfig | None = None, device=None,
                 n_pairs_total: int | None = None, mesh=None, timers=None):
        if mesh is not None and device is not None:
            raise ValueError("pass either a mesh or a device, not both")
        self.cfg = cfg or PipelineConfig()
        self.devices = (list(mesh) if mesh is not None
                        else [default_device(device)])
        self.device = self.devices[0]
        self._D = len(self.devices)
        self._n_total = n_pairs_total
        self._timers = timers
        self.radius = CENTER_SMOOTH_RADIUS
        self._buf: list = []   # pending frames
        self._base = 0         # absolute frame index of _buf[0]
        self._s = 0            # next pair index to emit
        self._n_frames = 0
        self._pending: list = []  # (outputs, copy-back event or None, lo, hi)
        self._graphs = GRAPHS if self.device.type == "cuda" else None
        self._sets = [None] * self._D  # each device's leased graphs
        self.windows_dispatched = 0
        self.windows_replayed = 0
        self.graphs_captured = 0

    def _tail_bucket(self, n_pairs: int) -> int:
        """Smallest power-of-two fraction of pair_batch (>= 16) covering the
        tail, so a short last window doesn't pay a full batch of padded
        compute. Results are bucket-size invariant."""
        b = self.cfg.pair_batch
        while b // 2 >= max(n_pairs, 16):
            b //= 2
        return b

    def _dispatch(self, e: int, n_total: int | None) -> None:
        """Upload the window of pairs [s, e) plus halo to the next device
        in turn and enqueue the program: on a card, with the copies of its
        outputs to pinned host memory and an event behind them; on the
        CPU, its outputs stay where they are until _drain."""
        s, r = self._s, self.radius
        a = max(0, s - r)
        b = e + r if n_total is None else min(n_total, e + r)
        views = self._buf[a - self._base : b - self._base + 1]
        need = self._tail_bucket(e - s) + 2 * r + 1
        d = self.windows_dispatched % self._D
        if self._graphs is not None:
            with span("ff.window.upload", self._timers):
                host = stage_window(views, need, pin=True)
                if self._sets[d] is None:
                    self._sets[d] = self._graphs.lease(self.cfg,
                                                       self.devices[d])
                wg = self._sets[d].load(host)
            with span("ff.window.program", self._timers):
                res, event, replayed = self._sets[d].run(wg, b - a)
            self.windows_replayed += replayed
            self.graphs_captured += not replayed
        else:
            with span("ff.window.upload", self._timers):
                frames = stage_window(views, need, pin=False).to(
                    self.devices[d])
            with span("ff.window.program", self._timers):
                res = flow_chunk_program(frames, b - a, self.cfg)
            event = None
        self.windows_dispatched += 1
        self._pending.append((res, event, s - a, e - a))
        self._s = e
        drop = max(0, (self._s - r) - self._base)
        if drop:
            del self._buf[:drop]
            self._base += drop

    def _drain(self, keep: int) -> list:
        """Hand out the results of the pending windows down to ``keep``, in
        dispatch order. A card's window waits for its own copy-back event,
        not for the windows queued behind it, and its outputs are copied
        out of the pinned buffers, which the allocator then gives to later
        windows; a CPU window's outputs are copied back here."""
        out = []
        while len(self._pending) > keep:
            res, event, lo, hi = self._pending.pop(0)
            if hi <= lo:
                continue
            with span("ff.window.wait", self._timers):
                if event is None:
                    np_res = _to_host(res)
                else:
                    event.synchronize()
                    np_res = {k: res[k].numpy().copy() for k in KEYS}
            out.append({k: np_res[k][lo:hi] for k in KEYS})
        return out

    def _tail_chain(self):
        """Sub-batch window bucket sizes, descending — exactly the shapes
        ``_tail_bucket`` can return below ``pair_batch``."""
        b = self.cfg.pair_batch
        while b // 2 >= 16:
            b //= 2
            yield b

    def _ramp_down(self) -> None:
        """Tail ramp-DOWN (total known): once no full window fits before
        EOF, dispatch the remaining pairs as DESCENDING buckets as soon as
        each window's frames (+halo) have decoded, so the only window
        serialized after the final decoded frame is the smallest one. A
        sub-window of size ``b`` is only split off when its halo still ends
        strictly before the final frame. Bitwise-invariant to the
        partition."""
        n_total, r, B = self._n_total, self.radius, self.cfg.pair_batch
        avail = self._n_frames - 1  # pairs decodable so far
        while self._s < n_total and n_total < self._s + B + r:
            remaining = n_total - self._s
            b = next((c for c in self._tail_chain() if c < remaining - r), 0)
            if b:
                if avail < self._s + b + r:
                    return  # halo frames not decoded yet; retry next push
                self._dispatch(self._s + b, n_total)
            else:
                if avail < n_total:
                    return  # the final window needs the last frame
                self._dispatch(n_total, n_total)

    @property
    def ramp_pairs(self) -> int:
        """First-window ramp size in pairs: the smallest tail bucket, so the
        card starts on a small first window instead of waiting for a full
        window of decoded frames (schedule only; results are invariant)."""
        return self._tail_bucket(1)

    def push(self, frames) -> list:
        """Add decoded frames; returns a list of result dicts (maybe empty)."""
        self._buf.extend(frames)
        self._n_frames += len(frames)
        B, r = self.cfg.pair_batch, self.radius
        if (self._s == 0 and not self._pending
                and self._n_frames - 1 < B + r
                and self._n_frames - 1 >= self.ramp_pairs + r):
            self._dispatch(self.ramp_pairs, None)
        while self._n_frames - 1 >= self._s + B + r:
            self._dispatch(self._s + B, None)
        if self._n_total is not None:
            self._ramp_down()
        return self._drain(keep=self._D)

    def drain_pending(self) -> list:
        """Copy back every dispatched window's results without dispatching
        new work (the checkpoint and cancel paths: the card has already
        paid for these pairs, so the sidecar keeps them)."""
        return self._drain(keep=0)

    def flush(self) -> list:
        """Video ended: emit remaining pairs with end-truncated smoothing
        (actual frame counts, so a truncated container processes what
        arrived)."""
        n_total = max(self._n_frames - 1, 0)
        while self._s < n_total:
            e = min(self._s + self.cfg.pair_batch, n_total)
            self._dispatch(e, n_total)
        out = self._drain(keep=0)
        self._release_graphs()
        return out

    def close(self) -> None:
        """Drop undrained results (cancel path) and return the graphs.
        Idempotent."""
        self._pending.clear()
        self._release_graphs()

    def _release_graphs(self) -> None:
        """Return the clip's graphs to the process's (:data:`GRAPHS`),
        the last device's first: a mesh that names one device twice then
        leases each set back to the entry whose window shapes it holds."""
        for gs in reversed(self._sets):
            if gs is not None:
                self._graphs.release(gs)
        self._sets = [None] * self._D

    @property
    def pairs_emitted(self) -> int:
        return self._s

    @property
    def n_devices(self) -> int:
        """Devices the windows take turns over (1 without a mesh)."""
        return self._D
