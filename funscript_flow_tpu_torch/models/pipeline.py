"""The flow program: gray frame window -> per-pair motion scalars.

The port of ``funscript_flow_tpu.models.pipeline``. ``flow_chunk_program``
takes a ``[B+1, H, W]`` uint8 frame window on the device and returns only
``[B]`` scalars + ``[B, 2]`` centers; the flow fields never leave the card.

Chunking contract (fixes the reference's chunk-boundary defects, SURVEY.md
§5): callers process pair micro-batches with a ``CENTER_SMOOTH_RADIUS``-pair
halo on each side, so the flow pair spanning two chunks is computed and the
+/-6-pair center smoothing only truncates at true video edges. Results are
bitwise independent of the batch size and of the dispatch partition.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import default_device
from ..ops.farneback import FarnebackConfig, farneback_flow_planes
from .dis import DISConfig, dis_flow_planes
from ..ops.reductions import (
    CENTER_SMOOTH_RADIUS,
    max_divergence_center,
    mean_flow_magnitude,
    radial_motion_weighted,
    smooth_centers,
)

__all__ = ["PipelineConfig", "rgb_to_gray_cv", "flow_chunk_program",
           "upload_window", "FlowAnalyzer", "StreamingFlowAnalyzer"]

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


@torch.inference_mode()
def flow_chunk_program(frames: torch.Tensor, n_pairs: int,
                       cfg: PipelineConfig) -> dict:
    """frames [B+1, H, W] uint8 gray (or [B+1, H, W, 3] RGB) on the device,
    ``n_pairs`` valid-pair count -> dict(dots [B], cuts [B], centers [B,2],
    raw_centers [B,2], mean_mag [B], val_pos [B]), on the same device.

    gray -> batched Farnebäck (or DIS) flow -> divergence-argmax centers (or
    fixed bottom-center in POV mode, reference :880-882) -> cut flags -> +/-6
    temporal center smoothing -> weighted radial projection. Pairs at or
    past ``n_pairs`` are padding: their scalars are zeroed.
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
        centers = torch.tensor([[W // 2, H - 1]], dtype=torch.float32,
                               device=dev).expand(B, 2)
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


def upload_window(views, need: int, device: torch.device) -> torch.Tensor:
    """The frames ``views`` padded to ``need`` with the last one, on
    ``device``: assembled in pinned host memory when the device is a GPU
    and copied up without blocking, on the caller's current stream (so the
    caching host allocator records the stream that reads the buffer)."""
    cuda = device.type == "cuda"
    host = torch.empty((need,) + views[0].shape, dtype=torch.uint8,
                       pin_memory=cuda)
    arr = host.numpy()
    np.stack(views, out=arr[: len(views)])
    arr[len(views):] = arr[len(views) - 1]  # pad with the last frame
    return host.to(device, non_blocking=cuda)


def _to_host(res: dict) -> dict:
    return {k: res[k].cpu().numpy() for k in KEYS}


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

    Each window is assembled in pinned host memory and uploaded with a
    non-blocking copy; the program is enqueued behind it and its outputs
    stay on the card. One dispatch stays pending: window k+1 is enqueued
    before window k's ``[B]`` outputs are copied back, so the host decodes
    and assembles while the card computes.

    ``device``: ``None`` means ``cuda:0`` (raises without CUDA); the tests
    pass ``"cpu"``. ``n_pairs_total``: the video's known pair count (upper
    bound — a truncated container may deliver fewer, which flush() handles
    with real counts); knowing it enables the tail ramp-down.

    ``mesh``: optional list of devices (``parallel.mesh.make_mesh``) — each
    dispatch then covers ``n_devices * pair_batch`` pairs, one halo'd
    window per device (``parallel.dp``), sent to the devices in turn from
    the caller's thread. Per-pair results are bitwise identical to the
    single-device path, because every emitted pair sees the same halo'd
    frame window either way. Mutually exclusive with ``device``; a mesh
    dispatches no ramp window and no tail ramp-down.
    """

    KEYS = KEYS

    def __init__(self, cfg: PipelineConfig | None = None, device=None,
                 n_pairs_total: int | None = None, mesh=None):
        if mesh is not None and device is not None:
            raise ValueError("pass either a mesh or a device, not both")
        self.cfg = cfg or PipelineConfig()
        self.mesh = None if mesh is None else list(mesh)
        self.device = self.mesh[0] if mesh is not None else \
            default_device(device)
        self._D = 1 if mesh is None else len(self.mesh)
        self._n_total = n_pairs_total
        self.radius = CENTER_SMOOTH_RADIUS
        self._buf: list = []   # pending frames
        self._base = 0         # absolute frame index of _buf[0]
        self._s = 0            # next pair index to emit
        self._n_frames = 0
        self._pending: list = []  # (device result dict, lo, hi)
        self.windows_dispatched = 0

    def _tail_bucket(self, n_pairs: int) -> int:
        """Smallest power-of-two fraction of pair_batch (>= 16) covering the
        tail, so a short last window doesn't pay a full batch of padded
        compute. Results are bucket-size invariant."""
        b = self.cfg.pair_batch
        while b // 2 >= max(n_pairs, 16):
            b //= 2
        return b

    def _dispatch(self, e: int, n_total: int | None) -> None:
        """Upload the window of pairs [s, e) plus halo (one window per
        device of a mesh) and enqueue the program; its results stay on the
        device until _drain."""
        s, r, B = self._s, self.radius, self.cfg.pair_batch
        if self.mesh is None:
            segs = [(s, e)]
            bucket = self._tail_bucket(e - s)
        else:  # device d takes pairs [s + d*B, s + (d+1)*B) of [s, e)
            segs = [(min(s + d * B, e), min(s + (d + 1) * B, e))
                    for d in range(self._D)]
            bucket = B
        windows, n_valid, spans = [], [], []
        for sd, ed in segs:
            if ed <= sd:
                continue  # a mesh tail that leaves this device no pairs
            a = max(0, sd - r)
            b = ed + r if n_total is None else min(n_total, ed + r)
            windows.append(self._buf[a - self._base : b - self._base + 1])
            n_valid.append(b - a)
            spans.append((sd - a, ed - a))
        if self.mesh is None:
            res = [flow_chunk_program(
                upload_window(windows[0], bucket + 2 * r + 1, self.device),
                n_valid[0], self.cfg)]
        else:
            # imported here: parallel.dp imports this module
            from ..parallel.dp import analyze_windows_sharded

            res = analyze_windows_sharded(windows, n_valid, self.cfg,
                                          self.mesh[: len(windows)])
        self.windows_dispatched += len(res)
        self._pending.extend((rd, lo, hi) for rd, (lo, hi) in zip(res, spans))
        self._s = e
        drop = max(0, (self._s - r) - self._base)
        if drop:
            del self._buf[:drop]
            self._base += drop

    def _drain(self, keep: int) -> list:
        """Copy results back for pending windows down to ``keep``."""
        out = []
        while len(self._pending) > keep:
            res, lo, hi = self._pending.pop(0)
            if hi <= lo:
                continue
            np_res = _to_host(res)
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
        B, r = self.cfg.pair_batch * self._D, self.radius
        if (self.mesh is None and self._s == 0 and not self._pending
                and self._n_frames - 1 < B + r
                and self._n_frames - 1 >= self.ramp_pairs + r):
            self._dispatch(self.ramp_pairs, None)
        while self._n_frames - 1 >= self._s + B + r:
            self._dispatch(self._s + B, None)
        if self.mesh is None and self._n_total is not None:
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
            e = min(self._s + self.cfg.pair_batch * self._D, n_total)
            self._dispatch(e, n_total)
        return self._drain(keep=0)

    def close(self) -> None:
        """Drop undrained results (cancel path). Idempotent."""
        self._pending.clear()

    @property
    def pairs_emitted(self) -> int:
        return self._s

    @property
    def n_devices(self) -> int:
        """Devices each dispatch spans (1 unless a mesh shards windows)."""
        return self._D
