"""Host-side video decode + preprocessing (the port's own copy).

The device boundary is "fixed-size uint8 grayscale frame windows into device
memory": decode stays on the host. Decode is **sequential**: one pass with
``grab()`` to skip unsampled frames and ``retrieve()`` only for sampled
ones, on the reference's sampling grid ``step = ceil(fps/30)`` (reference
:1127).

``cv2`` is imported inside the functions that decode, so this module (and
the whole port) imports on a machine without OpenCV; such a machine can
still drive the runner through ``process_video(preopened=...)``.

Failure semantics follow the reference: unreadable file raises at open
(:1115-1117); a failed frame mid-stream becomes a black frame (:274-280);
decode never takes the process down.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass
from queue import Empty, Full, Queue
from typing import Iterator, Optional

import numpy as np

__all__ = ["VideoMeta", "probe", "preprocess_frame", "sampled_frames",
           "PrefetchingFrameSource", "ShardedFrameSource", "find_videos",
           "effective_decode_quality"]

ANALYSIS_SIZE = 256
VR_DECODE_SIZE = 512

SUPPORTED_VIDEO_EXTENSIONS = {
    ".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm", ".wmv", ".flv",
    ".mpg", ".mpeg", ".ts",
}  # reference :28-29


@dataclass
class VideoMeta:
    total_frames: int
    fps: float
    width: int
    height: int

    @property
    def step(self) -> int:
        """Temporal downsampling to ~30 fps (reference :1127)."""
        return max(1, int(math.ceil(self.fps / 30.0)))

    @property
    def effective_fps(self) -> float:
        return self.fps / self.step

    @property
    def sampled_indices(self):
        return range(0, self.total_frames, self.step)


def probe(path: str) -> VideoMeta:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"Cannot open video: {path}")
        return VideoMeta(
            total_frames=int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
            fps=cap.get(cv2.CAP_PROP_FPS),
            width=int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
            height=int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        )
    finally:
        cap.release()


def effective_decode_quality(meta: VideoMeta, params) -> str:
    """The decode quality actually used for a video.

    Clips with fewer pairs than the rolling-norm window go to the exact
    engine even when ``decode_quality='fast'``: on such a clip every sample
    sits in a truncated, asymmetric normalization window (reference
    :1335-1349), which amplifies the fast engine's luma-only residual
    several-fold (the JAX package measured a worst ``pos`` delta of 9.4 on
    a 2.1 s clip against at most 6 inside longer ones). Such clips are a few
    seconds long, so exact decode costs almost nothing.

    Lives here (not in the runner) because the checkpoint fingerprint's
    engine default applies the same routing: a sidecar records the engine
    that decoded its pairs.
    """
    if params.decode_quality != "fast":
        return params.decode_quality
    n_pairs = len(meta.sampled_indices) - 1
    if n_pairs < int(params.norm_window * meta.effective_fps):
        return "exact"
    return "fast"


def preprocess_frame(bgr: np.ndarray, vr_mode: bool, gray: bool = False) -> np.ndarray:
    """BGR decode output -> [256, 256, 3] uint8 RGB (or [256, 256] gray)
    analysis frame.

    Non-VR: resize to 256x256 (reference decodes straight to 256, :1057).
    VR: resize to 512x512 then crop the bottom-left quadrant — the bottom
    half of the left eye of an SBS equirect (reference :1076-1079).
    ``gray=True`` is the production path: the flow program only consumes
    grayscale, so converting on the host cuts H2D traffic 3x.
    """
    import cv2

    if vr_mode:
        r = cv2.resize(bgr, (VR_DECODE_SIZE, VR_DECODE_SIZE))
        r = r[VR_DECODE_SIZE // 2 :, : VR_DECODE_SIZE // 2]
    else:
        r = cv2.resize(bgr, (ANALYSIS_SIZE, ANALYSIS_SIZE))
    return cv2.cvtColor(r, cv2.COLOR_BGR2GRAY if gray else cv2.COLOR_BGR2RGB)


def sampled_frames(path: str, meta: VideoMeta, vr_mode: bool = False,
                   cancel_flag=None, start_sample: int = 0,
                   max_samples: int = -1, gray: bool = False) -> Iterator[np.ndarray]:
    """Sequential decode of the ~30 fps sampling grid.

    Yields one analysis frame per sampled index, black frame on decode
    failure (reference :274-280). Stops early if the container runs short
    of its advertised frame count. ``start_sample``/``max_samples`` select
    a contiguous sampled-grid range (one frame-accurate seek, then
    sequential) — the unit of host-parallel decode.
    """
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"Cannot open video: {path}")
        step = meta.step
        black = np.zeros((ANALYSIS_SIZE, ANALYSIS_SIZE) + (() if gray else (3,)), np.uint8)
        emitted = 0
        n_samples = len(meta.sampled_indices) - start_sample
        if max_samples >= 0:
            n_samples = min(n_samples, max_samples)
        pos = start_sample * step
        if start_sample > 0:
            cap.set(cv2.CAP_PROP_POS_FRAMES, float(pos))
        while emitted < n_samples:
            if cancel_flag is not None and cancel_flag():
                return
            ok = cap.grab()
            if not ok:
                # container shorter than advertised: stop (callers handle
                # short streams); do not emit trailing black padding
                return
            if (pos % step) == 0:
                ok, frame = cap.retrieve()
                yield preprocess_frame(frame, vr_mode, gray) if ok else black.copy()
                emitted += 1
            pos += 1
    finally:
        cap.release()


class PrefetchingFrameSource:
    """Decode-ahead thread feeding a bounded frame queue (2-stage pipeline).

    Decode of future frames overlaps device compute on current ones (the
    reference's chunk-prefetch thread, :1139-1185). ``get_batch`` assembles
    up to ``n`` frames; returns fewer at EOF.
    """

    is_fast = False
    decode_engine = "OpenCV (cv2)"

    def __init__(self, path: str, meta: VideoMeta, vr_mode: bool = False,
                 depth: int = 512, cancel_flag=None,
                 start_sample: int = 0, max_samples: int = -1,
                 gray: bool = False):
        self._q: Queue = Queue(maxsize=depth)
        self._done = object()
        self._cancel = cancel_flag
        self._exc: Optional[BaseException] = None
        self._stop = threading.Event()

        def work():
            try:
                for f in sampled_frames(path, meta, vr_mode, cancel_flag,
                                        start_sample, max_samples, gray):
                    # bounded put that aborts on close(): a plain blocking
                    # put could refill the queue after close()'s drain and
                    # park the thread forever
                    while not self._stop.is_set():
                        try:
                            self._q.put(f, timeout=0.1)
                            break
                        except Full:
                            continue
                    if self._stop.is_set():
                        return
            except BaseException as e:  # surfaced on next get_batch
                self._exc = e
            finally:
                try:
                    self._q.put_nowait(self._done)
                except Full:
                    pass  # consumer is gone; close() drains anyway

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self._eof = False

    def get_batch(self, n: int) -> list:
        out = []
        while len(out) < n and not self._eof:
            item = self._q.get()
            if item is self._done:
                self._eof = True
                if self._exc is not None:
                    raise self._exc
                break
            out.append(item)
        return out

    def close(self):
        self._eof = True
        self._stop.set()
        # drain so a producer blocked on put() unblocks and sees the stop
        while True:
            try:
                self._q.get_nowait()
            except Empty:
                break
        self._thread.join(timeout=5.0)


class ShardedFrameSource:
    """Host-parallel decode: N workers over disjoint contiguous sampled
    ranges, consumed in order (the reference's ``threads`` knob, remapped
    to range-parallel sequential decode).

    If a non-final shard comes up short (container shorter than its
    metadata claims), the gap is filled with black frames so downstream
    pair/timestamp alignment is preserved (the final shard just ends,
    matching sequential semantics).
    """

    def __init__(self, factory, n_samples: int, shards: int, depth: int = 512,
                 gray: bool = False, cancel_flag=None):
        # below ~32 samples a shard isn't worth its seek; clamp shard count
        self._gray = gray
        self._cancel = cancel_flag
        shards = max(1, min(shards, max(1, n_samples // 32)))
        bounds = np.linspace(0, n_samples, shards + 1).astype(int)
        self._subs = []
        self._expect = []
        per_depth = max(16, depth // shards)
        for i in range(shards):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            if hi > lo:
                self._subs.append(factory(lo, hi - lo, per_depth))
                self._expect.append(hi - lo)
        self._cur = 0
        self._got_in_cur = 0

    @property
    def is_fast(self) -> bool:
        return any(getattr(s, "is_fast", False) for s in self._subs)

    @property
    def decode_engine(self) -> str:
        """The shards' engine (all decode one file with one setting)."""
        first = getattr(self._subs[0], "decode_engine", "?") if self._subs \
            else "none"
        return first if len(self._subs) == 1 else \
            f"{first}, {len(self._subs)} shards"

    def get_batch(self, n: int) -> list:
        out: list = []
        black = None
        while len(out) < n and self._cur < len(self._subs):
            got = self._subs[self._cur].get_batch(n - len(out))
            if got:
                out.extend(got)
                self._got_in_cur += len(got)
                continue
            if self._cancel is not None and self._cancel():
                # stopped by a cancel, not a short container: black-filling
                # the remainder would fabricate frames
                break
            missing = self._expect[self._cur] - self._got_in_cur
            if missing > 0 and self._cur < len(self._subs) - 1:
                if black is None:
                    shape = (ANALYSIS_SIZE, ANALYSIS_SIZE) + (() if self._gray else (3,))
                    black = np.zeros(shape, np.uint8)
                fill = min(missing, n - len(out))
                out.extend(black.copy() for _ in range(fill))
                self._got_in_cur += fill
                continue
            self._subs[self._cur].close()
            self._cur += 1
            self._got_in_cur = 0
        return out

    def close(self):
        for s in self._subs[self._cur:]:
            s.close()
        self._cur = len(self._subs)


def find_videos(root: str) -> list:
    """Recursive folder walk with the reference's extension whitelist
    (reference :2617-2623)."""
    if not os.path.isdir(root):
        return [root]
    files = []
    for r, _dirs, names in os.walk(root):
        for f in names:
            if os.path.splitext(f)[1].lower() in SUPPORTED_VIDEO_EXTENSIONS:
                files.append(os.path.join(r, f))
    return files
