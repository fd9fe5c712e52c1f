"""Native (C++) host runtime: GIL-free decode + preprocess (the port's copy
of the JAX package's ``runtime``).

``NativeFrameSource`` mirrors ``io.decode.PrefetchingFrameSource`` but runs
the whole decode -> resize -> crop -> gray chain on C++ threads
(``frame_pump.cpp``). ``VideoEncoder`` writes h264/mpeg4 clips through the
system libavcodec (``encoder.cpp``), for tests and smoke runs.

The library is built with the system C++ compiler at first use, into
``build/funscript_flow_tpu_torch/`` (``runtime._build``); nothing is built
or loaded at import. :func:`available` says whether it built and
:func:`unavailable_reason` why it did not: no compiler, no libav headers,
or the compiler's error. Without OpenCV's headers the library holds only
the fast (libav) engine (:func:`has_exact`), and an open that needs the
exact engine fails with its reason instead of switching engines.
"""

from __future__ import annotations

import ctypes
import os
import tempfile
import threading

import numpy as np

from . import _build

__all__ = ["available", "unavailable_reason", "has_exact", "library_path",
           "NativeFrameSource", "VideoEncoder", "encoder_available",
           "add_cover_art"]

_FRAME_SHAPE = (256, 256, 3)
_lib = None
_lib_path = None
_reason = ""
_attempted = False
_lock = threading.Lock()


def _load():
    """The bound library, built at the first call; None when it cannot
    be built (the reason is kept for :func:`unavailable_reason`)."""
    global _lib, _lib_path, _reason, _attempted
    with _lock:
        if _lib is not None or _attempted:
            return _lib
        _attempted = True
        try:
            path = _build.build()
            _lib = _bind(ctypes.CDLL(str(path)))
            _lib_path = str(path)
        except (_build.BuildError, OSError, AttributeError) as e:
            _reason = str(e) or type(e).__name__
        return _lib


def _reset() -> None:
    """Forget the loaded library and the last build's outcome, so that the
    next call builds again (for tests that repoint the builder)."""
    global _lib, _lib_path, _reason, _attempted
    with _lock:
        _lib = _lib_path = None
        _reason = ""
        _attempted = False


def _bind(lib):
    """Declare the C ABI; raises AttributeError if a symbol is missing."""
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = {
        "fp_open_v3": (P, [ctypes.c_char_p, I, I, I, LL, LL, I, I, I]),
        "fp_submit_slab": (I, [P, P, I]),
        "fp_wait_slab": (LL, [P]),
        "fp_is_fast": (I, [P]),
        "fp_has_exact": (I, []),
        "fp_last_error": (ctypes.c_char_p, []),
        "fp_step": (I, [P]),
        "fp_meta": (None, [P, ctypes.POINTER(ctypes.c_double),
                           ctypes.POINTER(LL), ctypes.POINTER(I),
                           ctypes.POINTER(I)]),
        "fp_next_batch": (I, [P, P, I]),
        "fp_cancel": (None, [P]),
        "fp_close": (None, [P]),
        "fe_open_fmt": (P, [ctypes.c_char_p, I, I, I, I, ctypes.c_char_p,
                            I, I, ctypes.c_char_p]),
        "fe_open_rot": (P, [ctypes.c_char_p, I, I, I, I, ctypes.c_char_p,
                            I, I, ctypes.c_char_p, I]),
        "fe_open_ilace": (P, [ctypes.c_char_p, I, I, I, I, ctypes.c_char_p,
                              I, I, ctypes.c_char_p, I]),
        "fe_write": (I, [P, P]),
        "fe_write_at": (I, [P, P, LL]),
        "fe_close": (LL, [P]),
        "fe_add_cover": (I, [ctypes.c_char_p, ctypes.c_char_p,
                             ctypes.c_char_p, I, I]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """True when the library is built and loaded (building it if needed)."""
    return _load() is not None


def unavailable_reason() -> str:
    """Why the library did not build or load ("" when it did)."""
    _load()
    return _reason


def has_exact() -> bool:
    """True when the built library holds the exact (OpenCV) engine."""
    lib = _load()
    return lib is not None and bool(lib.fp_has_exact())


def library_path():
    """The file the library was loaded from (None until it is)."""
    _load()
    return _lib_path


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_reason}")
    return lib


def add_cover_art(src: str, dst: str, jpeg: str, w: int, h: int) -> bool:
    """Remux ``src`` into ``dst`` with ``jpeg`` as an attached-picture
    stream (embedded cover art): fixtures for stream selection."""
    lib = _load()
    if lib is None:
        return False
    return bool(lib.fe_add_cover(src.encode(), dst.encode(), jpeg.encode(),
                                 int(w), int(h)))


class NativeFrameSource:
    """Drop-in for io.decode.PrefetchingFrameSource backed by frame_pump."""

    #: frames per direct-write slab (two in flight = the decode-ahead bound)
    SLAB_FRAMES = 256

    def __init__(self, path: str, meta=None, vr_mode: bool = False,
                 depth: int = 512, cancel_flag=None,
                 start_sample: int = 0, max_samples: int = -1,
                 gray: bool = False, fast: bool = False,
                 direct: bool | None = None):
        """``meta=None`` self-probes: the pump computes the sampling step
        from the container's fps at open (the ``ceil(fps/30)`` of
        ``VideoMeta.step``) and exposes the probed metadata as ``.meta``.

        ``fast`` selects the libav lowres + gray-only engine (gray output
        only). Where the library holds the exact engine, the pump falls
        back to it when the codec rejects the fast one (check
        ``is_fast``); without it, such an open raises ``IOError`` with the
        pump's reason.

        ``direct`` (default on) uses direct-write slabs: the decode thread
        preprocesses straight into numpy-owned buffers, and the frames
        ``get_batch`` returns are views into them. ``direct=False`` uses
        the pump's bounded queue and a copy per batch.
        """
        lib = _require()
        self._lib = lib
        self._shape = _FRAME_SHAPE[:2] if gray else _FRAME_SHAPE
        self._direct = True if direct is None else bool(direct)
        step = 0 if meta is None else int(meta.step)
        self._h = lib.fp_open_v3(path.encode(), int(vr_mode), step,
                                 int(depth), int(start_sample),
                                 int(max_samples), int(gray),
                                 int(fast and gray), int(self._direct))
        if not self._h:
            why = (lib.fp_last_error() or b"").decode(errors="replace")
            raise IOError(f"Cannot open video: {path}"
                          + (f" ({why})" if why else ""))
        # the engine is fixed at open; kept so that it reads after close
        self._fast = bool(lib.fp_is_fast(self._h))
        self._cancel_flag = cancel_flag
        self._closed = False
        # direct mode: completed slabs pending consumption as (array,
        # filled, consumed); the submitted slabs' arrays, oldest first; EOF
        self._ready: list = []
        self._pending_arrays: list = []
        self._eof = False
        if self._direct:
            for _ in range(2):
                self._submit_slab()

    def _submit_slab(self):
        buf = np.empty((self.SLAB_FRAMES,) + self._shape, np.uint8)
        if self._lib.fp_submit_slab(
                self._h, buf.ctypes.data_as(ctypes.c_void_p),
                self.SLAB_FRAMES):
            self._pending_arrays.append(buf)  # alive until collected

    @property
    def meta(self):
        """VideoMeta probed by the pump's own decoder (no second open)."""
        from ..io.decode import VideoMeta

        fps = ctypes.c_double()
        tf = ctypes.c_longlong()
        w = ctypes.c_int()
        h = ctypes.c_int()
        self._lib.fp_meta(self._h, ctypes.byref(fps), ctypes.byref(tf),
                          ctypes.byref(w), ctypes.byref(h))
        meta = VideoMeta(total_frames=int(tf.value), fps=float(fps.value),
                         width=int(w.value), height=int(h.value))
        # the pump samples on its own step; a silent disagreement with the
        # VideoMeta formula would mis-time every emitted action
        pump_step = int(self._lib.fp_step(self._h))
        if pump_step != meta.step:
            raise RuntimeError(
                f"pump step {pump_step} != VideoMeta.step {meta.step} "
                f"(fps={meta.fps})")
        return meta

    @property
    def is_fast(self) -> bool:
        """True when the pump runs the libav fast engine."""
        return self._fast

    @property
    def decode_engine(self) -> str:
        return f"native pump, {'fast' if self.is_fast else 'exact'} engine"

    def get_batch(self, n: int) -> list:
        if self._cancel_flag is not None and self._cancel_flag():
            self._lib.fp_cancel(self._h)
            return []
        if not self._direct:
            buf = np.empty((n,) + self._shape, np.uint8)
            got = self._lib.fp_next_batch(
                self._h, buf.ctypes.data_as(ctypes.c_void_p), n)
            return list(buf[:got])

        out: list = []
        while len(out) < n:
            if self._ready:
                arr, filled, consumed = self._ready[0]
                take = min(filled - consumed, n - len(out))
                out.extend(arr[consumed:consumed + take])
                consumed += take
                if consumed >= filled:
                    self._ready.pop(0)
                else:
                    self._ready[0] = (arr, filled, consumed)
                continue
            if self._eof or not self._pending_arrays:
                break
            got = self._lib.fp_wait_slab(self._h)  # blocks (GIL released)
            if got == -2:  # cancelled
                return []
            arr = self._pending_arrays.pop(0)
            if got <= 0:
                self._eof = True
                if got < 0:
                    break
            filled = max(0, int(got))
            if filled < self.SLAB_FRAMES:
                self._eof = True  # a partial slab is the end of the stream
            else:
                self._submit_slab()  # keep two slabs of decode-ahead
            if filled:
                self._ready.append((arr, filled, 0))
        return out

    def close(self):
        if not self._closed:
            self._closed = True
            self._lib.fp_close(self._h)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class VideoEncoder:
    """Native h264/mpeg4 clip writer (``encoder.cpp``) for tests and smoke
    runs: long-GOP h264 through the system libavcodec (``libx264``, with
    B-frames by default); the caller picks another codec where that one is
    missing (:func:`encoder_available`)."""

    def __init__(self, path: str, w: int, h: int, fps: float,
                 codec: str = "libx264", gop: int = 250, bframes: int = 3,
                 pix_fmt: str = "", rotation: int = 0,
                 interlaced: bool = False):
        """``pix_fmt``: libav pixel format name; "" -> yuv420p (the open
        fails when the encoder does not support it).

        ``rotation``: display-matrix metadata in degrees (the
        ``av_display_rotation_set`` convention: 90 means players rotate the
        stored frame 90° clockwise to display it)."""
        lib = _require()
        self._lib = lib
        from fractions import Fraction

        fr = Fraction(fps).limit_denominator(1001)
        opener = lib.fe_open_ilace if interlaced else lib.fe_open_rot
        self._h = opener(path.encode(), int(w), int(h),
                         fr.numerator, fr.denominator,
                         codec.encode(), int(gop), int(bframes),
                         pix_fmt.encode(), int(rotation))
        if not self._h:
            raise IOError(f"Cannot open encoder {codec} "
                          f"({pix_fmt or 'yuv420p'}) for {path}")
        self._shape = (h, w, 3)

    def write(self, bgr: np.ndarray, pts: int | None = None) -> None:
        """One BGR24 uint8 frame of shape [h, w, 3].

        ``pts``: explicit timestamp in 1/fps ticks (strictly increasing) for
        variable-rate content; None = constant rate at the frame index."""
        assert bgr.shape == self._shape and bgr.dtype == np.uint8
        bgr = np.ascontiguousarray(bgr)
        ok = (self._lib.fe_write(self._h, bgr.ctypes.data_as(ctypes.c_void_p))
              if pts is None else
              self._lib.fe_write_at(self._h,
                                    bgr.ctypes.data_as(ctypes.c_void_p),
                                    int(pts)))
        if not ok:
            raise IOError("encode failed")

    def close(self) -> int:
        if self._h:
            n = int(self._lib.fe_close(self._h))
            self._h = None
            return n
        return 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def encoder_available(codec: str = "libx264", ext: str = "mp4",
                      pix_fmt: str = "") -> bool:
    """True when the native encoder can open ``codec`` in a container of
    type ``ext`` with ``pix_fmt`` (probed on a 64x64 file)."""
    lib = _load()
    if lib is None:
        return False
    with tempfile.TemporaryDirectory() as d:
        # bframes=0: some codecs (wmv2, flv1) reject B-frames
        h = lib.fe_open_fmt(os.path.join(d, f"p.{ext}").encode(), 64, 64,
                            30, 1, codec.encode(), 0, 0, pix_fmt.encode())
        if not h:
            return False
        lib.fe_close(h)
    return True
