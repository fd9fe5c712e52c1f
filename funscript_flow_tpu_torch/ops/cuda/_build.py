"""Build and load the port's CUDA kernels, and launch them.

The sources in ``funscript_flow_tpu_torch/csrc/*.cu`` have a plain C
interface. On first use, ``nvcc`` compiles each source to an object (all
started together), links them into ``build/funscript_flow_tpu_torch/
libffkernels.so`` at the repository root, and the library is loaded with
``ctypes``. A stamp beside the library holds the hash of the sources, the
headers they include (``csrc/*.cuh``) and the flags; a change to any of
them rebuilds. Nothing is built or loaded at import
time — only the first kernel launch (or an explicit :func:`load`) does it.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that every
product and sum is rounded on its own, as in the plain PyTorch twins the
kernels are checked against; no ``--use_fast_math`` (the center-of-motion
argmax downstream is winner-take-all).

The launch path is lean, because at the small pyramid levels the host's
cost of a call exceeds the kernel's: each C entry point is resolved once,
when the library loads; a launch reads the raw handle of PyTorch's current
stream of the tensor's device on every call (so a CUDA graph being captured
on that stream records the launch, and each thread launches on its own
current stream) and switches the device only when the tensor is not on the
current one. The only lock a launch takes guards its count, which threads
launching at once would otherwise lose. A launch made while its thread
captures a CUDA graph (:func:`captured_launches`) is counted apart: it
runs, and is counted (:func:`add_launches`), each time the graph is
replayed.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

__all__ = ["load", "check_tensor", "check_planes", "same_device", "launch",
           "count_launch", "captured_launches", "add_launches", "SOURCES",
           "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "funscript_flow_tpu_torch"
LIB_NAME = "libffkernels.so"
SOURCES = ("polyexp.cu", "warp.cu", "warp_planes.cu", "flow_step.cu",
           "pyramid.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes (all return cudaError_t as int)
_SIGNATURES = {
    # img, out, B, H, W, n, taps[3*(2n+1)] (host), ig[4] (host), stream
    "ff_poly_exp": (_P, _P, _I, _I, _I, _I, _P, _P, _P),
    # R [B,P,H,W], u, v, out [B,P,H,W], B, P, H, W, stream
    "ff_warp_bilinear": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # I1, I1x, I1y, u, v [B,H,W], out [B,3,H,W], B, H, W, stream
    "ff_warp_planes": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # img [B,h,w], fy, fx, out [B,Ho,Wo], B, h, w, Ho, Wo, stream
    "ff_sample_abs": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # img [B,h,w], pu, pv [B,ny,nx], out [B,ny,nx,ps*ps], B, h, w, ny, nx,
    # ps, stride, stream
    "ff_sample_patches": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # m0..m4, u, v, B, H, W, win, inv_area, stream
    "ff_box_blur_solve": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P),
    # src [N,H,W], out [N,lh,lw], idx, wts (device tables), N, H, W, lh,
    # lw, k, taps[k] (host), th, tw, sw, stream
    "ff_pyramid_level": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I,
                         _I, _P),
}

_lock = threading.Lock()
_lib = None
_fns: dict = {}  # C entry point name -> its ctypes function, once loaded
build_info: dict = {}  # seconds, log, rebuilt — read by chip_smoke.py
# kernel launches per wrapper entry point since the last reset
# (ops.cuda.launch_counts / reset_launches), under _count_lock
launches: dict = {}
_count_lock = threading.Lock()
# the launch tally of a CUDA graph that this thread is capturing, if any
_capturing = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / name for name in SOURCES] + sorted(
            CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _run(cmds):
    """Run the commands concurrently; raise with their output on failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed: {' '.join(c)}\n{log}")
    return "".join(logs)


def _build(digest: str) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", o]
                    for s, o in zip(SOURCES, objs)])
        tmp_lib = os.path.join(tmp, LIB_NAME)
        log += _run([[nvcc, "-shared", "-o", tmp_lib, *objs]])
        os.replace(tmp_lib, BUILD_DIR / LIB_NAME)
    (BUILD_DIR / (LIB_NAME + ".stamp")).write_text(digest)
    return log


def load():
    """The loaded kernel library, built first if the sources changed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        digest = _digest()
        stamp = BUILD_DIR / (LIB_NAME + ".stamp")
        rebuilt = not (stamp.exists() and stamp.read_text() == digest
                       and (BUILD_DIR / LIB_NAME).exists())
        log = _build(digest) if rebuilt else ""
        lib = ctypes.CDLL(str(BUILD_DIR / LIB_NAME))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[name] = fn
        build_info.update(seconds=time.perf_counter() - t0, log=log,
                          rebuilt=rebuilt)
        _lib = lib
        return lib


def check_tensor(t: torch.Tensor, name: str, shape=None) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape``."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_planes(ts, names, shape) -> None:
    """Raise unless every tensor of ``ts`` is a contiguous float32 tensor
    of ``shape`` and all lie on one device. One pass with no function call
    per tensor, since it is on a launch's path; ``names`` serve only to say
    which tensor fails."""
    t0 = ts[0]
    cuda, d = t0.is_cuda, t0.get_device()
    for t in ts:
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != shape or t.is_cuda is not cuda
                or t.get_device() != d):
            for name, tn in zip(names, ts):
                check_tensor(tn, name, shape)
            raise ValueError("all tensors must be on one device")
    if not cuda:
        same_device(*ts)  # off CUDA get_device() is -1 for every device


def same_device(*ts) -> None:
    """Raise unless all tensors lie on one device (for CUDA tensors with
    the cheapest calls: this is on every launch's path)."""
    t0 = ts[0]
    if t0.is_cuda:
        d = t0.get_device()
        for t in ts:
            if not t.is_cuda or t.get_device() != d:
                raise ValueError("all tensors must be on one device")
    else:
        for t in ts:
            if t.device != t0.device:
                raise ValueError("all tensors must be on one device")


def launch(kernel: str, fn_name: str, t: torch.Tensor, *args) -> None:
    """Call one C entry point on the current stream of ``t``'s device and
    add one to the launch count of the wrapper's entry point ``kernel``;
    raise if it reports a CUDA error (a refused launch never runs, and a
    later synchronize would not report it)."""
    if not t.is_cuda:
        raise ValueError(f"{fn_name}: expected CUDA tensors, got {t.device}")
    index = t.get_device()
    fn = _fns.get(fn_name)
    if fn is None:
        load()
        fn = _fns[fn_name]
    if index == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError_t {rc}")
    count_launch(kernel)


def count_launch(kernel: str) -> None:
    """Add one to ``kernel``'s launch count (a read-modify-write, so under
    a lock: clip workers launch from several threads at once), or to the
    tally of the graph this thread is capturing."""
    tally = getattr(_capturing, "tally", None)
    if tally is not None:
        tally[kernel] = tally.get(kernel, 0) + 1
        return
    with _count_lock:
        launches[kernel] = launches.get(kernel, 0) + 1


@contextlib.contextmanager
def captured_launches():
    """While the block runs, count this thread's launches into the dict it
    yields instead of ``launches``: the block captures a CUDA graph, whose
    launches run only when it is replayed."""
    tally: dict = {}
    _capturing.tally = tally
    try:
        yield tally
    finally:
        _capturing.tally = None


def add_launches(counts: dict) -> None:
    """Add ``counts`` (a captured graph's tally) to the launch counts: the
    graph has been replayed once."""
    with _count_lock:
        for kernel, n in counts.items():
            launches[kernel] = launches.get(kernel, 0) + n
