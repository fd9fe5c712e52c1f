"""Intra-video checkpoint / resume (the port's copy of the JAX package's
``io/checkpoint.py``).

The reference's only resume mechanism is file-level idempotence: a killed
run reprocesses every unfinished video from frame 0 (skip-if-exists,
FunscriptFlow.pyw:1105-1109) — for a multi-hour video that throws away up
to hours of decode + flow work. Opt-in ``--checkpoint`` persists the
per-pair scalar stream (dots/cuts — the only state the whole-video signal
chain needs, ~5 bytes/pair) to a sidecar next to the output, periodically
and on cancel. A rerun restarts decode ``CENTER_SMOOTH_RADIUS`` pairs
before the saved high-water mark, recomputes and discards that halo (the
±6-pair center smoothing is the only cross-pair coupling in the flow
stage), and continues — the final funscript is byte-identical to an
uninterrupted run (tested in tests/test_torch_checkpoint.py).

The sidecar is invalidated by a fingerprint of the video file (size,
mtime, frame count, fps, sampling step), of every parameter that
influences per-pair values and of the numeric regime; it is deleted on
successful completion. The file format is the JAX package's, but the two
fingerprints never match: a sidecar of one package is not resumed by the
other.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["sidecar_path", "fingerprint", "flow_regime", "save", "load",
           "clear", "CHECKPOINT_EVERY_PAIRS"]

#: flush cadence in dispatched pairs (~2.3 min of 30 fps samples)
CHECKPOINT_EVERY_PAIRS = 4096

_VERSION = 1


def sidecar_path(output_path: str) -> str:
    return output_path + ".ckpt.npz"


def flow_regime(device) -> str:
    """The numeric regime of the runner's flow program on ``device``:
    ``torch``, the device type, and the route — the CUDA kernels on a CUDA
    device, their plain twins on the CPU."""
    dev = torch.device(device)
    return f"torch/{dev.type}/{'kernels' if dev.type == 'cuda' else 'plain'}"


def fingerprint(video_path: str, meta, params, device) -> str:
    """Identity of (video, analysis settings, numeric regime): a resumed
    run must be computing the same per-pair stream.

    ``pair_batch``/``mesh``/``threads`` are deliberately absent — per-pair
    results are invariant to them (batch/bucket/mesh/shard invariance,
    tested). ``engine`` is always ``exact``: the port decodes only through
    OpenCV. ``flow`` is :func:`flow_regime` in place of the JAX package's
    resolved TPU numerics, so a sidecar written by the JAX package, or by
    the port on another device type or route, is never resumed.
    """
    st = os.stat(video_path)
    return json.dumps({
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
        "total_frames": int(meta.total_frames),
        "fps": float(meta.fps),
        "step": int(meta.step),
        "vr_mode": bool(params.vr_mode),
        "pov_mode": bool(params.pov_mode),
        "backend": str(params.backend),
        "dis_preset": str(params.dis_preset),
        "cut_threshold": float(params.cut_threshold),
        "engine": "exact",
        "flow": flow_regime(device),
    }, sort_keys=True)


def save(path: str, dots: np.ndarray, cuts: np.ndarray, fp: str) -> None:
    """Atomic write (tmp + rename): a crash mid-save leaves the previous
    checkpoint intact."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, version=_VERSION, fingerprint=fp,
                 dots=np.asarray(dots, np.float32),
                 cuts=np.asarray(cuts, bool))
    os.replace(tmp, path)


def load(path: str, fp: str):
    """(dots, cuts) from a valid matching sidecar, else None. Missing,
    corrupt, stale-fingerprint, or future-version files are all treated
    as "no checkpoint" — resume is best-effort by design."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if int(z["version"]) != _VERSION or str(z["fingerprint"]) != fp:
                return None
            dots = np.asarray(z["dots"], np.float32)
            cuts = np.asarray(z["cuts"], bool)
    except Exception:
        return None
    if dots.shape != cuts.shape or dots.ndim != 1:
        return None
    return dots, cuts


def clear(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass
