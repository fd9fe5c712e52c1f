"""Data-parallel flow analysis: pair windows over a device list (the port
of the JAX package's ``parallel/dp.py``).

Each device receives one contiguous frame window, with the 1-frame flow
halo and the 6-pair center-smoothing halo prepared on the host, exactly as
the single-device streaming stitcher in ``models.pipeline`` cuts them, and
runs the whole flow program on it. Where the JAX package runs one
``shard_map`` program, the port launches one program per device from the
caller's thread, in turn: each window is uploaded from pinned memory
without blocking, so the host moves on to the next device while the copy
and the program run. Valid-pair counts travel per window, so smoothing
truncates only at true video edges.
"""

from __future__ import annotations

import numpy as np

from ..models.pipeline import (PipelineConfig, _to_host, flow_chunk_program,
                               upload_window)
from ..ops.reductions import CENTER_SMOOTH_RADIUS

__all__ = ["shard_video_windows", "analyze_windows_sharded",
           "analyze_multichip"]


def analyze_windows_sharded(windows, n_valid, cfg: PipelineConfig,
                            devices) -> list:
    """windows: one sequence of uint8 frames per device (each at most
    ``pair_batch + 2*radius + 1`` frames; shorter ones are padded with
    their last frame), ``n_valid`` the valid-pair count of each -> one
    result dict per window, left on its device."""
    need = cfg.pair_batch + 2 * CENTER_SMOOTH_RADIUS + 1
    return [flow_chunk_program(upload_window(w, need, dev), int(nv), cfg)
            for w, nv, dev in zip(windows, n_valid, devices)]


def shard_video_windows(frames: np.ndarray, n_devices: int,
                        pairs_per_device: int):
    """Split a video's frame stream into per-device halo'd windows.

    frames [N, H, W(, 3)] -> (windows [D, F, H, W(, 3)], n_valid [D],
    lo [D], hi [D]) where window d covers emitted pairs
    [d*ppd, min((d+1)*ppd, n_pairs)) and F = pairs_per_device + 2*radius + 1
    frames.
    """
    r = CENTER_SMOOTH_RADIUS
    n_pairs = frames.shape[0] - 1
    F = pairs_per_device + 2 * r + 1
    windows, n_valid, lo, hi = [], [], [], []
    for d in range(n_devices):
        s = min(d * pairs_per_device, n_pairs)
        e = min(s + pairs_per_device, n_pairs)
        a = max(0, s - r)
        b = min(n_pairs, e + r)
        w = frames[a : b + 1]
        if w.shape[0] < F:
            w = np.concatenate([w, np.repeat(w[-1:], F - w.shape[0], axis=0)],
                               axis=0)
        windows.append(w)
        n_valid.append(b - a)
        lo.append(s - a)
        hi.append(e - a)
    return (np.stack(windows), np.asarray(n_valid, np.int32),
            np.asarray(lo, np.int32), np.asarray(hi, np.int32))


def analyze_multichip(frames: np.ndarray, cfg: PipelineConfig,
                      devices) -> dict:
    """Run the flow program data-parallel over ``devices``, one window of
    ``cfg.pair_batch`` pairs each (the clip must fit one window per
    device).

    Returns the same per-pair dict as FlowAnalyzer.analyze_video_pairs,
    for all N-1 pairs, independent of the device count (tested).
    """
    D = len(devices)
    windows, n_valid, lo, hi = shard_video_windows(frames, D, cfg.pair_batch)
    res = [_to_host(r) for r in
           analyze_windows_sharded(list(windows), n_valid, cfg, devices)]
    return {k: np.concatenate([res[d][k][lo[d]:hi[d]] for d in range(D)],
                              axis=0)
            for k in res[0]}
