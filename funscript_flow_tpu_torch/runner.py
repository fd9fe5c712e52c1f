"""Per-video driver + headless batch runner (the port of
``funscript_flow_tpu.runner``).

Decode streams on a prefetch thread, frame windows flow through the flow
program on the card (models.pipeline, Farnebäck or DIS), per-pair scalars
accumulate on the host, and the signal chain (on the host, or on the card
for long clips) emits the funscript (reference FunscriptFlow.pyw:1094-1404,
2606-2638).

Failure semantics match the reference: per-video isolation — an analysis
error logs and moves on, aggregated into the returned ``error_occurred``
flag (:1115-1125); cancel is polled between device batches (:1146-1148).
A configuration this port cannot run yet (see :func:`check_supported`) and
a missing CUDA device raise instead: they are not per-video failures.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import default_device
from .io import decode as iodec
from .io.funscript import funscript_path, write_funscript
from .models.pipeline import PipelineConfig, StreamingFlowAnalyzer
from .ops import signal_host
from .ops.signal import DISCONTINUITY_THRESHOLD, signal_chain_device
from .utils.logging import StageTimers
from .utils.params import Params
from .utils.strings import STRINGS

__all__ = ["process_video", "run_headless", "compute_actions",
           "check_supported", "AUTO_DEVICE_MIN_SAMPLES"]

# ~36 min of 30 fps samples: below this the exact float64 host chain is
# used; at or above it, a clean signal runs on the device chain
AUTO_DEVICE_MIN_SAMPLES = 65536


def check_supported(params: Params) -> None:
    """Raise NotImplementedError for a setting whose code is not ported yet,
    naming its ROADMAP item."""
    todo = []
    if params.mesh and params.mesh > 1:
        todo.append("mesh > 1 (parallel/*)")
    if params.clip_workers > 1:
        todo.append("clip_workers > 1 (parallel/* folder workers)")
    if params.checkpoint:
        todo.append("checkpoint (io/checkpoint.py)")
    if params.profile_dir:
        todo.append("profile_dir (profile_trace/devprof)")
    if params.use_native_decode == "on":
        todo.append("use_native_decode=on (the native decode runtime)")
    if todo:
        raise NotImplementedError(
            "not yet ported (ROADMAP.md, queue 1): " + "; ".join(todo))


def compute_actions(dots, cuts, time_stamps, fps, effective_fps, params: Params,
                    log_func=lambda m: None, device=None):
    """Whole-video signal chain -> (funscript actions, norm curve).

    Window sizes derive from the effective fps (reference :1287, :1335).
    ``signal_backend='auto'`` runs the exact float64 host chain, except for
    signals of ``AUTO_DEVICE_MIN_SAMPLES`` or more with ``detrend_win >= 2``
    and no cumulative-flow discontinuity, which run on the float32 device
    chain (``ops.signal``) on ``device`` (``None`` means ``cuda:0``);
    ``'device'`` forces the device chain, ``'host'`` the host chain.
    """
    n = len(dots)
    detrend_win = int(params.detrend_window * effective_fps)
    norm_win = int(params.norm_window * effective_fps)

    backend = params.signal_backend
    if backend == "auto":
        backend = "host"
        if n >= AUTO_DEVICE_MIN_SAMPLES and detrend_win >= 2:
            cum = signal_host.integrate_flow(dots, cuts)
            if not (np.abs(np.diff(cum)) > DISCONTINUITY_THRESHOLD).any():
                backend = "device"

    if backend == "host":
        log_func(f"Signal chain: host ({n} samples).")
        return signal_host.signal_chain(
            dots, cuts, time_stamps, fps, detrend_win, norm_win,
            params.keyframe_reduction,
        )[0:2]

    dev = default_device(device)
    log_func(f"Signal chain: device ({n} samples on {dev}).")
    if n == 0:
        return [], np.zeros(0, np.float64)
    norm, mask = signal_chain_device(
        torch.as_tensor(np.asarray(dots, np.float32), device=dev),
        torch.as_tensor(np.asarray(cuts, bool), device=dev),
        n, detrend_win, norm_win)
    norm = norm.cpu().numpy().astype(np.float64)
    if not params.keyframe_reduction:
        idx = range(n)
    elif n == 1:
        idx = [0, 0]  # reference quirk (:1367, :1374)
    else:
        idx = np.nonzero(mask.cpu().numpy())[0]
    return signal_host.actions_at(idx, norm, time_stamps, fps, log_func), norm


def _decode_shards(params: Params) -> int:
    """Decode shard count: ``threads`` clamped to host cores."""
    return min(params.threads, os.cpu_count() or 1)


def _open_video(video_path, params: Params, cancel_flag):
    """(meta, source): probe, then a prefetching decode source — sharded
    over ``params.threads`` workers when more than one."""
    meta = iodec.probe(video_path)

    def factory(start, count, depth):
        return iodec.PrefetchingFrameSource(
            video_path, meta, params.vr_mode, depth=depth,
            cancel_flag=cancel_flag, start_sample=start, max_samples=count,
            gray=True,
        )

    shards = _decode_shards(params)
    if shards > 1:
        return meta, iodec.ShardedFrameSource(
            factory, len(meta.sampled_indices), shards,
            depth=params.batch_size, gray=True, cancel_flag=cancel_flag,
        )
    return meta, factory(0, -1, params.batch_size)


def _no_tf32() -> None:
    """Hold float32 math to float32, as the JAX reference does (cuDNN
    convolutions allow TF32 by default)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def process_video(video_path: str, params: Params, log_func,
                  progress_callback=None, cancel_flag=None,
                  preopened=None, device=None) -> bool:
    """Process one video into a ``.funscript``. Returns error_occurred.

    ``preopened``: optional (meta, source) prepared ahead of time — by
    run_headless, so video k+1's decode overlaps video k's tail, or by a
    caller that supplies its own frames: ``source`` needs ``get_batch(n)``
    (a list of up to n uint8 [256, 256] gray frames, fewer at EOF) and
    ``close()``. ``device``: ``None`` means ``cuda:0`` and raises without
    CUDA; ``"cpu"`` runs the plain twins on the CPU.
    """
    try:
        check_supported(params)
        dev = default_device(device)
    except Exception:
        if preopened is not None:
            preopened[1].close()
        raise
    _no_tf32()
    start_time = time.time()
    output_path = funscript_path(video_path)
    if os.path.exists(output_path) and not params.overwrite:
        if preopened is not None:
            preopened[1].close()
        log_func(STRINGS["skipping_file_exists"].format(
            video_path=video_path, output_path=output_path))
        return False

    try:
        log_func(f"Processing video: {video_path}")
        if preopened is not None:
            meta, source = preopened
        else:
            meta, source = _open_video(video_path, params, cancel_flag)
    except Exception as e:
        log_func(f"ERROR: Unable to open video at {video_path}: {e}")
        return True

    n_samples = len(meta.sampled_indices)
    log_func(
        f"FPS: {meta.fps:.2f}; downsampled to ~{meta.effective_fps:.2f} fps; "
        f"{n_samples} frames selected."
    )
    preset = f" ({params.dis_preset})" if params.backend == "DIS" else ""
    log_func(f"Using backend: {params.backend}{preset} on {dev}")
    if n_samples < 2:
        source.close()
        log_func(STRINGS["video_too_short"].format(n=n_samples))
        return True

    cfg = PipelineConfig(
        pov_mode=params.pov_mode,
        cut_threshold=params.cut_threshold,
        pair_batch=params.pair_batch,
        flow_algorithm="dis" if params.backend == "DIS" else "farneback",
        dis_preset=params.dis_preset,
    )
    n_pairs_total = n_samples - 1
    analyzer = StreamingFlowAnalyzer(cfg, device=dev,
                                     n_pairs_total=n_pairs_total)
    results = []
    timers = StageTimers()
    # Priming: the first pull carries the ramp window plus its halo, so the
    # card starts as soon as a small first window has decoded; then one
    # pair_batch of frames per pull.
    next_pull = analyzer.ramp_pairs + analyzer.radius + 1
    try:
        while True:
            if cancel_flag is not None and cancel_flag():
                log_func(STRINGS["cancelled_by_user"])
                return False
            with timers.stage("decode_wait"):
                batch = source.get_batch(next_pull)
                next_pull = cfg.pair_batch
            with timers.stage("device_compute"):
                if batch:
                    results.extend(analyzer.push(batch))
                else:
                    if cancel_flag is not None and cancel_flag():
                        # the source polls the flag too and ends its stream
                        # when it fires: an empty batch here may be a
                        # cancel, not EOF
                        log_func(STRINGS["cancelled_by_user"])
                        return False
                    results.extend(analyzer.flush())
                    break
            if progress_callback is not None:
                progress_callback(min(100, int(
                    100 * analyzer.pairs_emitted / max(1, n_pairs_total))))
    except Exception as e:
        log_func(f"ERROR: analysis failed for {video_path}: {e}")
        return True
    finally:
        source.close()
        analyzer.close()

    n_pairs = analyzer.pairs_emitted
    if n_pairs < 1:
        log_func(f"ERROR: no frame pairs decoded for {video_path}.")
        return True
    log_func(f"Flow windows dispatched: {analyzer.windows_dispatched} "
             f"({n_pairs} pairs)")

    dots = np.concatenate([r["dots"] for r in results])[:n_pairs]
    cuts = np.concatenate([r["cuts"] for r in results])[:n_pairs]
    time_stamps = np.arange(n_pairs) * meta.step  # original frame indices (:1151)

    error_occurred = False
    actions, _norm = compute_actions(
        dots, cuts, time_stamps, meta.fps, meta.effective_fps, params,
        log_func, device=dev,
    )
    log_func(f"Keyframe reduction: {len(actions)} actions computed.")
    try:
        write_funscript(output_path, actions)
        log_func(STRINGS["funscript_saved"].format(output_path=output_path))
    except Exception as e:
        log_func(STRINGS["log_error"].format(error=str(e)))
        error_occurred = True

    if progress_callback is not None:
        progress_callback(100)
    t = timers.report()
    log_func(
        f"Stage timers: decode_wait={t.get('decode_wait', 0):.2f}s "
        f"device_compute={t.get('device_compute', 0):.2f}s"
    )
    log_func(f"Processing time: {time.time() - start_time:.2f} seconds")
    return error_occurred


def run_headless(input_path: str, params: Params, log_path: str = "run.log",
                 progress_callback=None, cancel_flag=None,
                 device=None) -> bool:
    """Folder/file batch runner with run.log tee (reference :2606-2638).

    Videos run one at a time; the next video's decode source is opened
    while the current one computes (the cross-video analog of the
    reference's chunk prefetch).
    """
    check_supported(params)
    default_device(device)
    logf = open(log_path, "w")

    def log_func(msg):
        logf.write(msg + "\n")
        logf.flush()
        print(msg)

    try:
        files = iodec.find_videos(input_path)
        if not files:
            log_func("No video files found.")
            return False
        log_func(STRINGS["found_files"].format(n=len(files)))

        def prepare(path):
            if os.path.exists(funscript_path(path)) and not params.overwrite:
                return None  # will be skipped; don't waste decode on it
            try:
                return _open_video(path, params, cancel_flag)
            except Exception:
                return None  # process_video will re-probe and log the error

        any_error = False
        pre = None
        try:
            for idx, video in enumerate(files):
                this_pre, pre = pre, None
                if cancel_flag is not None and cancel_flag():
                    if this_pre is not None:
                        this_pre[1].close()
                    log_func(STRINGS["cancelled_by_user"])
                    break
                if idx + 1 < len(files):
                    pre = prepare(files[idx + 1])
                log_func(STRINGS["processing_file"].format(
                    current=idx + 1, total=len(files), video_path=video))
                any_error |= process_video(
                    video, params, log_func,
                    progress_callback=progress_callback, preopened=this_pre,
                    cancel_flag=cancel_flag, device=device,
                )
        finally:
            if pre is not None:
                pre[1].close()
        log_func(STRINGS["batch_processing_complete"])
        return any_error
    finally:
        logf.close()
        print(f"Done. See {log_path} for details.")
