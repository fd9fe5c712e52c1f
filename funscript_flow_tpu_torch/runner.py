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
A missing CUDA device raises instead: it is not a per-video failure.

Decode (:func:`_open_video`, the JAX package's engine choice): the native
pump (``runtime``) when ``use_native_decode`` is ``auto`` or ``on`` and it
builds, with its libav fast engine under ``decode_quality="fast"``; else
OpenCV (``io.decode``). ``on`` without a pump fails the clip with an
``ERROR`` line naming the cause; it never decodes through OpenCV. Each
clip's log names the engine that decoded it.

Beyond one clip on one device: ``--mesh N`` shards one clip's windows over
N devices (``parallel.dp``) and its long signal over the same devices
(``parallel.signal_sp``); a folder runs ``clip_workers`` clips in flight at
once (:func:`resolve_clip_workers`), each worker on its own CUDA stream;
``--checkpoint`` resumes a killed clip (``io.checkpoint``);
``--profile_dir`` traces the analysis loop (``utils.logging``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import queue
import threading
import time
import traceback

import numpy as np
import torch

from . import default_device
from .io import checkpoint as ckpt_mod
from .io import decode as iodec
from .io.funscript import funscript_path, write_funscript
from .models.pipeline import PipelineConfig, StreamingFlowAnalyzer
from .ops import signal_host
from .ops.reductions import CENTER_SMOOTH_RADIUS
from .ops.signal import DISCONTINUITY_THRESHOLD, signal_chain_device
from .parallel.mesh import make_mesh
from .parallel.signal_sp import signal_chain_sharded
from .utils.logging import StageTimers, profile_trace
from .utils.params import Params
from .utils.strings import STRINGS

__all__ = ["process_video", "run_headless", "compute_actions",
           "resolve_clip_workers", "NativeDecodeUnavailable",
           "AUTO_DEVICE_MIN_SAMPLES"]

# ~36 min of 30 fps samples: below this the exact float64 host chain is
# used; at or above it, a clean signal runs on the device chain
AUTO_DEVICE_MIN_SAMPLES = 65536


class NativeDecodeUnavailable(RuntimeError):
    """``use_native_decode="on"`` and the native pump cannot be built."""


def compute_actions(dots, cuts, time_stamps, fps, effective_fps, params: Params,
                    log_func=lambda m: None, device=None, mesh=None):
    """Whole-video signal chain -> (funscript actions, norm curve).

    Window sizes derive from the effective fps (reference :1287, :1335).
    ``signal_backend='auto'`` runs the exact float64 host chain, except for
    signals of ``AUTO_DEVICE_MIN_SAMPLES`` or more with ``detrend_win >= 2``
    and no cumulative-flow discontinuity, which run on the float32 device
    chain (``ops.signal``) on ``device`` (``None`` means ``cuda:0``) — or,
    when ``mesh`` lists more than one device and the signal is longer than
    ``detrend_win``, on the time-axis-sharded chain over those devices
    (``parallel.signal_sp``); ``'device'`` forces the one-device chain,
    ``'host'`` the host chain.
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
                backend = "sharded" if (mesh is not None and len(mesh) > 1
                                        and n > detrend_win) else "device"

    if backend == "host":
        log_func(f"Signal chain: host ({n} samples).")
        return signal_host.signal_chain(
            dots, cuts, time_stamps, fps, detrend_win, norm_win,
            params.keyframe_reduction,
        )[0:2]

    if backend == "sharded":
        log_func(f"Signal chain: time-axis sharded over {len(mesh)} "
                 f"devices ({n} samples).")
        norm, mask = signal_chain_sharded(
            np.asarray(dots, np.float32), np.asarray(cuts, bool), mesh,
            detrend_win, norm_win)
        norm = norm.astype(np.float64)
    else:
        dev = default_device(device)
        log_func(f"Signal chain: device ({n} samples on {dev}).")
        if n == 0:
            return [], np.zeros(0, np.float64)
        norm, mask = signal_chain_device(
            torch.as_tensor(np.asarray(dots, np.float32), device=dev),
            torch.as_tensor(np.asarray(cuts, bool), device=dev),
            n, detrend_win, norm_win)
        norm = norm.cpu().numpy().astype(np.float64)
        mask = mask.cpu().numpy()
    if not params.keyframe_reduction:
        idx = range(n)
    elif n == 1:
        idx = [0, 0]  # reference quirk (:1367, :1374)
    else:
        idx = np.nonzero(mask)[0]
    return signal_host.actions_at(idx, norm, time_stamps, fps, log_func), norm


def _decode_shards(params: Params) -> int:
    """Decode shard count: ``threads`` clamped to host cores."""
    return min(params.threads, os.cpu_count() or 1)


def _detect_native(params: Params):
    """The native runtime module when ``use_native_decode`` asks for it
    and it builds, else None; raises :class:`NativeDecodeUnavailable`
    (naming the cause) when it is ``on`` and the pump cannot be built."""
    if params.use_native_decode == "off":
        return None
    from . import runtime

    if runtime.available():
        return runtime
    if params.use_native_decode == "on":
        raise NativeDecodeUnavailable(
            "native decode requested but unavailable: "
            + runtime.unavailable_reason())
    return None


def _open_error(video_path, e: Exception) -> str:
    """The clip's ERROR line for a failed open."""
    if isinstance(e, NativeDecodeUnavailable):
        return f"ERROR: {e}"
    return f"ERROR: Unable to open video at {video_path}: {e}"


def _decode_note(source, params: Params):
    """The log line naming the engine that decodes ``source`` and, for
    OpenCV, why the native pump was not taken (None for a caller's own
    frame source)."""
    engine = getattr(source, "decode_engine", None)
    if engine is None:
        return None
    if not engine.startswith("OpenCV"):
        return f"Decode: {engine}."
    if params.use_native_decode == "off":
        why = "use_native_decode=off"
    else:
        from . import runtime

        why = runtime.unavailable_reason()
    return f"Decode: {engine}; native pump not taken: {why}"


def _open_video(video_path, params: Params, cancel_flag, start_sample=0):
    """(meta, source): one decode source for a clip, sharded over
    ``params.threads`` workers when more than one; ``start_sample`` > 0
    resumes mid-video (the checkpoint path) with one sequential source.
    Every source the runner reads is opened here.

    With the native pump (JAX ``runner.py:186-259``) the common path lets
    it self-probe, so one open gives both the metadata and the stream; a
    clip shorter than the rolling-norm window is reopened on the exact
    engine (``io.decode.effective_decode_quality``). Sharded and resumed
    native decode probe with the pump too (a short open that decodes
    nothing), so decoding a file never needs OpenCV where the pump builds.
    """
    native = _detect_native(params)
    fast = params.decode_quality == "fast"

    def native_source(meta, start=0, count=-1, depth=params.batch_size,
                      fast=fast):
        return native.NativeFrameSource(
            video_path, meta, params.vr_mode, depth=depth,
            cancel_flag=cancel_flag, start_sample=start, max_samples=count,
            gray=True, fast=fast)

    shards = _decode_shards(params)
    if native is not None and shards <= 1 and start_sample == 0:
        src = native_source(None)
        try:
            meta = src.meta
            if src.is_fast and \
                    iodec.effective_decode_quality(meta, params) == "exact":
                # a clip shorter than the norm window: reopen on the exact
                # engine (seconds long, so the reopen is cheap)
                src.close()
                src = native_source(meta, fast=False)
        except BaseException:
            src.close()
            raise
        return meta, src
    if native is not None:
        probe = native_source(None, count=0, depth=1)
        try:
            meta = probe.meta
        finally:
            probe.close()
    else:
        meta = iodec.probe(video_path)
    fast = iodec.effective_decode_quality(meta, params) == "fast"

    def factory(start, count, depth):
        if native is not None:
            return native_source(meta, start, count, depth, fast)
        return iodec.PrefetchingFrameSource(
            video_path, meta, params.vr_mode, depth=depth,
            cancel_flag=cancel_flag, start_sample=start, max_samples=count,
            gray=True,
        )

    if start_sample > 0:
        return meta, factory(start_sample, -1, params.batch_size)
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
    CUDA; ``"cpu"`` runs the plain twins on the CPU. With ``params.mesh``
    > 1 the clip's windows shard over that many devices of ``device``'s
    type (``parallel.mesh.make_mesh``).
    """
    try:
        dev = default_device(device)
        mesh = make_mesh(params.mesh, dev) if params.mesh > 1 else None
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
        log_func(_open_error(video_path, e))
        return True
    note = _decode_note(source, params)
    if note:
        log_func(note)

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
    if mesh is not None:
        log_func(STRINGS["mesh_devices"].format(n=len(mesh),
                                                platform=dev.type))

    cfg = PipelineConfig(
        pov_mode=params.pov_mode,
        cut_threshold=params.cut_threshold,
        pair_batch=params.pair_batch,
        flow_algorithm="dis" if params.backend == "DIS" else "farneback",
        dis_preset=params.dis_preset,
    )
    n_pairs_total = n_samples - 1

    # --- intra-video checkpoint / resume (io.checkpoint docstring) ---
    # (the analyzer is built after the resume decision, so that it knows
    # its local pair total, against which the tail ramp-down schedules)
    ckpt_path = ckpt_fp = None
    prefix_dots = np.zeros(0, np.float32)
    prefix_cuts = np.zeros(0, bool)
    resume_base = 0  # absolute pair index of the analyzer's local pair 0
    discard = 0      # local pairs that repeat the prefix (the halo recompute)
    if params.checkpoint:
        ckpt_path = ckpt_mod.sidecar_path(output_path)
        try:
            # the engine of the open source, not of the params: only the
            # source knows whether the codec took the fast engine, and the
            # two engines' frames differ
            engine = "fast" if getattr(source, "is_fast", False) else "exact"
            ckpt_fp = ckpt_mod.fingerprint(video_path, meta, params, dev,
                                           engine=engine)
        except OSError:
            ckpt_path = None
        loaded = ckpt_mod.load(ckpt_path, ckpt_fp) if ckpt_path else None
        if loaded is not None:
            start_pair = min(len(loaded[0]), n_pairs_total)
            # restart r pairs early: pairs >= start_pair need the centers of
            # pairs down to start_pair - r for the +-r temporal smoothing;
            # everything before that is independent per pair
            resume_base = max(0, start_pair - CENTER_SMOOTH_RADIUS)
            discard = start_pair - resume_base
            prefix_dots = loaded[0][:start_pair]
            prefix_cuts = loaded[1][:start_pair]
            log_func(STRINGS["resuming_checkpoint"].format(
                done=start_pair, total=n_pairs_total, halo=discard))
            source.close()  # it was opened at sample 0 (maybe preopened)
            try:
                _, source = _open_video(video_path, params, cancel_flag,
                                        start_sample=resume_base)
            except Exception as e:
                log_func(_open_error(video_path, e))
                return True
    analyzer = StreamingFlowAnalyzer(
        cfg, device=None if mesh is not None else dev, mesh=mesh,
        n_pairs_total=n_pairs_total - resume_base)
    results = []
    last_ckpt_pairs = len(prefix_dots)

    def ckpt_save():
        """Persist the prefix and the drained local pairs, less the
        recomputed halo."""
        nonlocal last_ckpt_pairs
        local = [np.concatenate([r[k] for r in results])[discard:]
                 if results else np.zeros(0) for k in ("dots", "cuts")]
        d = np.concatenate([prefix_dots, local[0].astype(np.float32)])
        c = np.concatenate([prefix_cuts, local[1].astype(bool)])
        ckpt_mod.save(ckpt_path, d, c, ckpt_fp)
        last_ckpt_pairs = len(d)

    def cancelled():
        log_func(STRINGS["cancelled_by_user"])
        if ckpt_path is not None:
            # keep the pending windows too: the card has computed them
            results.extend(analyzer.drain_pending())
            ckpt_save()  # cancel -> resumable
        return False

    timers = StageTimers()
    # Priming: one device's first pull carries the ramp window plus its
    # halo, so the card starts as soon as a small first window has decoded;
    # a mesh's first pull carries one whole window per device plus the
    # halo. Then one dispatch's worth of frames per pull.
    pull = cfg.pair_batch * analyzer.n_devices
    if mesh is None:
        next_pull = analyzer.ramp_pairs + analyzer.radius + 1
    else:
        next_pull = pull + 2 * analyzer.radius + 1
    try:
        with profile_trace(params.profile_dir):
            while True:
                if cancel_flag is not None and cancel_flag():
                    return cancelled()
                with timers.stage("decode_wait"):
                    batch = source.get_batch(next_pull)
                    next_pull = pull
                with timers.stage("device_compute"):
                    if batch:
                        results.extend(analyzer.push(batch))
                    else:
                        if cancel_flag is not None and cancel_flag():
                            # the source polls the flag too and ends its
                            # stream when it fires: an empty batch here may
                            # be a cancel, not EOF
                            return cancelled()
                        results.extend(analyzer.flush())
                        break
                if ckpt_path is not None:
                    # cadence in dispatched pairs; a due checkpoint drains
                    # the pending windows so that the sidecar holds them
                    done = len(prefix_dots) + max(
                        0, analyzer.pairs_emitted - discard)
                    if done - last_ckpt_pairs >= ckpt_mod.CHECKPOINT_EVERY_PAIRS:
                        results.extend(analyzer.drain_pending())
                        ckpt_save()
                if progress_callback is not None:
                    progress_callback(min(100, int(
                        100 * (resume_base + analyzer.pairs_emitted)
                        / max(1, n_pairs_total))))
    except Exception as e:
        log_func(f"ERROR: analysis failed for {video_path}: {e}")
        return True
    finally:
        source.close()
        analyzer.close()

    n_local = analyzer.pairs_emitted
    n_pairs = len(prefix_dots) + max(0, n_local - discard)
    if n_pairs < 1:
        log_func(f"ERROR: no frame pairs decoded for {video_path}.")
        return True
    log_func(f"Flow windows dispatched: {analyzer.windows_dispatched} "
             f"({n_local} pairs)")

    local = [np.concatenate([r[k] for r in results])[:n_local][discard:]
             if results else np.zeros(0) for k in ("dots", "cuts")]
    dots = np.concatenate([prefix_dots, local[0].astype(np.float32)])
    cuts = np.concatenate([prefix_cuts, local[1].astype(bool)])
    time_stamps = np.arange(n_pairs) * meta.step  # original frame indices (:1151)

    error_occurred = False
    actions, _norm = compute_actions(
        dots, cuts, time_stamps, meta.fps, meta.effective_fps, params,
        log_func, device=dev, mesh=mesh,
    )
    log_func(f"Keyframe reduction: {len(actions)} actions computed.")
    try:
        write_funscript(output_path, actions)
        log_func(STRINGS["funscript_saved"].format(output_path=output_path))
        if ckpt_path is not None:
            ckpt_mod.clear(ckpt_path)  # done: the funscript is the result
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


def resolve_clip_workers(params: Params, n_files: int) -> tuple:
    """(n_workers, n_devices) for a folder run: how many clips are in
    flight at once, over how many devices. ``clip_workers=0`` (auto) keeps
    one clip per device when a mesh is configured, and is sequential on
    one device, with or without the native pump. The JAX package runs
    ``min(cores + 1, 4)`` clips on one chip when it has the pump, whose C++
    decode fills another clip's host gaps without the GIL. On an H100,
    though, 3 clip workers ran a folder at 0.43-0.61x of one worker's pace
    with Farnebäck and at 0.31-0.58x with DIS (PERF.md section 6, the
    folder workers' finding): the flow's launches are issued by the host
    under the interpreter lock, and 3 threads issued no more launches per
    second than one. An explicit
    ``clip_workers=N`` gives N clips in flight; counts clamp to the file
    count."""
    n_devices = max(1, min(params.mesh or 1, n_files))
    if params.clip_workers > 0:
        return min(params.clip_workers, n_files), n_devices
    return n_devices, n_devices


def _run_videos_parallel(files, params: Params, log_func,
                         progress_callback, n_workers: int,
                         cancel_flag=None,
                         video_progress_callback=None,
                         n_devices: int = 1, device=None,
                         video_done_callback=None) -> bool:
    """Video-level data parallelism: ``n_workers`` clips in flight at once,
    round-robin over ``n_devices`` devices of ``device``'s type
    (``make_mesh``); workers share devices when there are more of them.
    Each worker runs every clip through :func:`process_video` with no mesh
    of its own (``mesh=0``) on its pinned device, and on a CUDA device
    under a CUDA stream of its own: on the default stream, one worker's
    copy-back of its results would wait for every other worker's queued
    windows. Per-video outputs are bitwise independent of the worker count
    (each video's analysis is self-contained; tested).

    Run-control parity with the sequential path (reference
    :1146-1148,1217-1253):

    * log lines stream live under a lock, tagged ``[wK]`` when workers
      share devices and ``[devK]`` with one worker per device;
    * ``cancel_flag`` is polled between device batches inside each worker's
      ``process_video`` and before dequeuing the next video;
    * overall progress counts fractional per-video progress of every active
      worker, and ``video_progress_callback(video_path, pct)`` exposes the
      per-video level; ``video_done_callback(video_path, error)`` is
      called once per finished video (under the log lock).

    Workers are exception-guarded: a crash in one video logs the traceback,
    marks the batch errored, and moves on to the next queued video.
    """
    devices = make_mesh(n_devices, default_device(device))
    wparams = dataclasses.replace(params, mesh=0)
    work: queue.Queue = queue.Queue()
    for item in enumerate(files):
        work.put(item)
    lock = threading.Lock()
    state = {"err": False, "done": 0}
    frac = [0.0] * n_workers  # active video's fraction, per worker

    def overall_pct_locked():
        return min(100, int(100 * (state["done"] + sum(frac)) / len(files)))

    def worker(wid, dev):
        if n_workers > len(devices):
            tag = f"[w{wid}] "       # workers share devices: tag by worker
        elif len(devices) > 1:
            tag = f"[dev{wid}] "
        else:
            tag = ""
        # the worker's own stream (and its device) for every clip it runs
        on_stream = (torch.cuda.stream(torch.cuda.Stream(device=dev))
                     if dev.type == "cuda" else contextlib.nullcontext())

        def wlog(msg):
            with lock:
                log_func(tag + msg)

        while True:
            if cancel_flag is not None and cancel_flag():
                return
            try:
                i, video = work.get_nowait()
            except queue.Empty:
                return

            def vprog(pct, _video=video):
                with lock:
                    frac[wid] = pct / 100.0
                    if video_progress_callback is not None:
                        video_progress_callback(_video, pct)
                    if progress_callback is not None:
                        progress_callback(overall_pct_locked())

            wlog(STRINGS["processing_file"].format(
                current=i + 1, total=len(files), video_path=video))
            try:
                with on_stream:
                    err = process_video(video, wparams, wlog, device=dev,
                                        progress_callback=vprog,
                                        cancel_flag=cancel_flag)
            except Exception:
                wlog(STRINGS["log_error"].format(
                    error=traceback.format_exc()))
                err = True
            with lock:
                state["err"] |= err
                state["done"] += 1
                frac[wid] = 0.0
                if video_done_callback is not None:
                    video_done_callback(video, err)
                if progress_callback is not None:
                    progress_callback(overall_pct_locked())

    threads = [threading.Thread(target=worker,
                                args=(i, devices[i % len(devices)]))
               for i in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return state["err"]


def run_headless(input_path: str, params: Params, log_path: str = "run.log",
                 progress_callback=None, cancel_flag=None,
                 device=None, video_progress_callback=None) -> bool:
    """Folder/file batch runner with run.log tee (reference :2606-2638).

    Videos run one at a time, the next video's decode source opened while
    the current one computes (the cross-video analog of the reference's
    chunk prefetch) — unless :func:`resolve_clip_workers` asks for more
    than one clip in flight (``clip_workers``, or ``--mesh N`` on a folder:
    one clip per device), which :func:`_run_videos_parallel` runs.

    ``cancel_flag`` (nullary -> bool) is polled between device batches and
    between videos on both paths; ``video_progress_callback(video_path,
    pct)`` reports per-video progress (parallel path; the sequential path
    reports it through ``progress_callback``).
    """
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

        n_workers, n_devices = resolve_clip_workers(params, len(files))
        if n_workers > 1:
            any_error = _run_videos_parallel(
                files, params, log_func, progress_callback, n_workers,
                cancel_flag=cancel_flag,
                video_progress_callback=video_progress_callback,
                n_devices=n_devices, device=device)
            log_func(STRINGS["batch_processing_complete"])
            return any_error

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
