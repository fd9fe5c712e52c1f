"""Background batch worker (reference: WorkerThread, FunscriptFlow.pyw:1588-1673;
the port's copy of the JAX package's ``worker.py``).

Thread wrapping the folder-batch loop with: cancel event, per-run
timestamped log file (``logs/YYYYmmdd_HHMMSS.log``, reference :1619-1625),
two-level progress callbacks (overall files %, current-video %, reference
:1638,1653-1654), and the (video, funscript) pairs produced — the reference
tracks these to offer "Open in Preview" (:1660-1665).

Qt-free: callbacks instead of signals, so it serves both the tkinter GUI
and programmatic embedding. ``device`` is where the clips' flow runs:
``cuda`` (the default, as for every entry point; the run raises without
CUDA) or ``cpu``.
"""

from __future__ import annotations

import threading

from . import default_device
from .io.funscript import funscript_path
from .runner import _run_videos_parallel, process_video, resolve_clip_workers
from .utils.logging import RunLogger
from .utils.params import Params

__all__ = ["BatchWorker"]


class BatchWorker(threading.Thread):
    def __init__(self, files, params: Params,
                 on_progress=None,        # overall percent: int
                 on_video_progress=None,  # current video percent: int
                 on_log=None,             # str
                 on_finished=None,        # (error_occurred, generated_pairs)
                 logs_dir: str = "logs", device="cuda"):
        super().__init__(daemon=True)
        self.device = default_device(device)  # raises here without CUDA
        self.files = list(files)
        self.params = params
        self._cancel = threading.Event()
        self._on_progress = on_progress or (lambda p: None)
        self._on_video_progress = on_video_progress or (lambda p: None)
        self._on_log = on_log or (lambda m: None)
        self._on_finished = on_finished or (lambda e, g: None)
        self._logs_dir = logs_dir
        self.generated = []  # (video_path, funscript_path)
        self.error_occurred = False
        self.log_path = None

    def cancel(self):
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    def run(self):
        with RunLogger(logs_dir=self._logs_dir, to_stdout=False) as logger:
            self.log_path = logger.path

            def log(msg):
                logger(msg)
                self._on_log(msg)

            total = len(self.files)
            log(f"Found {total} file(s).")
            n_workers, n_devices = resolve_clip_workers(self.params, total)
            if n_workers > 1:
                # same in-flight-clip parallelism as the headless folder
                # runner (runner._run_videos_parallel): one clip per device
                # with a mesh, N clips sharing one device otherwise.
                # The GUI has ONE per-video progress bar; with N videos in
                # flight, forward the longest-running video's percentage
                # (insertion-ordered dict) so the bar advances like the
                # sequential path instead of oscillating between videos.
                # Both callbacks run under _run_videos_parallel's lock, so
                # `active` needs no locking of its own.
                active: dict = {}

                def on_vprog(video, pct):
                    active[video] = max(pct, active.get(video, 0))
                    self._on_video_progress(next(iter(active.values())))

                def on_done(video, err):
                    if not err and not self._cancel.is_set():
                        self.generated.append((video, funscript_path(video)))
                    active.pop(video, None)
                    self._on_video_progress(
                        next(iter(active.values())) if active else 100)

                self.error_occurred = _run_videos_parallel(
                    self.files, self.params, log, self._on_progress,
                    n_workers, cancel_flag=self._cancel.is_set,
                    video_progress_callback=on_vprog,
                    n_devices=n_devices, device=self.device,
                    video_done_callback=on_done)
            else:
                for i, video in enumerate(self.files):
                    if self._cancel.is_set():
                        log("User bailed.")
                        break
                    log(f"Processing file {i + 1}/{total}: {video}")
                    err = process_video(
                        video, self.params, log,
                        progress_callback=self._on_video_progress,
                        cancel_flag=self._cancel.is_set, device=self.device,
                    )
                    self.error_occurred |= err
                    if not err and not self._cancel.is_set():
                        self.generated.append((video, funscript_path(video)))
                    self._on_progress(int(100 * (i + 1) / total))
            log("Batch processing complete.")
        self._on_finished(self.error_occurred, self.generated)
