"""Run logging + per-stage timers.

Mirrors the reference's observability surface (SURVEY.md §5): a log callback
threaded through the pipeline, per-run timestamped log files
(``logs/YYYYmmdd_HHMMSS.log``, reference :1619-1625) and stdout tee for
headless runs (:2606-2616), plus per-stage wall-clock timers (decode wait vs
device compute) and a ``torch.profiler`` trace hook (``--profile_dir``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from datetime import datetime

__all__ = ["RunLogger", "StageTimers", "profile_trace"]


class RunLogger:
    """Tee log lines to a file and optionally stdout; context manager."""

    def __init__(self, path: str | None = None, to_stdout: bool = True,
                 logs_dir: str | None = None):
        if path is None:
            logs_dir = logs_dir or "logs"
            os.makedirs(logs_dir, exist_ok=True)
            path = os.path.join(
                logs_dir, datetime.now().strftime("%Y%m%d_%H%M%S") + ".log"
            )
        self.path = path
        self._f = open(path, "w")
        self._stdout = to_stdout

    def __call__(self, msg: str) -> None:
        self._f.write(msg + "\n")
        self._f.flush()
        if self._stdout:
            print(msg)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StageTimers:
    """Accumulating wall-clock timers per pipeline stage.

    Usage: ``with timers.stage("decode_wait"): ...``; ``timers.report()``
    returns {stage: seconds}.
    """

    def __init__(self):
        self.totals: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> dict:
        return dict(self.totals)


# held while a trace runs: the profiler is process-wide, as jax.profiler is
_trace_lock = threading.Lock()


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` trace scope (CPU activity, and CUDA activity when
    CUDA is available) when ``log_dir`` is set; no-op otherwise. On exit it
    writes a chrome trace, ``trace_<pid>_<ms>.json``, into ``log_dir``.

    One trace runs at a time in a process: a second ``profile_trace``
    while one runs raises ``RuntimeError`` with ``jax.profiler``'s message
    (the runner then logs the clip as failed, as the JAX package does)."""
    if not log_dir:
        yield
        return
    if not _trace_lock.acquire(blocking=False):
        raise RuntimeError("Profile has already been started. Only one "
                           "profile may be run at a time.")
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
    finally:
        _trace_lock.release()
