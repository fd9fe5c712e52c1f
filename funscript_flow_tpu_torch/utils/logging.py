"""Run logging + per-stage timers.

Mirrors the reference's observability surface (SURVEY.md §5): a log callback
threaded through the pipeline, per-run timestamped log files
(``logs/YYYYmmdd_HHMMSS.log``, reference :1619-1625) and stdout tee for
headless runs (:2606-2616), plus the program's spans (:class:`span`): each
adds its wall time to a per-stage total (:class:`StageTimers`, the runner's
``Stage timers`` line) and, while a ``torch.profiler`` profile runs, lands
in its trace beside the device's kernels and copies; and a
``torch.profiler`` trace hook (``--profile_dir``).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from datetime import datetime

import torch

__all__ = ["RunLogger", "StageTimers", "span", "profile_trace"]


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
    """Accumulating wall-clock totals per pipeline stage, fed by
    :class:`span`; ``report()`` returns {stage: seconds}."""

    def __init__(self):
        self.totals: dict = {}

    def add(self, stage: str, seconds: float) -> None:
        self.totals[stage] = self.totals.get(stage, 0.0) + seconds

    def report(self) -> dict:
        return dict(self.totals)


class span:
    """``with span("ff.window.upload", timers): ...``: one span of the
    program.

    While a ``torch.profiler`` profile runs, the span is a
    ``record_function(name)``: it lands in the same trace as the device's
    kernels and copies, on the profiler's clock, and nests under the spans
    open on the calling thread. With ``timers``, its wall time is added to
    the stage named by the last dotted part of ``name``
    (``ff.window.upload`` -> ``upload``). With no profile running it
    builds no ``record_function``: a flag check, and the two clock reads
    when ``timers`` is given. Spans sit at layer boundaries (a few per
    window and per clip), never per launch."""

    __slots__ = ("name", "timers", "_t0", "_rf")

    def __init__(self, name: str, timers: StageTimers | None = None):
        self.name, self.timers = name, timers

    def __enter__(self):
        self._rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        if self.timers is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.timers is not None:
            self.timers.add(self.name.rsplit(".", 1)[-1],
                            time.perf_counter() - self._t0)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


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
