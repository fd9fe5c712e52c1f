"""Run logging + per-stage timers.

Mirrors the reference's observability surface (SURVEY.md §5): a log callback
threaded through the pipeline, per-run timestamped log files
(``logs/YYYYmmdd_HHMMSS.log``, reference :1619-1625) and stdout tee for
headless runs (:2606-2616), plus per-stage wall-clock timers (decode wait vs
device compute). A profiler trace hook is not part of the port yet.
"""

from __future__ import annotations

import contextlib
import os
import time
from datetime import datetime

__all__ = ["RunLogger", "StageTimers"]


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
