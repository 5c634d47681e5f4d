"""Fault tolerance: a file heartbeat, step timing and a restart loop.

Counterpart of ``repro/distributed/fault_tolerance.py``.  Work is a pure
function of its latest committed state (a checkpoint, or a streaming
compression job's state file), so a supervisor restarts a failed attempt
and the attempt resumes from that state.  ``Heartbeat`` writes a liveness
file a sidecar can read; ``StepTimer`` keeps an EMA of step times and flags
a straggler against a reference median.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable

__all__ = ["Heartbeat", "StepTimer", "run_with_restarts"]


class Heartbeat:
    """File-based liveness beacon, written at most every ``interval_s``."""

    def __init__(self, path: str, interval_s: float = 15.0):
        self.path = path
        self.interval_s = interval_s
        self._last = 0.0

    def beat(self, step: int, extra: dict | None = None) -> None:
        now = time.time()
        if now - self._last < self.interval_s:
            return
        self._last = now
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": now, "step": step, **(extra or {})}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def is_alive(path: str, timeout_s: float = 120.0) -> bool:
        try:
            with open(path) as f:
                return time.time() - json.load(f)["time"] < timeout_s
        except (OSError, ValueError, KeyError):
            return False


class StepTimer:
    """EMA step timing and a straggler flag against a reference median."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = None
        self._t0 = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() called before start()")
        dt = time.perf_counter() - self._t0
        self.ema = dt if self.ema is None else (1 - self.alpha) * self.ema + self.alpha * dt
        return dt

    def is_straggler(self, median_ema: float, factor: float = 1.5) -> bool:
        return self.ema is not None and self.ema > factor * median_ema


def run_with_restarts(
    make_and_run: Callable[[int], None],
    max_restarts: int = 3,
    on_failure: Callable[[int, BaseException], None] | None = None,
) -> int:
    """Call ``make_and_run(attempt)``; on an exception retry up to
    ``max_restarts`` times (the callee resumes from its newest state).
    ``KeyboardInterrupt`` and ``SystemExit`` are deliberate shutdowns and
    are re-raised at once.  Any other exception is retried, a CUDA error
    included, so a caller that needs an uninterrupted run checks that the
    returned count of restarts is 0."""
    attempt = 0
    while True:
        try:
            make_and_run(attempt)
            return attempt
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 - the supervision boundary
            if on_failure is not None:
                on_failure(attempt, e)
            attempt += 1
            if attempt > max_restarts:
                raise
