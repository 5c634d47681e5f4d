"""Async request front end over the continuous-batching scheduler.

Counterpart of ``repro/serving/frontend.py``.  ``submit(prompt, ...)``
returns a ``concurrent.futures.Future`` immediately; a worker thread drives
``Scheduler.step()`` whenever there is work and resolves each future with
its completed ``Request`` (tokens + timing).

Backpressure: a submit blocks while the worst-case page commitment of all
live requests (pending + active, each at ``prompt + max_tokens``) plus the
new request would exceed ``overcommit`` times the usable pool: the pool,
not an unbounded python queue, is the admission limit.  Pass ``timeout``
to get ``TimeoutError`` instead of waiting forever; set ``overcommit > 1``
to deliberately oversubscribe pages and lean on the scheduler's preemption
path.

Beside the reference, the worker counts its ticks and the host time they
took (``ticks``, ``busy_s``; a tick ends in the copy of its greedy picks to
the host, so the time includes its device work), which ``run_load``
reports per rate.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future

from repro_torch.serving.scheduler import Scheduler

__all__ = ["ServeFrontend"]


class ServeFrontend:
    """Thread-driving front end.  Use as a context manager or call
    ``close()``; ``auto_start=False`` defers the worker (deterministic
    backpressure tests, manual stepping via ``start()`` later)."""

    def __init__(self, scheduler: Scheduler, overcommit: float = 1.0,
                 max_pending: int | None = None, auto_start: bool = True):
        self.scheduler = scheduler
        self.overcommit = float(overcommit)
        self.max_pending = (
            2 * scheduler.num_slots if max_pending is None else max_pending
        )
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._futures: dict[int, Future] = {}
        self._closed = False
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None
        self.ticks = 0
        self.busy_s = 0.0
        if auto_start:
            self.start()

    # ------------------------------------------------------------------

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._worker, name="serve-frontend", daemon=True
            )
            self._thread.start()

    def submit(self, prompt, max_tokens: int = 16, temperature: float = 0.0,
               eos_id: int | None = None, seed: int | None = None,
               timeout: float | None = None) -> Future:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                if self._closed:
                    raise RuntimeError("front end is closed")
                if self._error is not None:
                    raise RuntimeError("serving worker died") from self._error
                if not self._backpressured(prompt, max_tokens):
                    break
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        "backpressure: page pool fully committed"
                    )
                self._space.wait(remaining)
            req = self.scheduler.submit(
                prompt, max_tokens, temperature=temperature, eos_id=eos_id,
                seed=seed,
            )
            fut: Future = Future()
            self._futures[req.rid] = fut
            self._work.notify_all()
        return fut

    def close(self, wait: bool = True) -> None:
        with self._lock:
            self._closed = True
            self._work.notify_all()
            self._space.notify_all()
        if wait and self._thread is not None:
            self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------------

    def _backpressured(self, prompt, max_tokens: int) -> bool:
        if len(self.scheduler.pending) >= self.max_pending:
            return True
        committed, usable = self.scheduler.committed_pages()
        needed = self.scheduler.pool.pages_needed(len(prompt) + max_tokens)
        return committed + needed > self.overcommit * usable

    def _worker(self) -> None:
        while True:
            with self._lock:
                while not self.scheduler.has_work():
                    if self._closed:
                        return
                    self._work.wait()
                t = time.perf_counter()
                try:
                    done = self.scheduler.step()
                except BaseException as e:  # fail every waiter, not just one
                    self._error = e
                    futs = list(self._futures.values())
                    self._futures.clear()
                    self._space.notify_all()
                    for f in futs:
                        f.set_exception(e)
                    return
                self.busy_s += time.perf_counter() - t
                self.ticks += 1
                futs = [
                    (self._futures.pop(r.rid, None), r) for r in done
                ]
                if done:
                    self._space.notify_all()
            for fut, req in futs:
                if fut is not None:
                    fut.set_result(req)
