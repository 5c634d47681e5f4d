"""Open-loop Poisson load generation against the serving front end.

Counterpart of ``repro/serving/loadgen.py``.  ``run_load`` replays a
Poisson arrival process at a given QPS: each request is submitted at its
*intended* arrival time (open loop: a slow server does not slow the arrival
clock, it builds queueing delay), and per-request latency is measured from
the intended arrival to completion.  ``poisson_arrivals`` is numpy and
gives the reference's arrivals bit for bit.

Beside the reference's fields, ``LoadResult`` reports time to first token
(``t_first_token`` less the intended arrival: queueing, admission and
prefill) and the scheduler's ticks and decode ticks in the run, with the
front end's mean host time per tick.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["LoadResult", "poisson_arrivals", "run_load"]


@dataclasses.dataclass
class LoadResult:
    qps: float
    n_requests: int
    completed: int
    total_tokens: int
    makespan_s: float
    goodput_toks_per_s: float
    offered_toks_per_s: float
    p50_latency_s: float
    p99_latency_s: float
    mean_latency_s: float
    peak_running: int
    evictions: int
    p50_ttft_s: float = 0.0
    p99_ttft_s: float = 0.0
    ticks: int = 0
    decode_ticks: int = 0
    mean_tick_ms: float = 0.0

    def to_row(self) -> dict:
        return dataclasses.asdict(self)


def poisson_arrivals(n: int, qps: float, seed: int = 0) -> np.ndarray:
    """(n,) arrival offsets in seconds from t0 (exponential inter-arrivals)."""
    if n < 0:
        raise ValueError(f"poisson_arrivals: n must be >= 0, got {n}")
    if not qps > 0.0:
        raise ValueError(
            f"poisson_arrivals: qps must be > 0, got {qps!r} "
            "(an open-loop Poisson process needs a positive rate)"
        )
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / qps, size=n))


def run_load(frontend, prompts, max_tokens: int, qps: float, seed: int = 0,
             temperature: float = 0.0, eos_id: int | None = None) -> LoadResult:
    """Submit ``prompts`` with Poisson(qps) arrivals, wait for completion,
    return latency/goodput statistics.  ``frontend.scheduler.stats`` should
    be reset (and the scheduler idle) before calling for clean counters."""
    arrivals = poisson_arrivals(len(prompts), qps, seed=seed)
    stats = frontend.scheduler.stats
    ev0, steps0, dec0 = stats.evictions, stats.steps, stats.decode_steps
    ticks0, busy0 = frontend.ticks, frontend.busy_s
    t0 = time.perf_counter()
    pending = []
    for prompt, at in zip(prompts, arrivals):
        delay = at - (time.perf_counter() - t0)
        if delay > 0:
            time.sleep(delay)
        fut = frontend.submit(
            prompt, max_tokens=max_tokens, temperature=temperature,
            eos_id=eos_id,
        )
        pending.append((fut, t0 + at))
    lat, ttft, total_tokens, last_done = [], [], 0, t0
    completed = 0
    for fut, intended in pending:
        req = fut.result()
        completed += 1
        total_tokens += len(req.tokens)
        lat.append(req.t_done - intended)
        ttft.append(req.t_first_token - intended)
        last_done = max(last_done, req.t_done)
    makespan = max(last_done - t0, 1e-9)
    lat_a = np.asarray(lat) if lat else np.asarray([0.0])
    ttft_a = np.asarray(ttft) if ttft else np.asarray([0.0])
    ticks = frontend.ticks - ticks0
    return LoadResult(
        qps=qps,
        n_requests=len(prompts),
        completed=completed,
        total_tokens=total_tokens,
        makespan_s=makespan,
        goodput_toks_per_s=total_tokens / makespan,
        offered_toks_per_s=qps * max_tokens,
        p50_latency_s=float(np.percentile(lat_a, 50)),
        p99_latency_s=float(np.percentile(lat_a, 99)),
        mean_latency_s=float(lat_a.mean()),
        peak_running=stats.peak_running,
        evictions=stats.evictions - ev0,
        p50_ttft_s=float(np.percentile(ttft_a, 50)),
        p99_ttft_s=float(np.percentile(ttft_a, 99)),
        ticks=stats.steps - steps0,
        decode_ticks=stats.decode_steps - dec0,
        mean_tick_ms=1e3 * (frontend.busy_s - busy0) / max(ticks, 1),
    )
