"""Serving tier (counterpart of ``repro.serving``): fixed-batch engine,
continuous-batching scheduler over a paged KV cache, and the async front
end + load generator that drive it."""

from repro_torch.serving.engine import (
    Engine,
    cache_shardings,
    make_decode_step,
    make_prefill,
    make_prefill_chunk,
)
from repro_torch.serving.frontend import ServeFrontend
from repro_torch.serving.kv_pages import PagePool
from repro_torch.serving.loadgen import LoadResult, poisson_arrivals, run_load
from repro_torch.serving.scheduler import Request, Scheduler, SchedulerStats

__all__ = [
    "Engine",
    "cache_shardings",
    "make_decode_step",
    "make_prefill",
    "make_prefill_chunk",
    "PagePool",
    "Scheduler",
    "SchedulerStats",
    "Request",
    "ServeFrontend",
    "LoadResult",
    "poisson_arrivals",
    "run_load",
]
