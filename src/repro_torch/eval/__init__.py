"""Task-metric evaluation: compression damage in eval-loss units.

Counterpart of ``repro/eval``.  The Frobenius objective the autotuner
minimises is a weight-space proxy; this package measures the model's eval
loss on a deterministic batch set and turns per-tensor degradation tables
into rate-distortion curves the budget allocators consume unchanged:

- :mod:`.harness`: the deterministic eval-batch runner with a baseline
  cache (the dense forward runs once per (cfg, seed, batches, values)).
- :mod:`.metric_table`: per-tensor x per-(K, tile_d, method) eval-loss
  deltas from splicing the probe's trial compressions into the live tree,
  with a first-order surrogate away from the allocation boundary.
- :mod:`.allocate_lp`: the exact MCKP reference allocator (branch and
  bound over the hulls) that cross-checks the greedy and QUBO engines.

Wired through ``autotune_plan(..., objective="eval_loss")``.
"""

from repro_torch.eval.allocate_lp import cross_check_lp, solve_mckp
from repro_torch.eval.harness import EvalHarness, EvalResult, clear_baseline_cache
from repro_torch.eval.metric_table import MetricTable, build_metric_table

__all__ = [
    "EvalHarness",
    "EvalResult",
    "MetricTable",
    "build_metric_table",
    "clear_baseline_cache",
    "cross_check_lp",
    "solve_mckp",
]
