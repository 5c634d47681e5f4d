"""Rate-distortion autotuner: compress to a byte budget.

Counterpart of ``repro/compression/autotune``.  Turns "compress with these
settings" into "compress to this budget":

  1. **probe**     trial-compress a deterministic tile subsample per tensor
     over a (K, tile) candidate grid through the execute stage's pieces, to
     fit per-tensor rate-distortion curves (:func:`probe_tensors`),
     optionally weighted by calibration sensitivity
     (:func:`calibration_weights`).
  2. **allocate**  minimise total predicted distortion under a global
     compressed-bytes budget (:func:`allocate_budget`): greedy water-filling,
     or a one-hot QUBO annealed by K1 in one batched solve.
  3. **refine**    emit the allocation as exact-path policy rules, re-plan,
     and attach the autotune metadata the manifest carries
     (:func:`autotune_plan`).

Entry points: ``plan_compression(values, policy, budget_bytes=...)``,
``compress_model(..., budget_bytes=...)``,
``python -m repro_torch.launch.compress --budget-mb``.
"""

from repro_torch.compression.autotune.allocate import (
    Allocation,
    BudgetInfeasibleError,
    allocate_budget,
    lower_hull,
    resolve_groups,
)
from repro_torch.compression.autotune.calibrate import (
    calibration_inputs,
    calibration_weights,
)
from repro_torch.compression.autotune.probe import (
    ProbeResult,
    RDPoint,
    TrialSplice,
    candidate_settings,
    probe_tensors,
)
from repro_torch.compression.autotune.refine import (
    AutotuneResult,
    allocation_rules,
    autotune_plan,
)

__all__ = [
    "RDPoint",
    "ProbeResult",
    "TrialSplice",
    "candidate_settings",
    "probe_tensors",
    "calibration_inputs",
    "calibration_weights",
    "Allocation",
    "BudgetInfeasibleError",
    "allocate_budget",
    "lower_hull",
    "resolve_groups",
    "AutotuneResult",
    "allocation_rules",
    "autotune_plan",
]
