"""Policy -> plan -> execute compression with its manifest (counterpart of
``repro.compression``).  Beside execute: the **delta** tier
(:mod:`repro_torch.compression.delta`) re-solves only the tiles that drifted
since a parent artifact, warm-started from its factors; the **streaming**
tier (:mod:`repro_torch.compression.streaming`) plans from metadata, probes
with SVD-tail surrogates and executes one leaf at a time under a host
budget, resumably.  The **autotuner**
(:mod:`repro_torch.compression.autotune`) allocates a byte budget across
tensors from probed rate-distortion curves."""

from repro_torch.compression.artifact import (
    MANIFEST_FORMAT,
    MANIFEST_NAME,
    CompressionArtifact,
)
from repro_torch.compression.autotune import (
    Allocation,
    AutotuneResult,
    BudgetInfeasibleError,
    allocate_budget,
    autotune_plan,
    calibration_weights,
    probe_tensors,
)
from repro_torch.compression.delta import (
    DEFAULT_DRIFT_THRESHOLD,
    ColdStartRequired,
    DeltaPlan,
    TensorDrift,
    compute_drift,
    delta_recompress,
    plan_delta,
)
from repro_torch.compression.execute import execute_plan
from repro_torch.compression.plan import (
    CompressionPlan,
    TensorPlan,
    plan_compression,
    tree_paths,
)
from repro_torch.compression.policy import DEFAULT_EXCLUDE, CompressionPolicy, CompressionRule
from repro_torch.compression.streaming import (
    CheckpointLeafSource,
    TreeLeafSource,
    execute_streaming,
    run_compression_job,
    streaming_autotune_plan,
    surrogate_probe,
)

__all__ = [
    "CompressionArtifact",
    "CompressionPlan",
    "CompressionPolicy",
    "CompressionRule",
    "DEFAULT_EXCLUDE",
    "MANIFEST_FORMAT",
    "MANIFEST_NAME",
    "TensorPlan",
    "execute_plan",
    "plan_compression",
    "tree_paths",
    "DEFAULT_DRIFT_THRESHOLD",
    "ColdStartRequired",
    "DeltaPlan",
    "TensorDrift",
    "compute_drift",
    "delta_recompress",
    "plan_delta",
    "Allocation",
    "AutotuneResult",
    "BudgetInfeasibleError",
    "allocate_budget",
    "autotune_plan",
    "calibration_weights",
    "probe_tensors",
    "CheckpointLeafSource",
    "TreeLeafSource",
    "execute_streaming",
    "run_compression_job",
    "streaming_autotune_plan",
    "surrogate_probe",
]
