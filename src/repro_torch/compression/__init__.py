"""Policy -> plan -> execute compression with its manifest (counterpart of
``repro.compression``)."""

from repro_torch.compression.artifact import (
    MANIFEST_FORMAT,
    MANIFEST_NAME,
    CompressionArtifact,
)
from repro_torch.compression.execute import execute_plan
from repro_torch.compression.plan import (
    CompressionPlan,
    TensorPlan,
    plan_compression,
    tree_paths,
)
from repro_torch.compression.policy import CompressionPolicy, CompressionRule

__all__ = [
    "CompressionArtifact",
    "CompressionPlan",
    "CompressionPolicy",
    "CompressionRule",
    "MANIFEST_FORMAT",
    "MANIFEST_NAME",
    "TensorPlan",
    "execute_plan",
    "plan_compression",
    "tree_paths",
]
