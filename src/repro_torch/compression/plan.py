"""Plan stage: a pure, serialisable description of a compression run.

Counterpart of ``repro/compression/plan.py``.  ``plan_compression(values,
policy)`` walks a values tree (nested dicts of tensors, or of ``meta``
tensors: only shapes and dtypes are read) and produces a
:class:`CompressionPlan` with per-tensor tile geometry, method and
predicted bytes.  For the same tree and policy the plan's JSON is byte for
byte the one ``repro`` writes: leaves are enumerated in the same order
(sorted dict keys, as JAX flattens a dict) and dtypes carry numpy names.
The budget autotuner (``budget_bytes``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.compression.policy import CompressionPolicy
from repro_torch.core.compress import pick_tile
from repro_torch.device import dtype_name
from repro_torch.launch import costing

__all__ = ["TensorPlan", "CompressionPlan", "plan_compression", "tree_paths"]

_BBO_TILE_N_WANT = 8
_BBO_TILE_N_MAX = 16


@dataclasses.dataclass(frozen=True)
class TensorPlan:
    """How one eligible tensor will be compressed (see ``repro``'s)."""

    path: str
    leaf_index: int
    shape: tuple
    dtype: str
    groups: int
    tile_n: int
    tile_d: int
    K: int
    method: str
    rule: str
    num_tiles: int
    orig_bytes: int
    pred_bytes: int
    bbo_iters: int = 0

    @property
    def pred_ratio(self) -> float:
        return self.orig_bytes / max(self.pred_bytes, 1)

    @property
    def d_in(self) -> int:
        return self.shape[-2]

    @property
    def d_out(self) -> int:
        return self.shape[-1]

    @property
    def pool_key(self) -> tuple:
        return (self.tile_n, self.tile_d, self.K, self.method, self.bbo_iters)


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    tensors: tuple        # ordered TensorPlan (leaf order)
    skipped: tuple        # ((path, reason), ...)
    policy: CompressionPolicy
    autotune: dict | None = None

    @property
    def total_orig_bytes(self) -> int:
        return sum(t.orig_bytes for t in self.tensors)

    @property
    def total_pred_bytes(self) -> int:
        return sum(t.pred_bytes for t in self.tensors)

    @property
    def pred_ratio(self) -> float:
        return self.total_orig_bytes / max(self.total_pred_bytes, 1)

    def pools(self) -> dict:
        """pool_key -> list[TensorPlan], insertion-ordered."""
        out: dict = {}
        for t in self.tensors:
            out.setdefault(t.pool_key, []).append(t)
        return out

    def summary(self) -> str:
        lines = [
            f"CompressionPlan: {len(self.tensors)} tensors, "
            f"{len(self.skipped)} skipped, "
            f"{self.total_orig_bytes / 2**20:.2f} -> "
            f"{self.total_pred_bytes / 2**20:.2f} MiB "
            f"(predicted x{self.pred_ratio:.2f})"
        ]
        for t in self.tensors:
            rule = f"  [{t.rule}]" if t.rule else ""
            lines.append(
                f"  {t.path:48s} {t.method:11s} tile {t.tile_n}x{t.tile_d} "
                f"K={t.K} tiles={t.num_tiles} x{t.pred_ratio:.1f}{rule}"
            )
        for key, members in self.pools().items():
            tn, td, K, method = key[:4]
            lines.append(
                f"  pool {method} {tn}x{td} K={K}: "
                f"{sum(m.num_tiles for m in members)} tiles "
                f"from {len(members)} tensors"
            )
        for path, reason in self.skipped:
            lines.append(f"  [skip] {path}: {reason}")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        d = {
            "format": "repro.compression.plan/v1",
            "policy": self.policy.to_dict(),
            "tensors": [
                {**dataclasses.asdict(t), "shape": list(t.shape)}
                for t in self.tensors
            ],
            "skipped": [list(s) for s in self.skipped],
        }
        if self.autotune is not None:
            d["autotune"] = self.autotune
        return d

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionPlan":
        tensors = tuple(
            TensorPlan(**{**t, "shape": tuple(t["shape"])}) for t in d["tensors"]
        )
        skipped = tuple((p, r) for p, r in d["skipped"])
        return cls(tensors, skipped, CompressionPolicy.from_dict(d["policy"]),
                   d.get("autotune"))

    @classmethod
    def from_json(cls, s: str) -> "CompressionPlan":
        return cls.from_dict(json.loads(s))


def tree_paths(values, prefix: str = ""):
    """[(path, leaf)] in flat leaf order with "/"-joined keys: dict keys
    sorted and sequences by index, exactly as ``jax.tree_util`` flattens,
    so leaf indices (which seed the per-tensor draws) agree with ``repro``."""
    if isinstance(values, dict):
        out = []
        for k in sorted(values):
            out.extend(tree_paths(values[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(values, (list, tuple)):
        out = []
        for i, v in enumerate(values):
            out.extend(tree_paths(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    if values is None:
        return []
    return [(prefix, values)]


def _structurally_plausible(leaf) -> bool:
    return getattr(leaf, "ndim", 0) in (2, 3, 4) and leaf.dtype.is_floating_point


def plan_compression(values, policy: CompressionPolicy) -> CompressionPlan:
    """Pure planning pass: no solver runs, only shapes and dtypes are read."""
    tensors, skipped = [], []
    for i, (path, leaf) in enumerate(tree_paths(values)):
        if not isinstance(leaf, torch.Tensor) or not _structurally_plausible(leaf):
            continue
        if not policy.matches_target(path):
            skipped.append((path, policy.skip_reason(path)))
            continue
        settings = policy.resolve(path)
        if settings is None:
            skipped.append((path, policy.skip_reason(path)))
            continue
        groups = 1
        for s in leaf.shape[:-2]:
            groups *= int(s)
        d_in, d_out = int(leaf.shape[-2]), int(leaf.shape[-1])
        if d_in * d_out < settings.min_size:
            skipped.append((path, "below min_size"))
            continue
        if settings.method == "bbo":
            tn = pick_tile(d_in, _BBO_TILE_N_WANT, max_tile=_BBO_TILE_N_MAX)
        else:
            tn = pick_tile(d_in, settings.tile_n)
        td = pick_tile(d_out, settings.tile_d)
        if tn is None or td is None:
            skipped.append((path, f"indivisible dims {tuple(int(s) for s in leaf.shape)}"))
            continue
        itemsize = leaf.element_size()
        if settings.method == "int8":
            K = 0
            pred_bytes = costing.int8_weight_bytes(d_in, d_out, tn, td, groups=groups)
        else:
            K = max(int(round(settings.rank_ratio * tn)), 1)
            if K >= tn:
                skipped.append((path, "K >= tile_n (no compression)"))
                continue
            pred_bytes = costing.compressed_weight_bytes(
                d_in, d_out, tn, td, K, itemsize, groups=groups
            )
        tensors.append(TensorPlan(
            path=path,
            leaf_index=i,
            shape=tuple(int(s) for s in leaf.shape),
            dtype=dtype_name(leaf.dtype),
            groups=int(groups),
            tile_n=tn,
            tile_d=td,
            K=K,
            method=settings.method,
            rule=settings.rule,
            num_tiles=int(groups * (d_in // tn) * (d_out // td)),
            orig_bytes=costing.dense_weight_bytes(leaf.shape, itemsize),
            pred_bytes=pred_bytes,
            bbo_iters=settings.bbo_iters if settings.method == "bbo" else 0,
        ))
    return CompressionPlan(tuple(tensors), tuple(skipped), policy)
