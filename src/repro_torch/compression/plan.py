"""Plan stage: a pure, serialisable description of a compression run.

Counterpart of ``repro/compression/plan.py``.  ``plan_compression(values,
policy)`` walks a values tree (nested dicts of tensors, or of ``meta``
tensors: only shapes and dtypes are read) and produces a
:class:`CompressionPlan` with per-tensor tile geometry, method and
predicted bytes.  For the same tree and policy the plan's JSON is byte for
byte the one ``repro`` writes: leaves are enumerated in the same order
(sorted dict keys, as JAX flattens a dict) and dtypes carry numpy names.
With ``budget_bytes`` planning becomes the rate-distortion autotune of
:mod:`repro_torch.compression.autotune`.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from repro_torch.compression.policy import CompressionPolicy
from repro_torch.core.compress import pick_tile
from repro_torch.device import dtype_name
from repro_torch.launch import costing

__all__ = ["TensorPlan", "CompressionPlan", "plan_compression", "tree_paths", "tree_rebuild"]

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

    def total_bytes(self) -> int:
        """Predicted post-compression bytes of the planned tensors (skipped
        tensors keep their dense bytes and are out of the accounting)."""
        return self.total_pred_bytes

    @property
    def compression_ratio(self) -> float:
        """Predicted orig/compressed byte ratio over the planned tensors."""
        return self.pred_ratio

    def skip_summary(self) -> dict:
        """Distinct skip reasons -> count, in order of first occurrence;
        per-path ``rule ... -> skip`` reasons collapse into one
        ``rule -> skip`` bucket."""
        out: dict = {}
        for _, reason in self.skipped:
            if reason.startswith("rule ") and reason.endswith("-> skip"):
                reason = "rule -> skip"
            out[reason] = out.get(reason, 0) + 1
        return out

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
            f"{self.total_bytes() / 2**20:.2f} MiB "
            f"(predicted x{self.compression_ratio:.2f})"
        ]
        skips = self.skip_summary()
        if skips:
            lines.append("  skips: " + ", ".join(f"{r} x{n}" for r, n in skips.items()))
        if self.autotune:
            # the autotune block is free-form dict data: a partial one must
            # not crash the printable form
            a = self.autotune
            lines.append(
                f"  autotune[{a.get('engine', '?')}]: budget "
                f"{a.get('budget_bytes', 0) / 2**20:.2f} MiB, allocated "
                f"{a.get('predicted_bytes', 0) / 2**20:.2f} MiB, predicted "
                f"distortion {a.get('predicted_distortion', float('nan')):.4g}"
                + (" (calibrated)" if a.get("calibrated") else "")
            )
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

    def diff(self, other: "CompressionPlan") -> list:
        """Per-path differences from ``other``: ``+`` only there, ``-`` only
        here, ``~`` the TensorPlan fields that differ."""
        mine = {t.path: t for t in self.tensors}
        theirs = {t.path: t for t in other.tensors}
        out = []
        for path in sorted(set(mine) | set(theirs)):
            a, b = mine.get(path), theirs.get(path)
            if a is None:
                out.append(f"+ {path}: only in other")
            elif b is None:
                out.append(f"- {path}: only in self")
            elif a != b:
                fields = [f.name for f in dataclasses.fields(TensorPlan)
                          if getattr(a, f.name) != getattr(b, f.name)]
                out.append(f"~ {path}: {', '.join(fields)}")
        return out

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
    sorted, a NamedTuple's fields by name in field order and other sequences
    by index, exactly as ``jax.tree_util`` flattens and ``repro``'s
    checkpointer names them, so leaf indices (which seed the per-tensor
    draws) and checkpoint leaf names agree with ``repro``."""
    if isinstance(values, dict):
        out = []
        for k in sorted(values):
            out.extend(tree_paths(values[k], f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(values, tuple) and hasattr(values, "_fields"):
        out = []
        for k in values._fields:
            out.extend(tree_paths(getattr(values, k), f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(values, (list, tuple)):
        out = []
        for i, v in enumerate(values):
            out.extend(tree_paths(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    if values is None:
        return []
    return [(prefix, values)]


def tree_rebuild(like, leaves: dict, prefix: str = ""):
    """``like``'s structure (dicts, NamedTuples, lists, tuples) with each
    leaf replaced by ``leaves[path]``, paths as ``tree_paths`` names them."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: tree_rebuild(v, leaves, sub(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(tree_rebuild(getattr(like, k), leaves, sub(k))
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(tree_rebuild(v, leaves, sub(i)) for i, v in enumerate(like))
    return None if like is None else leaves[prefix]


def _structurally_plausible(leaf) -> bool:
    return getattr(leaf, "ndim", 0) in (2, 3, 4) and leaf.dtype.is_floating_point


def plan_compression(values, policy: CompressionPolicy, *, budget_bytes: int | None = None,
                     **autotune_kw) -> CompressionPlan:
    """Pure planning pass: no solver runs, only shapes and dtypes are read.

    With ``budget_bytes``, planning becomes a rate-distortion autotune
    (:func:`repro_torch.compression.autotune.autotune_plan`): trial
    compressions probe per-tensor RD curves and a budget allocator picks
    per-tensor settings so the compressed total fits the budget; no longer
    pure, but deterministic per ``seed``.  Extra keyword arguments
    (``engine``, ``seed``, ``device``, ``cfg``, ``calibration``,
    ``max_probe_tiles``, ...) go to ``autotune_plan``."""
    if budget_bytes is not None:
        from repro_torch.compression.autotune import autotune_plan

        return autotune_plan(values, policy, budget_bytes, **autotune_kw).plan
    if autotune_kw:
        raise TypeError(
            f"plan_compression: {sorted(autotune_kw)} only apply with budget_bytes"
        )
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
