"""Compression policy: global defaults + ordered per-path rules.

A :class:`CompressionPolicy` decides, for every tensor path in a model
values tree, *whether* and *how* it is compressed — method, tile geometry,
rank ratio, size floor.  Rules are ordered regex matches over the tensor
path ("first match wins"), so MoE expert stacks, attention projections and
embeddings can each get their own treatment:

    policy = CompressionPolicy(
        method="alternating", tile_n=32, tile_d=128, rank_ratio=0.125,
        rules=(
            CompressionRule(pattern=r"experts", tile_d=64, rank_ratio=0.25),
            CompressionRule(pattern=r"attn/w[qo]", method="bbo", bbo_iters=32),
            CompressionRule(pattern=r"w2$", method="skip"),
        ),
    )

Policies are plain frozen dataclasses with a stable JSON form
(:meth:`to_json` / :meth:`from_json`) so they can be checked into a repo,
passed to ``repro_torch.launch.compress --policy policy.json`` and embedded in the
artifact manifest.  The one-rule adapter for the legacy
``configs.base.CompressionConfig`` lives in :meth:`from_config`.
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import NamedTuple

__all__ = [
    "CompressionRule",
    "CompressionPolicy",
    "ResolvedSettings",
    "DEFAULT_EXCLUDE",
    "DEFAULT_TARGETS",
]

# Paths containing any of these substrings are never compressed (norm scales,
# router logits, embeddings, conv stems and SSM scalars are structurally
# unsuited to tile decomposition).  Overridable per policy.
DEFAULT_EXCLUDE = ("norm", "router", "embed", "conv", "A_log", "dt_bias", "D")

# A tensor path must match one of these regexes to be a compression
# candidate at all.  The defaults cover the two weight layouts in the model
# zoo: plain dense layers store their matrix under a ``.../w`` leaf, and MoE
# blocks store per-expert stacks directly as ``.../gate``, ``.../up`` and
# ``.../down`` (E, d_in, d_out) arrays (stacked to 4D under the layer-group
# scan).  Overridable per policy — the predicate is policy data, not code.
DEFAULT_TARGETS = (r"/w$", r"/(gate|up|down)$")

# "int8" is the plain symmetric per-tile integer-quantisation baseline
# (no solver, closed form — core.compress.quantize_tile_batch).  It exists
# so the byte-budget allocator's baseline column is executable, not
# hypothetical (docs/eval.md).
_METHODS = ("greedy", "alternating", "bbo", "int8", "skip")


class ResolvedSettings(NamedTuple):
    """The per-tensor outcome of policy resolution."""

    method: str
    tile_n: int
    tile_d: int
    rank_ratio: float
    min_size: int
    bbo_iters: int
    rule: str  # pattern of the matched rule, or "" for policy defaults


@dataclasses.dataclass(frozen=True)
class CompressionRule:
    """One ordered rule: a regex over the tensor path plus overrides.

    Unset fields (None) inherit the policy defaults.  ``method="skip"``
    makes matching tensors stay dense.
    """

    pattern: str
    method: str | None = None
    tile_n: int | None = None
    tile_d: int | None = None
    rank_ratio: float | None = None
    min_size: int | None = None
    bbo_iters: int | None = None

    def __post_init__(self):
        re.compile(self.pattern)  # fail fast on bad regexes
        if self.method is not None and self.method not in _METHODS:
            raise ValueError(
                f"rule {self.pattern!r}: unknown method {self.method!r} "
                f"(expected one of {_METHODS})"
            )

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Global defaults + ordered rules.  See the module docstring."""

    method: str = "alternating"     # greedy | alternating | bbo
    tile_n: int = 32                # rows per tile (N in the paper)
    tile_d: int = 128               # cols per tile (D in the paper)
    rank_ratio: float = 0.125       # K / tile_n
    min_size: int = 1 << 16         # tensors below this many elems stay dense
    bbo_iters: int = 64             # BBO refinement iterations
    solver_backend: str = "auto"    # Ising backend for bbo: auto|cuda|torch
    exclude: tuple = DEFAULT_EXCLUDE
    targets: tuple = DEFAULT_TARGETS  # path regexes: candidates must match one
    rules: tuple = ()               # ordered CompressionRule, first match wins
    group_budgets: tuple = ()       # (path regex, byte cap) per layer group —
                                    # honoured by the budget allocators
                                    # (greedy/QUBO/LP, docs/eval.md)

    def __post_init__(self):
        if self.method not in _METHODS[:-1]:
            raise ValueError(f"unknown default method {self.method!r}")
        object.__setattr__(self, "exclude", tuple(self.exclude))
        object.__setattr__(self, "targets", tuple(self.targets))
        object.__setattr__(self, "rules", tuple(self.rules))
        object.__setattr__(
            self,
            "group_budgets",
            tuple((str(p), int(b)) for p, b in self.group_budgets),
        )
        for t in self.targets:
            re.compile(t)           # fail fast on bad regexes
        for p, b in self.group_budgets:
            re.compile(p)
            if b <= 0:
                raise ValueError(f"group budget {p!r}: bytes must be > 0")

    # -- resolution ---------------------------------------------------------
    def matches_target(self, path: str) -> bool:
        """Whether ``path`` is a compression candidate at all.  This replaces
        the old hardcoded ``path.endswith("/w")`` predicate: what counts as a
        weight is policy data, so MoE expert stacks (``gate``/``up``/``down``)
        are first-class targets and projects can scope targets freely."""
        return any(re.search(t, path) for t in self.targets)

    def resolve(self, path: str) -> ResolvedSettings | None:
        """Settings for ``path``, or None (with no settings) when a policy
        decision keeps it dense.  Structural checks (shape, divisibility,
        min_size) happen later, in ``plan_compression``."""
        if any(tok in path for tok in self.exclude):
            return None
        rule = next((r for r in self.rules if r.matches(path)), None)
        if rule is not None and rule.method == "skip":
            return None
        get = lambda field: (
            getattr(rule, field) if rule is not None and getattr(rule, field) is not None
            else getattr(self, field)
        )
        return ResolvedSettings(
            method=get("method"),
            tile_n=get("tile_n"),
            tile_d=get("tile_d"),
            rank_ratio=get("rank_ratio"),
            min_size=get("min_size"),
            bbo_iters=get("bbo_iters"),
            rule=rule.pattern if rule is not None else "",
        )

    def skip_reason(self, path: str) -> str:
        """Why ``resolve`` returned None (or the path is not a target).
        Exclusion wins over target mismatch: it names the specific token."""
        if any(tok in path for tok in self.exclude):
            toks = [t for t in self.exclude if t in path]
            return f"excluded ({toks[0]})"
        rule = next((r for r in self.rules if r.matches(path)), None)
        if rule is not None and rule.method == "skip":
            return f"rule {rule.pattern!r} -> skip"
        if not self.matches_target(path):
            return "not matched by policy"
        return "not skipped"

    # -- serialisation ------------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["exclude"] = list(self.exclude)
        d["targets"] = list(self.targets)
        d["rules"] = [
            {k: v for k, v in dataclasses.asdict(r).items() if v is not None}
            for r in self.rules
        ]
        d["group_budgets"] = [[p, int(b)] for p, b in self.group_budgets]
        return d

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_dict(cls, d: dict) -> "CompressionPolicy":
        d = dict(d)
        d["exclude"] = tuple(d.get("exclude", DEFAULT_EXCLUDE))
        d["targets"] = tuple(d.get("targets", DEFAULT_TARGETS))
        d["rules"] = tuple(
            CompressionRule(**r) for r in d.get("rules", ())
        )
        d["group_budgets"] = tuple(
            (p, int(b)) for p, b in d.get("group_budgets", ())
        )
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "CompressionPolicy":
        return cls.from_dict(json.loads(s))

    # -- legacy adapter -----------------------------------------------------
    @classmethod
    def from_config(cls, ccfg) -> "CompressionPolicy":
        """One-rule adapter for ``configs.base.CompressionConfig``: the whole
        tree gets the config's single method/tile/rank."""
        return cls(
            method=ccfg.optimizer,
            tile_n=ccfg.tile_n,
            tile_d=ccfg.tile_d,
            rank_ratio=ccfg.rank_ratio,
            min_size=ccfg.min_size,
            bbo_iters=ccfg.bbo_iters,
            solver_backend=ccfg.solver_backend,
        )
