"""Per-tensor degradation tables in eval-loss units.

Counterpart of ``repro/eval/metric_table.py``.  For every (tensor,
candidate) pair the probe stage trial-compressed, splice the trial
reconstruction into the live values tree (one leaf at a time, every other
tensor dense) and measure the eval-loss delta against the cached dense
baseline.  The trials are the probe's own (:class:`TrialSplice`): one
pooled solve serves both the Frobenius curve and the eval delta.

Far from the allocation boundary only the ordering of a tensor's
candidates matters, and the first-order surrogate

    delta_loss ~= alpha * calibration_weight * residual^2

preserves it.  Boundary detection runs the greedy allocator with each
tensor's Frobenius curve scaled by ``1 +- margin``: tensors whose chosen
point moves are measured exactly (at least two tensors always are), the
rest take the surrogate, with ``alpha`` fitted by least squares to the
exact measurements.  Sampled probes splice only the sampled tiles and
extrapolate the delta by ``1 / fraction``.
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from repro_torch.compression.autotune.allocate import _greedy, lower_hull, resolve_groups
from repro_torch.compression.autotune.probe import ProbeResult, RDPoint, probe_tensors
from repro_torch.compression.execute import _replace, _tensor_tiles
from repro_torch.compression.plan import tree_paths
from repro_torch.device import resolve_device

__all__ = [
    "MetricTable",
    "build_metric_table",
    "splice_values",
    "spliced_leaf",
]


def _untile(tiles, t) -> torch.Tensor:
    """Inverse of ``execute._tensor_tiles``: (num_tiles, tn, td) g-major
    tile stack -> the original leaf shape."""
    g, tn, td = t.groups, t.tile_n, t.tile_d
    r, c = t.d_in // tn, t.d_out // td
    out = tiles.reshape(g, r, c, tn, td).permute(0, 1, 3, 2, 4)
    return out.reshape(t.shape)


def spliced_leaf(leaf, t, trial):
    """``leaf`` with the trial's reconstructed tiles spliced in (the
    sampled indices only when the probe subsampled), cast back to the
    leaf's dtype."""
    tiles = _tensor_tiles(leaf, t, leaf.device).to(torch.float32)
    if trial.indices is None:
        tiles = trial.recon.to(leaf.device)
    else:
        tiles = tiles.clone()
        tiles[trial.indices.to(leaf.device)] = trial.recon.to(leaf.device)
    return _untile(tiles, t).to(leaf.dtype)


def splice_values(values, path: str, new_leaf):
    """``values`` with the leaf at ``path`` replaced: the same structure,
    every other leaf the same tensor object (splice and restore are
    bit-exact)."""
    if path not in {p for p, _ in tree_paths(values)}:
        raise KeyError(f"splice_values: {path!r} not in values tree")
    return _replace(values, {path: new_leaf})


def _boundary_paths(probes, budget_bytes, margin, group_budgets=()) -> set:
    """Tensors whose greedy choice moves when their own distortion curve is
    scaled by ``1 +- margin``.  Greedy is invariant to scaling ALL curves
    at once, so per-curve scaling isolates exactly the tensors whose
    allocation is sensitive to distortion mis-estimation — the ones where
    the Frobenius-to-eval-loss disagreement could change the answer."""
    hulls = {p.path: lower_hull(p.points) for p in probes}
    groups = resolve_groups(group_budgets, list(hulls))
    base_choice = _greedy(hulls, budget_bytes, groups)
    boundary = set()
    for path in hulls:
        for scale in (1.0 - margin, 1.0 + margin):
            scaled = dict(hulls)
            scaled[path] = [
                dataclasses.replace(pt, distortion=pt.distortion * scale)
                for pt in hulls[path]
            ]
            if _greedy(scaled, budget_bytes, groups)[path] != base_choice[path]:
                boundary.add(path)
                break
    return boundary


@dataclasses.dataclass(frozen=True)
class MetricTable:
    """Per-tensor x per-candidate eval-loss deltas, allocator-ready.

    ``entries[path]`` is a tuple of row dicts (tile_n, tile_d, K, method,
    bytes, resid2, delta, exact, sample_fraction); ``probes()`` re-expresses
    the table as :class:`ProbeResult` curves with the eval delta as the
    distortion, which the greedy/QUBO/LP allocators consume unchanged."""

    baseline: object           # EvalResult of the dense tree
    entries: dict              # path -> tuple(row dict)
    orig: dict                 # path -> {"orig_bytes": int, "weight": float}
    alpha: float               # fitted surrogate slope (0.0 when unfittable)
    surrogate_skip_rate: float
    exact_paths: tuple
    harness_info: dict
    build_s: float = 0.0       # wall-clock: NOT serialised (tables are
                               # deterministic per seed; walls are not)
    frobenius_probes: tuple = ()   # the probe stage's Frobenius curves
                                   # (diagnostics; not serialised)

    def probes(self) -> list:
        """Eval-loss RD curves: measured/surrogate deltas as distortion
        (clamped at 0 — a splice that *helps* the eval loss ties with
        dense), plus the dense fallback point."""
        out = []
        for path in sorted(self.entries):
            info = self.orig[path]
            pts = [
                RDPoint(
                    tile_n=row["tile_n"],
                    tile_d=row["tile_d"],
                    K=row["K"],
                    bytes=row["bytes"],
                    distortion=max(row["delta"], 0.0),
                    method=row["method"],
                )
                for row in self.entries[path]
            ]
            pts.append(
                RDPoint(tile_n=0, tile_d=0, K=0,
                        bytes=int(info["orig_bytes"]), distortion=0.0)
            )
            pts.sort(key=lambda p: (p.bytes, p.distortion))
            out.append(
                ProbeResult(
                    path=path,
                    orig_bytes=int(info["orig_bytes"]),
                    weight=float(info["weight"]),
                    points=tuple(pts),
                )
            )
        return out

    def to_dict(self) -> dict:
        return {
            "format": "repro.eval.metric_table/v1",
            "harness": dict(self.harness_info),
            "baseline": self.baseline.to_dict(),
            "alpha": self.alpha,
            "surrogate_skip_rate": self.surrogate_skip_rate,
            "exact_paths": sorted(self.exact_paths),
            "tensors": {
                path: {
                    "orig_bytes": int(self.orig[path]["orig_bytes"]),
                    "weight": float(self.orig[path]["weight"]),
                    "rows": [dict(r) for r in self.entries[path]],
                }
                for path in sorted(self.entries)
            },
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)


def build_metric_table(
    values,
    plan,
    harness,
    budget_bytes: int,
    *,
    seed: int = 0,
    device=None,
    weights: dict | None = None,
    max_probe_tiles: int | None = 16,
    tile_d_choices: int = 1,
    k_fractions: tuple | None = None,
    probe_bbo_iters: int | None = 8,
    backend: str | None = None,
    include_int8: bool = True,
    surrogate_margin: float = 0.25,
    group_budgets=(),
    verbose: bool = False,
) -> MetricTable:
    """Probe ``plan`` (keeping trials) and build the eval degradation table.

    ``budget_bytes`` drives boundary detection only — the allocation itself
    happens downstream on ``table.probes()``.  ``surrogate_margin <= 0``
    forces exact measurement everywhere."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    probe_kw = {} if k_fractions is None else {"k_fractions": tuple(k_fractions)}
    probes, trials = probe_tensors(
        values, plan, seed=seed, device=device, weights=weights,
        max_probe_tiles=max_probe_tiles, tile_d_choices=tile_d_choices,
        probe_bbo_iters=probe_bbo_iters, backend=backend,
        include_int8=include_int8, keep_trials=True, verbose=verbose,
        **probe_kw,
    )
    baseline = harness.baseline(values)

    if surrogate_margin > 0:
        exact_paths = _boundary_paths(
            probes, budget_bytes, surrogate_margin, group_budgets
        )
    else:
        exact_paths = {p.path for p in probes}
    # the alpha fit needs exact measurements: guarantee at least two
    # tensors measured (the heaviest weight x bytes ones — most damage,
    # best-conditioned fit)
    want = min(2, len(probes))
    if len(exact_paths) < want:
        for p in sorted(probes, key=lambda p: (-p.weight * p.orig_bytes, p.path)):
            exact_paths.add(p.path)
            if len(exact_paths) >= want:
                break

    leaves = dict(tree_paths(values))
    planned = {t.path: t for t in plan.tensors}
    weight_of = {p.path: float(p.weight) for p in probes}

    # -- exact pass: splice boundary tensors, measure, collect (x, y) ------
    entries: dict = {p.path: [] for p in probes}
    fit_x, fit_y = [], []
    n_exact = n_total = 0
    surrogate_rows = []     # (path, row) filled after the alpha fit
    for (path, tn, td, K, method), trial in sorted(trials.items()):
        t = planned[path]
        ct = dataclasses.replace(
            t, tile_n=tn, tile_d=td, num_tiles=trial.num_tiles
        )
        frac = (
            1.0 if trial.indices is None
            else int(trial.indices.shape[0]) / trial.num_tiles
        )
        row = {
            "tile_n": tn, "tile_d": td, "K": K, "method": method,
            "bytes": _candidate_bytes(probes, path, tn, td, K, method),
            "resid2": float(f"{trial.resid2:.8g}"),
            "sample_fraction": float(f"{frac:.8g}"),
        }
        n_total += 1
        if path in exact_paths:
            spliced = splice_values(
                values, path, spliced_leaf(leaves[path], ct, trial)
            )
            res = harness.evaluate(spliced)
            delta = (res.loss - baseline.loss) / frac
            row["delta"] = float(f"{delta:.8g}")
            row["exact"] = True
            fit_x.append(weight_of[path] * trial.resid2)
            fit_y.append(delta)
            n_exact += 1
            if verbose:
                print(
                    f"  eval splice {path} {method or 'mc'} {tn}x{td} "
                    f"K={K}: delta {delta:+.4g}"
                )
        else:
            row["exact"] = False
            surrogate_rows.append((path, row))
        entries[path].append(row)

    # -- surrogate pass: alpha from least squares over the exact rows ------
    sxx = sum(x * x for x in fit_x)
    alpha = max(sum(x * y for x, y in zip(fit_x, fit_y)) / sxx, 0.0) \
        if sxx > 0 else 0.0
    for path, row in surrogate_rows:
        row["delta"] = float(
            f"{alpha * weight_of[path] * row['resid2']:.8g}"
        )

    return MetricTable(
        baseline=baseline,
        entries={p: tuple(rows) for p, rows in entries.items()},
        orig={
            p.path: {"orig_bytes": int(p.orig_bytes), "weight": float(p.weight)}
            for p in probes
        },
        alpha=float(f"{alpha:.8g}"),
        surrogate_skip_rate=1.0 - n_exact / max(n_total, 1),
        exact_paths=tuple(sorted(exact_paths)),
        harness_info=harness.to_dict(),
        build_s=time.perf_counter() - t0,
        frobenius_probes=tuple(probes),
    )


def _candidate_bytes(probes, path, tn, td, K, method) -> int:
    for p in probes:
        if p.path != path:
            continue
        for pt in p.points:
            if pt.dense:
                continue
            if (pt.tile_n, pt.tile_d, pt.K, pt.method) == (tn, td, K, method):
                return int(pt.bytes)
    raise KeyError(f"no probed point for {path!r} ({tn}x{td} K={K} {method!r})")
