"""Plan integration: turn an allocation into policy rules and a refined plan.

Counterpart of ``repro/compression/autotune/refine.py``.  The allocator's
per-tensor choices become exact-path :class:`CompressionRule` overrides
prepended to the base policy (first match wins), the re-planned tree is
verified to reproduce the allocation tensor for tensor, and the refined
plan carries the ``autotune`` metadata block, key for key the reference's
(``execute_plan`` copies it into the manifest).  For the same allocation
the refined plan's JSON is byte for byte the reference's: its
``calibration.key`` is ``[0, seed]``, which is what the reference writes
for ``PRNGKey(seed)`` at 32-bit seeds.
"""

from __future__ import annotations

import dataclasses
import re
import time

from repro_torch.compression.autotune.allocate import Allocation, allocate_budget
from repro_torch.compression.autotune.calibrate import calibration_weights
from repro_torch.compression.autotune.probe import probe_tensors
from repro_torch.compression.plan import CompressionPlan, plan_compression
from repro_torch.compression.policy import CompressionPolicy, CompressionRule
from repro_torch.device import resolve_device

__all__ = ["AutotuneResult", "allocation_rules", "autotune_plan"]


@dataclasses.dataclass(frozen=True)
class AutotuneResult:
    """Everything the autotuner decided: the refined plan (with ``autotune``
    metadata attached), the rule-based policy that reproduces it, the raw
    allocation and the probed RD curves.  Wall-clock diagnostics live here,
    not in the plan metadata (plans are deterministic per seed)."""

    plan: CompressionPlan
    policy: CompressionPolicy
    allocation: Allocation
    probes: tuple
    weights: dict | None
    probe_s: float = 0.0
    metric_table: object = None   # eval_loss objective only (MetricTable)
    lp_check: dict | None = None
    calibrate_s: float = 0.0


def allocation_rules(allocation: Allocation, base_plan: CompressionPlan) -> tuple:
    """Exact-path rules realising the allocation: dense choices become
    ``method="skip"``, compressed choices pin (tile_n, tile_d) and encode K
    as ``rank_ratio = K / tile_n`` (exact under the planner's rounding).

    The method (and BBO refinement budget) each tensor resolved to in the
    *base* plan is pinned too — first-match-wins means an exact-path rule
    shadows whatever base rule granted a tensor e.g. ``method="bbo"``, and
    without re-stating it the tensor would silently revert to the policy
    default method (probed with one solver, executed with another)."""
    base = {t.path: t for t in base_plan.tensors}
    rules = []
    for path, pt in sorted(allocation.choices.items()):
        pattern = f"^{re.escape(path)}$"
        if pt.dense:
            rules.append(CompressionRule(pattern=pattern, method="skip"))
        elif pt.method == "int8":
            # the plain-quantisation baseline column: closed-form, no rank
            rules.append(
                CompressionRule(
                    pattern=pattern,
                    method="int8",
                    tile_n=pt.tile_n,
                    tile_d=pt.tile_d,
                )
            )
        else:
            t = base[path]
            rules.append(
                CompressionRule(
                    pattern=pattern,
                    method=t.method,
                    tile_n=pt.tile_n,
                    tile_d=pt.tile_d,
                    rank_ratio=pt.K / pt.tile_n,
                    bbo_iters=t.bbo_iters if t.method == "bbo" else None,
                )
            )
    return tuple(rules)


def _verify_refined(
    refined: CompressionPlan,
    allocation: Allocation,
    base_plan: CompressionPlan,
) -> None:
    planned = {t.path: t for t in refined.tensors}
    base = {t.path: t for t in base_plan.tensors}
    for path, pt in allocation.choices.items():
        if pt.dense:
            if path in planned:
                raise RuntimeError(
                    f"autotune: {path} allocated dense but re-planned "
                    "compressed"
                )
            continue
        t = planned.get(path)
        if t is None:
            raise RuntimeError(
                f"autotune: {path} allocated {pt} but dropped by the "
                "refined plan"
            )
        if (t.tile_n, t.tile_d, t.K) != (pt.tile_n, pt.tile_d, pt.K):
            raise RuntimeError(
                f"autotune: refined plan geometry "
                f"({t.tile_n}, {t.tile_d}, {t.K}) != allocated "
                f"({pt.tile_n}, {pt.tile_d}, {pt.K}) at {path}"
            )
        # "" inherits the base plan's method; "int8" pins the baseline
        want_method = pt.method or base[path].method
        if t.method != want_method:
            raise RuntimeError(
                f"autotune: refined plan method {t.method!r} != probed "
                f"method {want_method!r} at {path}"
            )


def autotune_plan(
    values,
    policy: CompressionPolicy,
    budget_bytes: int,
    *,
    seed: int = 0,
    device=None,
    engine: str = "greedy",
    objective: str = "frobenius",
    cfg=None,
    calibration=False,
    calibration_inputs: dict | None = None,
    calib_batches: int = 1,
    eval_batches: int = 4,
    eval_batch: int = 2,
    eval_seq: int = 32,
    eval_seed: int = 0,
    surrogate_margin: float = 0.25,
    int8_baseline: bool | None = None,
    lp_check: bool | None = None,
    lp_tolerance: float = 0.05,
    max_probe_tiles: int | None = 16,
    tile_d_choices: int = 1,
    k_fractions: tuple | None = None,
    probe_bbo_iters: int | None = 8,
    backend: str | None = None,
    num_sweeps: int = 96,
    num_reads: int = 8,
    verbose: bool = False,
) -> AutotuneResult:
    """Probe, allocate, and re-plan ``values`` to fit ``budget_bytes``, on
    ``device`` (default: the GPU).

    The budget covers every eligible tensor in its chosen form (a tensor
    left dense is charged its dense bytes).  ``engine`` is "greedy" or
    "qubo" (cross-checked against greedy, the gap recorded);
    ``calibration`` weights distortion by activation sensitivity from
    ``calib_batches`` batches (needs ``cfg``).  ``objective`` "eval_loss"
    allocates against eval-loss deltas measured by
    :mod:`repro_torch.eval` (needs ``cfg``; ``eval_*`` fix its harness,
    ``surrogate_margin`` how far from the allocation boundary the first-
    order surrogate stands in for exact splicing).  ``int8_baseline`` adds
    the int8 column and ``lp_check`` the exact MCKP cross-check (both on
    by default for "eval_loss").  ``max_probe_tiles=None`` probes every
    tile.  ``policy.group_budgets`` caps are honoured by every engine."""
    if objective not in ("frobenius", "eval_loss"):
        raise ValueError(
            f"unknown objective {objective!r} (frobenius|eval_loss)"
        )
    device = resolve_device(device)
    base_plan = plan_compression(values, policy)
    if not base_plan.tensors:
        raise ValueError(
            "autotune: the base policy plans no tensors (nothing to allocate)"
        )
    include_int8 = (
        (objective == "eval_loss") if int8_baseline is None else int8_baseline
    )
    run_lp = (objective == "eval_loss") if lp_check is None else lp_check

    weights = None
    t0 = time.perf_counter()
    if calibration or objective == "eval_loss":
        if cfg is None:
            raise ValueError(
                "autotune: calibration needs cfg (so does the eval_loss "
                "objective: both run the model; pass calibration_inputs "
                "as well to supply your own batch)"
            )
        weights = calibration_weights(
            values, cfg, inputs=calibration_inputs, seed=seed, device=device,
            eligible=tuple(t.path for t in base_plan.tensors),
            num_batches=calib_batches,
        )
    calibrate_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    probe_kw = {} if k_fractions is None else {"k_fractions": tuple(k_fractions)}
    table = None
    if objective == "eval_loss":
        from repro_torch.eval import EvalHarness, build_metric_table

        harness = EvalHarness(
            cfg, num_batches=eval_batches, batch=eval_batch,
            seq_len=eval_seq, seed=eval_seed, device=device,
        )
        table = build_metric_table(
            values, base_plan, harness, budget_bytes, seed=seed, device=device,
            weights=weights, max_probe_tiles=max_probe_tiles,
            tile_d_choices=tile_d_choices, probe_bbo_iters=probe_bbo_iters,
            backend=backend, include_int8=include_int8,
            surrogate_margin=surrogate_margin,
            group_budgets=policy.group_budgets, verbose=verbose,
            **probe_kw,
        )
        probes = table.probes()
    else:
        probes = probe_tensors(
            values, base_plan, seed=seed, device=device, weights=weights,
            max_probe_tiles=max_probe_tiles, tile_d_choices=tile_d_choices,
            probe_bbo_iters=probe_bbo_iters, backend=backend,
            include_int8=include_int8, verbose=verbose,
            **probe_kw,
        )
    probe_s = time.perf_counter() - t0

    allocation = allocate_budget(
        probes, budget_bytes, engine=engine, seed=seed, device=device,
        backend=backend or policy.solver_backend,
        num_sweeps=num_sweeps, num_reads=num_reads,
        group_budgets=policy.group_budgets,
    )
    return _refine(
        values, policy, base_plan, budget_bytes, allocation, probes, weights,
        seed=seed, device=device, engine=engine, objective=objective, table=table,
        run_lp=run_lp, lp_tolerance=lp_tolerance, calib_batches=calib_batches,
        include_int8=include_int8, max_probe_tiles=max_probe_tiles,
        tile_d_choices=tile_d_choices, probe_s=probe_s, calibrate_s=calibrate_s,
        verbose=verbose,
    )


def _refine(values, policy, base_plan, budget_bytes, allocation, probes, weights, *, seed,
            device, engine, objective, table, run_lp, lp_tolerance, calib_batches,
            include_int8, max_probe_tiles, tile_d_choices, probe_s=0.0, calibrate_s=0.0,
            verbose=False) -> AutotuneResult:
    """The cross-checks, the refined plan and its metadata for an
    ``allocation`` of ``probes``."""
    lp_result = None
    if run_lp:
        from repro_torch.eval import cross_check_lp

        lp_result = cross_check_lp(
            probes, budget_bytes, allocation,
            group_budgets=policy.group_budgets, tolerance=lp_tolerance,
        )
        if verbose:
            print(
                f"  lp cross-check [{lp_result['status']}]: gap "
                f"{lp_result['relative_gap']:+.2%} "
                f"(tolerance {lp_tolerance:.0%})"
            )

    cross_check = None
    if engine == "qubo":
        ref = allocate_budget(
            probes, budget_bytes, engine="greedy", device=device,
            group_budgets=policy.group_budgets,
        )
        cross_check = {
            "greedy_distortion": ref.total_distortion,
            "greedy_bytes": ref.total_bytes,
            "relative_gap": (
                (allocation.total_distortion - ref.total_distortion)
                / max(ref.total_distortion, 1e-30)
            ),
        }
        if verbose:
            print(
                f"  qubo cross-check: distortion {allocation.total_distortion:.4g} "
                f"vs greedy {ref.total_distortion:.4g} "
                f"(gap {cross_check['relative_gap']:+.1%})"
            )

    refined_policy = dataclasses.replace(
        policy,
        rules=allocation_rules(allocation, base_plan) + tuple(policy.rules),
    )
    refined = plan_compression(values, refined_policy)
    _verify_refined(refined, allocation, base_plan)

    metadata = {
        "budget_bytes": int(budget_bytes),
        "engine": allocation.engine,
        "objective": objective,
        "predicted_bytes": allocation.total_bytes,
        "predicted_distortion": allocation.total_distortion,
        "calibrated": weights is not None,
        "probe": {
            "max_probe_tiles": max_probe_tiles,
            "tile_d_choices": tile_d_choices,
            "int8_baseline": include_int8,
        },
        "allocation": {
            path: pt.to_dict()
            for path, pt in sorted(allocation.choices.items())
        },
    }
    if weights is not None:
        # batch count + seed make calibrated allocations byte-reproducible;
        # [0, seed] is the reference's key data of PRNGKey(seed)
        metadata["calibration"] = {
            "num_batches": int(calib_batches),
            "key": [0, int(seed)],
        }
    if policy.group_budgets:
        metadata["group_budgets"] = [
            [p, int(b)] for p, b in policy.group_budgets
        ]
    if table is not None:
        metadata["eval"] = {
            **table.harness_info,
            "baseline_loss": table.baseline.loss,
            "alpha": table.alpha,
            "surrogate_skip_rate": table.surrogate_skip_rate,
            "exact_paths": len(table.exact_paths),
        }
    if lp_result is not None:
        metadata["lp_check"] = lp_result
    if cross_check is not None:
        metadata["cross_check"] = cross_check
    refined = dataclasses.replace(refined, autotune=metadata)
    return AutotuneResult(
        plan=refined,
        policy=refined_policy,
        allocation=allocation,
        probes=tuple(probes),
        weights=weights,
        probe_s=probe_s,
        metric_table=table,
        lp_check=lp_result,
        calibrate_s=calibrate_s,
    )
