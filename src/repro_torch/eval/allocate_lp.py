"""Exact MCKP reference allocator (a la CalibTIP's ILP) for cross-checks.

Counterpart of ``repro/eval/allocate_lp.py`` (pure Python, a copy).

The budget allocation is a multiple-choice knapsack: pick one hull point
per tensor, minimise total distortion, subject to the global byte budget
and any per-layer-group caps.  This module solves it EXACTLY with pure
numpy-free branch-and-bound over the same lower hulls the greedy/QUBO
engines see:

- bound: the classical MCKP LP relaxation — water-fill the remaining
  tensors' hull edges in decreasing distortion-per-byte order, taking the
  last edge fractionally.  Convex hulls make consecutive-edge filling the
  LP optimum, so the bound is tight where it matters.  Group caps are
  ignored in the bound (dropping constraints only lowers it — still a
  valid lower bound) but enforced exactly in the search.
- incumbent: the greedy allocation seeds the search, so even a
  node-limited run never returns worse than greedy.

``cross_check_lp`` packages the comparison the autotuner records: the
engine's allocation vs the exact optimum, with the relative gap and a
tolerance verdict.
"""

from __future__ import annotations

from repro_torch.compression.autotune.allocate import (
    _check_feasible,
    _greedy,
    _totals,
    lower_hull,
    resolve_groups,
)

__all__ = ["solve_mckp", "cross_check_lp"]

DEFAULT_NODE_LIMIT = 200_000


def _edge_list(order, hulls) -> list:
    """(rate, path_pos, extra_bytes, ddistortion) over every hull upgrade
    edge, best rate first — the LP relaxation's fill order."""
    edges = []
    for pos, path in enumerate(order):
        h = hulls[path]
        for j in range(len(h) - 1):
            db = h[j + 1].bytes - h[j].bytes
            dd = h[j].distortion - h[j + 1].distortion
            edges.append((dd / max(db, 1), pos, db, dd))
    edges.sort(key=lambda e: (-e[0], e[1]))
    return edges


def _lp_bound(order, hulls, edges, pos, remaining_bytes) -> float:
    """LP-relaxation lower bound on the distortion of tensors
    ``order[pos:]`` given ``remaining_bytes`` beyond their cheapest
    points (fractional last edge)."""
    d = sum(hulls[p][0].distortion for p in order[pos:])
    r = remaining_bytes
    for rate, epos, db, dd in edges:
        if r <= 0:
            break
        if epos < pos:
            continue
        take = min(db, r)
        d -= dd * (take / db)
        r -= take
    return d


def solve_mckp(
    probes,
    budget_bytes: int,
    *,
    group_budgets=(),
    node_limit: int = DEFAULT_NODE_LIMIT,
):
    """Exact (or node-limited) MCKP solve over the probes' lower hulls.

    Returns ``(choices, info)``: ``choices`` maps path -> RDPoint exactly
    like :class:`Allocation.choices`; ``info`` records bytes/distortion,
    ``status`` ("optimal" | "node_limit") and the node count.  Raises
    :class:`BudgetInfeasibleError` like the other engines."""
    hulls = {p.path: lower_hull(p.points) for p in probes}
    groups = resolve_groups(group_budgets, list(hulls))
    _check_feasible(hulls, budget_bytes, groups)
    order = sorted(hulls)
    edges = _edge_list(order, hulls)

    # suffix-minimum byte costs for feasibility pruning
    n = len(order)
    suffix_min = [0] * (n + 1)
    for i in range(n - 1, -1, -1):
        suffix_min[i] = suffix_min[i + 1] + hulls[order[i]][0].bytes
    group_suffix = []
    for _, members, _ in groups:
        gs = [0] * (n + 1)
        for i in range(n - 1, -1, -1):
            gs[i] = gs[i + 1] + (
                hulls[order[i]][0].bytes if order[i] in members else 0
            )
        group_suffix.append(gs)

    incumbent = _greedy(hulls, budget_bytes, groups)
    best_d = _totals(hulls, incumbent)[1]
    best = dict(incumbent)
    nodes = 0
    hit_limit = False

    def dfs(pos, spent, spent_g, dist, partial):
        nonlocal nodes, best_d, best, hit_limit
        if nodes >= node_limit:
            hit_limit = True
            return
        nodes += 1
        if pos == n:
            if dist < best_d - 1e-12:
                best_d = dist
                best = dict(partial)
            return
        if dist + _lp_bound(
            order, hulls, edges, pos, budget_bytes - spent - suffix_min[pos]
        ) >= best_d - 1e-12:
            return
        path = hulls[order[pos]]
        gids = [
            gi for gi, (_, members, _) in enumerate(groups)
            if order[pos] in members
        ]
        # most-bytes-first: richest points first reach low-distortion
        # completions (and thus tighter incumbents) sooner
        for j in range(len(path) - 1, -1, -1):
            pt = path[j]
            b = spent + pt.bytes
            if b + suffix_min[pos + 1] > budget_bytes:
                continue
            ok = True
            for gi in gids:
                if (
                    spent_g[gi] + pt.bytes
                    + group_suffix[gi][pos + 1] > groups[gi][2]
                ):
                    ok = False
                    break
            if not ok:
                continue
            partial[order[pos]] = j
            for gi in gids:
                spent_g[gi] += pt.bytes
            dfs(pos + 1, b, spent_g, dist + pt.distortion, partial)
            for gi in gids:
                spent_g[gi] -= pt.bytes
            del partial[order[pos]]

    dfs(0, 0, [0] * len(groups), 0.0, {})
    total_b, total_d = _totals(hulls, best)
    return (
        {path: hulls[path][j] for path, j in best.items()},
        {
            "engine": "lp",
            "status": "node_limit" if hit_limit else "optimal",
            "nodes": nodes,
            "total_bytes": total_b,
            "total_distortion": total_d,
            "budget_bytes": int(budget_bytes),
        },
    )


def cross_check_lp(
    probes,
    budget_bytes: int,
    allocation,
    *,
    group_budgets=(),
    tolerance: float = 0.05,
    node_limit: int = DEFAULT_NODE_LIMIT,
) -> dict:
    """Compare an engine's :class:`Allocation` against the exact optimum.

    The recorded ``relative_gap`` is (engine - lp) / lp distortion; a
    negative gap is clamped to 0 (the LP search is exact on "optimal"
    status, so a negative gap only appears under ``node_limit``)."""
    _, info = solve_mckp(
        probes, budget_bytes, group_budgets=group_budgets,
        node_limit=node_limit,
    )
    lp_d = info["total_distortion"]
    gap = (allocation.total_distortion - lp_d) / max(lp_d, 1e-30)
    if info["status"] == "optimal":
        gap = max(gap, 0.0)
    return {
        "status": info["status"],
        "nodes": info["nodes"],
        "lp_distortion": lp_d,
        "lp_bytes": info["total_bytes"],
        "engine_distortion": allocation.total_distortion,
        "engine_bytes": allocation.total_bytes,
        "relative_gap": float(gap),
        "tolerance": float(tolerance),
        "within_tolerance": bool(gap <= tolerance + 1e-9),
    }
