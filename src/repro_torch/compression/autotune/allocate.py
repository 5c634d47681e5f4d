"""Budget allocation: minimum total distortion under a compressed-bytes cap.

Counterpart of ``repro/compression/autotune/allocate.py``.  Given per-tensor
rate-distortion curves (:mod:`.probe`), choose one setting per tensor
minimising predicted total distortion subject to ``sum(bytes) <=
budget_bytes`` (and every per-group cap).  Two engines:

``greedy``
    Lagrangian water-filling on the per-tensor lower convex hulls: every
    tensor starts at its cheapest point, then hull upgrades apply in
    decreasing distortion-reduction-per-byte order while they fit.

``qubo``
    One-hot choice spins per (tensor, hull point), a quadratic one-hot
    penalty and a budget penalty with binary-fraction slack spins per
    constraint, solved as ONE batched ``ising.solve_many_from("sa")`` over a
    grid of penalty weights (K1 on the card: its global-memory body above
    the shared-memory limit).  Decoded solutions are repaired to
    feasibility and the best feasible decode wins.

h and B are built in float64 on the host and cast to float32 at the end,
as the reference does, so they are bit-equal to its.  The anneal's draws
come from a generator seeded by ``seed`` (:func:`allocate_budget`), or are
given (:func:`allocate_budget_from`, e.g. the reference's own).  Both
engines raise :class:`BudgetInfeasibleError` when even the cheapest settings
exceed the budget, and never return an allocation over budget.
"""

from __future__ import annotations

import dataclasses
import re
import time

import numpy as np
import torch

from repro_torch.device import generator, resolve_device

__all__ = [
    "Allocation",
    "BudgetInfeasibleError",
    "allocate_budget",
    "allocate_budget_from",
    "lower_hull",
    "resolve_groups",
]

# Penalty-weight grid for the QUBO engine: each (one_hot A, budget B) combo
# becomes one problem of the batched solve.  Distortions are normalised to
# [0, 1] per instance, byte loads to fractions of the budget headroom, so
# the same grid works across instances.
_PENALTY_GRID = tuple(
    (a, b) for a in (2.0, 6.0) for b in (1.0, 4.0, 16.0)
)
_SLACK_BITS = 6


class BudgetInfeasibleError(ValueError):
    """Budget below the cheapest feasible allocation (globally, or within
    one per-layer-group cap)."""

    def __init__(self, budget_bytes: int, min_bytes: int,
                 group: str | None = None):
        self.budget_bytes = int(budget_bytes)
        self.min_bytes = int(min_bytes)
        self.group = group
        scope = f"group {group!r} budget" if group else "budget"
        super().__init__(
            f"{scope} of {budget_bytes} bytes is infeasible: the cheapest "
            f"allocation needs {min_bytes} bytes "
            f"({min_bytes / 2**20:.2f} MiB)"
        )


@dataclasses.dataclass(frozen=True)
class Allocation:
    """The allocator's verdict: one chosen RDPoint per tensor path."""

    choices: dict          # path -> RDPoint
    budget_bytes: int
    total_bytes: int
    total_distortion: float
    engine: str
    solve_s: float         # allocator solve wall-clock (QUBO: the anneal)
    num_spins: int = 0     # spins of the QUBO's Ising problems (0: no anneal)

    def to_dict(self) -> dict:
        return {
            "budget_bytes": self.budget_bytes,
            "total_bytes": self.total_bytes,
            "total_distortion": self.total_distortion,
            "engine": self.engine,
            "solve_s": self.solve_s,
            "choices": {
                path: pt.to_dict() for path, pt in sorted(self.choices.items())
            },
        }


def _pareto(points) -> list:
    """Ascending bytes, strictly decreasing distortion (dominated points
    dropped).  The cheapest point always survives."""
    pts = sorted(points, key=lambda p: (p.bytes, p.distortion))
    out = []
    for p in pts:
        if out and p.distortion >= out[-1].distortion - 1e-12:
            continue
        out.append(p)
    return out


def lower_hull(points) -> list:
    """Lower convex hull of a pareto-filtered RD curve: the slopes
    (distortion drop per extra byte) are strictly decreasing along it,
    which is what makes greedy marginal-utility upgrades optimal for the
    continuous relaxation."""
    pts = _pareto(points)
    hull: list = []
    for p in pts:
        while len(hull) >= 2:
            a, b = hull[-2], hull[-1]
            # keep b only if slope(a->b) > slope(b->p)
            lhs = (a.distortion - b.distortion) * (p.bytes - b.bytes)
            rhs = (b.distortion - p.distortion) * (b.bytes - a.bytes)
            if lhs <= rhs:
                hull.pop()
            else:
                break
        hull.append(p)
    return hull


def resolve_groups(group_budgets, paths) -> tuple:
    """Normalise ``(pattern, cap_bytes)`` pairs (the
    ``CompressionPolicy.group_budgets`` form) into
    ``(pattern, frozenset(member_paths), cap_bytes)`` triples over
    ``paths``.  Patterns matching no path are dropped (a cap on nothing
    constrains nothing)."""
    out = []
    for pattern, cap in group_budgets:
        members = frozenset(p for p in paths if re.search(pattern, p))
        if members:
            out.append((str(pattern), members, int(cap)))
    return tuple(out)


def _check_feasible(hulls: dict, budget_bytes: int, groups=()) -> int:
    base = sum(h[0].bytes for h in hulls.values())
    if base > budget_bytes:
        raise BudgetInfeasibleError(budget_bytes, base)
    for pattern, members, cap in groups:
        base_g = sum(hulls[p][0].bytes for p in members)
        if base_g > cap:
            raise BudgetInfeasibleError(cap, base_g, group=pattern)
    return base


def _totals(hulls: dict, choice: dict):
    b = sum(hulls[p][j].bytes for p, j in choice.items())
    d = sum(hulls[p][j].distortion for p, j in choice.items())
    return int(b), float(d)


def _group_spent(hulls: dict, choice: dict, members) -> int:
    return sum(hulls[p][choice[p]].bytes for p in members)


def _edges(hulls: dict) -> list:
    """All hull upgrade edges, best slope first (ties broken by path/index
    for determinism).  Per tensor the hull guarantees decreasing slopes, so
    this global order preserves each tensor's upgrade order."""
    edges = []
    for path, h in hulls.items():
        for j in range(len(h) - 1):
            cost = h[j + 1].bytes - h[j].bytes
            gain = h[j].distortion - h[j + 1].distortion
            edges.append((gain / max(cost, 1), path, j, cost))
    edges.sort(key=lambda e: (-e[0], e[1], e[2]))
    return edges


def _greedy(hulls: dict, budget_bytes: int, groups=()):
    spent = _check_feasible(hulls, budget_bytes, groups)
    choice = {path: 0 for path in hulls}
    spent_g = [
        sum(hulls[p][0].bytes for p in members) for _, members, _ in groups
    ]
    path_groups = {
        path: [gi for gi, (_, members, _) in enumerate(groups) if path in members]
        for path in hulls
    }
    for _, path, j, cost in _edges(hulls):
        if choice[path] != j:          # prerequisite upgrade was skipped
            continue
        if spent + cost > budget_bytes:
            continue
        if any(
            spent_g[gi] + cost > groups[gi][2] for gi in path_groups[path]
        ):
            continue
        choice[path] = j + 1
        spent += cost
        for gi in path_groups[path]:
            spent_g[gi] += cost
    return choice


def _repair(hulls: dict, choice: dict, budget_bytes: int, groups=()) -> dict:
    """Downgrade along the hulls (cheapest distortion increase per byte
    saved first) until the allocation fits the budget — the global cap and
    every group cap.  When a group cap is violated only its members are
    downgrade candidates.  Terminates because the all-cheapest allocation
    is feasible."""
    choice = dict(choice)
    while True:
        spent, _ = _totals(hulls, choice)
        candidates = None                 # None = no violation
        if spent > budget_bytes:
            candidates = set(hulls)
        else:
            for _, members, cap in groups:
                if _group_spent(hulls, choice, members) > cap:
                    candidates = set(members)
                    break
        if candidates is None:
            return choice
        best = None
        for path in sorted(candidates):
            j = choice[path]
            if j == 0:
                continue
            h = hulls[path]
            saved = h[j].bytes - h[j - 1].bytes
            cost = h[j - 1].distortion - h[j].distortion
            rate = cost / max(saved, 1)
            if best is None or rate < best[0]:
                best = (rate, path)
        _, path = best
        choice[path] -= 1


def _qubo_ising(hulls: dict, budget_bytes: int, base_bytes: int, groups=(), device=None):
    """Build the batched Ising encoding of the allocation QUBO.

    Variables: one choice bit per (tensor, hull point), index 0 included,
    plus ``_SLACK_BITS`` binary-fraction slack bits per inequality (the
    global budget and every group cap).  Byte loads are normalised per
    constraint to its headroom ``R = cap - sum(cheapest members)``;
    per-tensor distortions are shifted to 0 at their best point and scaled
    by the global spread.  Returns (h (P, n), B (P, n, n) float32 on
    ``device``, var_index) for the penalty grid."""
    paths = sorted(hulls)
    R = budget_bytes - base_bytes
    R_g = [
        cap - sum(hulls[p][0].bytes for p in members)
        for _, members, cap in groups
    ]
    var_index = []             # (path, hull_idx) per choice variable
    extras, dtil = [], []
    spread = max(
        (h[0].distortion - h[-1].distortion) for h in hulls.values()
    ) or 1.0
    for path in paths:
        h = hulls[path]
        gids = [
            gi for gi, (_, members, _) in enumerate(groups) if path in members
        ]
        for j, pt in enumerate(h):
            extra = pt.bytes - h[0].bytes
            # cannot fit even alone (globally or in a group cap): prune
            if extra > R or any(extra > R_g[gi] for gi in gids):
                continue
            var_index.append((path, j))
            extras.append(extra)
            dtil.append((pt.distortion - h[-1].distortion) / spread)
    nc = len(var_index)
    slack = np.array(
        [2.0 ** -(b + 1) for b in range(_SLACK_BITS)], dtype=np.float64
    )
    n = nc + (1 + len(groups)) * _SLACK_BITS

    # one normalised load vector per inequality constraint
    cons = []
    load = np.zeros(n)
    load[:nc] = np.array(extras, dtype=np.float64) / max(R, 1)
    load[nc:nc + _SLACK_BITS] = slack
    cons.append(load)
    for gi, (_, members, _) in enumerate(groups):
        load = np.zeros(n)
        for v, (path, _) in enumerate(var_index):
            if path in members:
                load[v] = extras[v] / max(R_g[gi], 1)
        s0 = nc + (1 + gi) * _SLACK_BITS
        load[s0:s0 + _SLACK_BITS] = slack
        cons.append(load)

    hs, Bs = [], []
    for A, Bp in _PENALTY_GRID:
        q = np.zeros(n)
        Q = np.zeros((n, n))                           # symmetric, zero diag
        q[:nc] += np.array(dtil)
        # one-hot penalty per tensor: A * (sum_j x_ij - 1)^2
        by_path: dict = {}
        for v, (path, _) in enumerate(var_index):
            by_path.setdefault(path, []).append(v)
        for vs in by_path.values():
            for v in vs:
                q[v] += -A                              # x^2 = x -> A - 2A
            for i, u in enumerate(vs):
                for v in vs[i + 1:]:
                    Q[u, v] += A
                    Q[v, u] += A
        # budget penalties: B * (sum_v load_v x_v - 1)^2 per constraint
        for load in cons:
            q += Bp * load * (load - 2.0)
            outer = Bp * np.outer(load, load)
            np.fill_diagonal(outer, 0.0)
            Q += outer
        # QUBO -> Ising via x = (1 + s) / 2  (constants dropped)
        hs.append(q / 2.0 + Q.sum(axis=1) / 2.0)
        Bs.append(Q / 4.0)
    return (
        torch.from_numpy(np.stack(hs).astype(np.float32)).to(device),
        torch.from_numpy(np.stack(Bs).astype(np.float32)).to(device),
        var_index,
    )


def _decode(x_row: np.ndarray, var_index: list, hulls: dict) -> dict:
    """Ising spins -> per-tensor hull choice.  Multiple/zero set bits per
    tensor fall back to the cheapest implicated/first point; the repair
    pass then enforces the budget."""
    picked: dict = {}
    for v, (path, j) in enumerate(var_index):
        if x_row[v] > 0:
            picked.setdefault(path, []).append(j)
    return {
        path: (min(picked[path]) if path in picked else 0) for path in hulls
    }


_QUBO_SALT = 0x7175626F  # "qubo"


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _qubo(hulls: dict, budget_bytes: int, *, draws, device, backend, num_sweeps,
          num_reads, groups=()):
    """(choice, solve_s, n): the QUBO engine.  ``draws(P, R, S, n)`` gives
    the anneal's initial spins (P, R, n) and uniforms (P, R, S, n)."""
    from repro_torch.core import ising

    base = _check_feasible(hulls, budget_bytes, groups)
    if budget_bytes - base <= 0 or all(len(h) == 1 for h in hulls.values()):
        return {path: 0 for path in hulls}, 0.0, 0
    h, B, var_index = _qubo_ising(hulls, budget_bytes, base, groups, device)
    P, n = h.shape
    x0, u = draws(P, num_reads, num_sweeps, n)
    _sync(device)
    t0 = time.perf_counter()
    xs, _ = ising.solve_many_from(
        "sa", ising.IsingProblem(h, B), x0.to(device), u.to(device), backend=backend,
    )
    xs = xs.cpu().numpy()
    solve_s = time.perf_counter() - t0

    best = None
    for row in xs:
        choice = _repair(
            hulls, _decode(row, var_index, hulls), budget_bytes, groups
        )
        b, d = _totals(hulls, choice)
        if best is None or (d, b) < (best[1], best[2]):
            best = (choice, d, b)
    return best[0], solve_s, n


def allocate_budget_from(
    probes,
    budget_bytes: int,
    draws,
    *,
    engine: str = "greedy",
    device=None,
    backend: str = "auto",
    num_sweeps: int = 96,
    num_reads: int = 8,
    group_budgets=(),
) -> Allocation:
    """:func:`allocate_budget` with the QUBO anneal's draws given:
    ``draws(P, R, S, n) -> (x0 (P, R, n), u (P, R, S, n))``."""
    if engine not in ("greedy", "qubo"):
        raise ValueError(f"unknown allocator engine {engine!r} (greedy|qubo)")
    hulls = {p.path: lower_hull(p.points) for p in probes}
    groups = resolve_groups(group_budgets, list(hulls))
    n = 0
    if engine == "greedy":
        t0 = time.perf_counter()
        choice = _greedy(hulls, budget_bytes, groups)
        solve_s = time.perf_counter() - t0
    else:
        choice, solve_s, n = _qubo(
            hulls, budget_bytes, draws=draws, device=resolve_device(device),
            backend=backend, num_sweeps=num_sweeps, num_reads=num_reads, groups=groups,
        )
    total_b, total_d = _totals(hulls, choice)
    return Allocation(
        choices={path: hulls[path][j] for path, j in choice.items()},
        budget_bytes=int(budget_bytes),
        total_bytes=total_b,
        total_distortion=total_d,
        engine=engine,
        solve_s=float(solve_s),
        num_spins=n,
    )


def allocate_budget(
    probes,
    budget_bytes: int,
    *,
    engine: str = "greedy",
    seed: int = 0,
    device=None,
    backend: str = "auto",
    num_sweeps: int = 96,
    num_reads: int = 8,
    group_budgets=(),
) -> Allocation:
    """Choose one RD point per probed tensor under the byte budget.

    ``probes`` is a list of :class:`ProbeResult` (or anything exposing
    ``path`` and ``points``); ``engine`` is "greedy" or "qubo" (its anneal
    runs on ``device``, default the GPU, from a generator seeded by
    ``seed``).  ``group_budgets`` is a sequence of ``(path_regex,
    byte_cap)`` pairs: tensors matching a regex must jointly stay under
    that cap.  Raises :class:`BudgetInfeasibleError` when no allocation
    fits."""
    from repro_torch.core import ising

    def draws(P, R, S, n):
        return ising.draw_initial(P, R, S, n, generator(resolve_device(device), seed,
                                                         _QUBO_SALT))

    return allocate_budget_from(
        probes, budget_bytes, draws, engine=engine, device=device, backend=backend,
        num_sweeps=num_sweeps, num_reads=num_reads, group_budgets=group_budgets,
    )
