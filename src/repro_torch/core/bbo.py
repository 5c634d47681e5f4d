"""Black-box optimisation loop for the integer decomposition (paper core).

Counterpart of ``repro/core/bbo.py::run_bbo_many``: P independent problems
(matrix tiles) optimised in lock-step.  One iteration Thompson-samples the
P nBOCS surrogates, solves the P Ising instances with ONE batched
``ising.solve_many`` call (all P x num_reads chains in one kernel launch),
de-duplicates, evaluates the true costs and appends them to the dataset.

Algorithms ported: ``"nbocs"`` and random search ``"rs"``.  gBOCS, vBOCS,
FMQA, data augmentation and the single-problem ``run_bbo``/``run_bbo_batch``
are not ported yet (ROADMAP.md).

Randomness: ``run_bbo_many_from`` consumes given draws (the initial design
``X0`` and one :class:`IterDraws` per iteration); ``run_bbo_many`` draws
them from a ``torch.Generator`` one iteration at a time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple

import torch

from repro_torch.core import features as feat
from repro_torch.core import ising, surrogate

__all__ = [
    "BBOConfig",
    "BBOResult",
    "IterDraws",
    "draw_iterations",
    "run_bbo_many",
    "run_bbo_many_from",
]


@dataclasses.dataclass(frozen=True)
class BBOConfig:
    n: int                      # number of spins = N*K
    N: int                      # rows of W
    K: int                      # decomposition rank
    algo: str = "nbocs"         # nbocs | rs
    solver: str = "sa"          # sa | sq
    iters: int = 0              # 0 -> paper default 2 n^2
    init_points: int = 0        # 0 -> paper default n
    sigma2: float = 0.1         # nBOCS prior variance (paper Fig. 6)
    num_reads: int = 10         # Ising restarts per iteration
    num_sweeps: int = 64        # Ising sweeps per read
    backend: str = "auto"       # auto | cuda | torch (must match the device)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.algo not in ("nbocs", "rs"):
            raise NotImplementedError(
                f"algo {self.algo!r} is not ported yet (nbocs|rs; ROADMAP.md)"
            )

    def resolved(self) -> "BBOConfig":
        it = self.iters if self.iters > 0 else 2 * self.n * self.n
        ip = self.init_points if self.init_points > 0 else self.n
        return dataclasses.replace(self, iters=it, init_points=ip)

    @property
    def max_points(self) -> int:
        c = self.resolved()
        return c.init_points + c.iters


class BBOResult(NamedTuple):
    best_x: torch.Tensor      # (P, n) best spins found
    best_y: torch.Tensor      # (P,) their cost
    traj: torch.Tensor        # (P, iters) best-so-far cost after each iteration
    proposed: torch.Tensor    # (P, iters, n) candidate evaluated each iteration
    X: torch.Tensor           # (P, max_points, n) acquired dataset (padded)
    y: torch.Tensor           # (P, max_points)
    count: torch.Tensor       # (P,) valid rows of X / y


class IterDraws(NamedTuple):
    """The random numbers of one BBO iteration for P problems."""

    flip: torch.Tensor                  # (P,) spin flipped when x is a duplicate
    z: torch.Tensor | None = None       # (P, p) normal draw of the Thompson sample
    x0: torch.Tensor | None = None      # (P, R, n) initial spins of the solver
    u: torch.Tensor | None = None       # (P, R, S, n) the solver's uniforms
    x_rand: torch.Tensor | None = None  # (P, n) random-search candidate (rs)


class _State:
    """Lock-step dataset and surrogate statistics of P problems (mutated in
    place: the Gram stack is the dominant memory)."""

    def __init__(self, P, mp, n, dtype, device, best_x):
        self.X = torch.zeros((P, mp, n), dtype=dtype, device=device)
        self.y = torch.full((P, mp), float("inf"), dtype=dtype, device=device)
        self.count = 0
        self.stats = surrogate.init_stats(n, (P,), dtype, device)
        self.best_x = best_x.clone()
        self.best_y = torch.full((P,), float("inf"), dtype=dtype, device=device)

    def append(self, x, yv):
        c = self.count
        self.X[:, c] = x
        self.y[:, c] = yv
        self.count = c + 1
        self.stats = surrogate.update_stats(self.stats, x, yv)
        better = yv < self.best_y
        self.best_x = torch.where(better[:, None], x, self.best_x)
        self.best_y = torch.where(better, yv, self.best_y)


def _dedupe(state: _State, x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Where x is already in a problem's dataset, flip spin ``flip`` of it
    (the FMQA convention, which keeps the iteration budget honest)."""
    seen = state.X[:, : state.count]
    dup = (seen == x[:, None, :]).all(-1).any(-1)
    flipped = x.clone()
    rows = torch.arange(x.shape[0], device=x.device)
    flipped[rows, flip] = -flipped[rows, flip]
    return torch.where(dup[:, None], flipped, x)


def _sample_ising(state: _State, z: torch.Tensor, cfg: BBOConfig) -> ising.IsingProblem:
    """Surrogate fit + Thompson sample -> P Ising instances (h, B)."""
    alpha = surrogate.sample_nbocs_from(state.stats, z, cfg.sigma2)
    return ising.IsingProblem(*feat.coeffs_to_ising(alpha, cfg.n))


def _eval_columns(f_batch, X: torch.Tensor) -> torch.Tensor:
    """f_batch over the second axis of X (P, m, n) -> (P, m)."""
    return torch.stack([f_batch(X[:, j]) for j in range(X.shape[1])], dim=1)


def run_bbo_many_from(
    cfg: BBOConfig,
    f_batch: Callable,
    X0: torch.Tensor,
    draws: Iterable[IterDraws],
    warm_x: torch.Tensor | None = None,
) -> BBOResult:
    """Optimise P problems in lock-step from given draws.

    ``f_batch`` maps candidates (P, n) -> costs (P,); ``X0`` (P,
    init_points, n) is the initial design; ``draws`` yields one
    :class:`IterDraws` per iteration.  ``warm_x`` (P, n) warm-starts every
    problem: it is evaluated and appended before the first iteration and
    each solve seeds read 0 from the best-so-far spins."""
    cfg = cfg.resolved()
    P, _, n = X0.shape
    X0 = X0.to(cfg.dtype)
    mp = cfg.max_points + (1 if warm_x is not None else 0)
    state = _State(P, mp, n, cfg.dtype, X0.device, X0[:, 0])
    y0 = _eval_columns(f_batch, X0)
    for j in range(X0.shape[1]):
        state.append(X0[:, j], y0[:, j])
    if warm_x is not None:
        xw = warm_x.to(cfg.dtype)
        state.append(xw, f_batch(xw))

    traj, proposed = [], []
    draws = iter(draws)
    for _ in range(cfg.iters):
        d = next(draws)
        if cfg.algo == "rs":
            x = d.x_rand.to(cfg.dtype)
        else:
            problems = _sample_ising(state, d.z, cfg)
            x, _ = ising.solve_many_from(
                cfg.solver, problems, d.x0, d.u, backend=cfg.backend,
                init_state=state.best_x if warm_x is not None else None,
            )
            x = x.to(cfg.dtype)
        x = _dedupe(state, x, d.flip)
        state.append(x, f_batch(x))
        traj.append(state.best_y)
        proposed.append(x)
    return BBOResult(
        best_x=state.best_x,
        best_y=state.best_y,
        traj=torch.stack(traj, dim=1),
        proposed=torch.stack(proposed, dim=1),
        X=state.X,
        y=state.y,
        count=torch.full((P,), state.count, dtype=torch.int32, device=X0.device),
    )


def draw_iterations(cfg: BBOConfig, P: int, generator: torch.Generator):
    """Yield ``cfg.iters`` :class:`IterDraws` drawn lazily from
    ``generator`` (one iteration's uniforms at a time: at the BBO pool's
    size they are ~94 MB per iteration)."""
    cfg = cfg.resolved()
    dev = generator.device
    n = cfg.n
    p = feat.num_features(n)
    for _ in range(cfg.iters):
        if cfg.algo == "rs":
            xr = 2.0 * torch.randint(0, 2, (P, n), generator=generator, device=dev) - 1.0
            d = IterDraws(flip=None, x_rand=xr)
        else:
            z = torch.randn((P, p), generator=generator, device=dev, dtype=cfg.dtype)
            x0, u = ising.draw_initial(P, cfg.num_reads, cfg.num_sweeps, n, generator)
            d = IterDraws(flip=None, z=z, x0=x0, u=u)
        yield d._replace(flip=torch.randint(0, n, (P,), generator=generator, device=dev))


def run_bbo_many(
    cfg: BBOConfig,
    f_batch: Callable,
    num_problems: int,
    generator: torch.Generator,
    warm_x: torch.Tensor | None = None,
) -> BBOResult:
    """:func:`run_bbo_many_from` with every draw taken from ``generator``
    (on the device the problems live on)."""
    c = cfg.resolved()
    X0 = 2.0 * torch.randint(
        0, 2, (num_problems, c.init_points, c.n), generator=generator,
        device=generator.device,
    ) - 1.0
    return run_bbo_many_from(
        cfg, f_batch, X0.to(cfg.dtype), draw_iterations(cfg, num_problems, generator),
        warm_x=warm_x,
    )
