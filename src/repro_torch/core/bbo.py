"""Black-box optimisation loop for the integer decomposition (paper core).

Counterpart of ``repro/core/bbo.py``.  One BBO iteration Thompson-samples a
quadratic surrogate, minimises it with an Ising solver, de-duplicates,
evaluates the true pseudo-Boolean cost and appends it to the dataset.  P
independent problems run in lock-step: each iteration fits the P surrogates
as batched tensor operations and solves the P Ising instances with ONE
``ising.solve_many_from`` call (one kernel launch for all P x num_reads
chains).  ``run_bbo_many`` is the production tile fan-out (P matrix
tiles); ``run_bbo_batch`` is the paper's protocol (P independent runs on
one matrix), which is what ``vmap(run_bbo)`` compiles to in JAX; ``run_bbo``
is one run.

Algorithms (paper naming):
  RS       random search                         algo="rs"
  vBOCS    horseshoe-prior BOCS                  algo="vbocs"
  nBOCS    normal-prior BOCS (best performer)    algo="nbocs"
  gBOCS    normal-gamma-prior BOCS               algo="gbocs"
  FMQA08 / FMQA12  factorisation machine, k_FM   algo="fmqa", fm_rank=8/12
  nBOCSa   nBOCS + K!*2^K data augmentation      algo="nbocs", augment=True
Solvers: "sa" | "sq" | "qa" (simulated QA) -- nBOCS / nBOCSsq / nBOCSqa.

Randomness: ``run_bbo_many_from`` consumes given draws (the initial design
``X0``, the FM's initial normal and one :class:`IterDraws` per iteration);
the other forms draw them from a ``torch.Generator`` one iteration at a
time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple

import torch

from repro_torch.core import features as feat
from repro_torch.core import ising, surrogate, symmetry

__all__ = [
    "ALGOS",
    "BBOConfig",
    "BBOResult",
    "IterDraws",
    "draw_iterations",
    "paper_iterations",
    "run_bbo",
    "run_bbo_batch",
    "run_bbo_many",
    "run_bbo_many_from",
]

ALGOS = ("rs", "nbocs", "gbocs", "vbocs", "fmqa")


@dataclasses.dataclass(frozen=True)
class BBOConfig:
    n: int                      # number of spins = N*K
    N: int                      # rows of W
    K: int                      # decomposition rank
    algo: str = "nbocs"         # rs | nbocs | gbocs | vbocs | fmqa
    solver: str = "sa"          # sa | sq | qa
    iters: int = 0              # 0 -> paper default 2 n^2
    init_points: int = 0        # 0 -> paper default n
    augment: bool = False       # nBOCSa
    sigma2: float = 0.1         # nBOCS prior variance (paper Fig. 6)
    beta: float = 0.001         # gBOCS inverse scale (paper Fig. 6)
    fm_rank: int = 8            # FMQA08 / FMQA12
    fm_steps: int = 50          # Adam steps per iteration (warm-started)
    gibbs_steps: int = 4        # horseshoe Gibbs sweeps per iteration
    num_reads: int = 10         # Ising restarts per iteration
    num_sweeps: int = 64        # Ising sweeps per read
    backend: str = "auto"       # auto | cuda | torch (must match the device)
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.algo not in ALGOS:
            raise ValueError(f"unknown algo {self.algo!r} ({'|'.join(ALGOS)})")

    def resolved(self) -> "BBOConfig":
        it = self.iters if self.iters > 0 else paper_iterations(self.n)
        ip = self.init_points if self.init_points > 0 else self.n
        return dataclasses.replace(self, iters=it, init_points=ip)

    @property
    def points_per_iter(self) -> int:
        return symmetry.orbit_size(self.K) if self.augment else 1

    @property
    def max_points(self) -> int:
        c = self.resolved()
        return c.init_points + c.iters * self.points_per_iter


def paper_iterations(n: int) -> int:
    """Paper: n initial points followed by 2 n^2 iterations."""
    return 2 * n * n


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
    z: torch.Tensor | None = None       # (P, p) normal of the nBOCS/gBOCS sample
    gamma: torch.Tensor | None = None   # (P,) gBOCS precision, Gamma(a0 + count/2, 1)
    gibbs: tuple | None = None          # vBOCS: one GibbsDraws per Gibbs sweep
    x0: torch.Tensor | None = None      # (P, R, n) initial spins of the solver
    u: torch.Tensor | None = None       # (P, R, S, n) the solver's uniforms
    x_rand: torch.Tensor | None = None  # (P, n) random-search candidate (rs)


class _State:
    """Lock-step dataset and surrogate state of P problems (mutated in
    place: the Gram stack is the dominant memory)."""

    def __init__(self, cfg: BBOConfig, P, mp, device, best_x, fm_normal):
        n, dtype = cfg.n, cfg.dtype
        self.cfg = cfg
        self.X = torch.zeros((P, mp, n), dtype=dtype, device=device)
        self.y = torch.full((P, mp), float("inf"), dtype=dtype, device=device)
        self.count = 0
        self.stats = surrogate.init_stats(n, (P,), dtype, device)
        self.hs = surrogate.init_horseshoe(n, (P,), dtype, device) if cfg.algo == "vbocs" else None
        self.fm = surrogate.init_fm_from(fm_normal.to(dtype)) if cfg.algo == "fmqa" else None
        self.best_x = best_x.clone()
        self.best_y = torch.full((P,), float("inf"), dtype=dtype, device=device)

    def append(self, x, yv, augment: bool = False):
        """Append one evaluated point per problem (with its symmetry orbit,
        each row at the same cost, when augmenting)."""
        rows = symmetry.orbit_flat(x, self.cfg.N, self.cfg.K) if augment else x[:, None]
        for j in range(rows.shape[1]):
            c = self.count
            self.X[:, c] = rows[:, j]
            self.y[:, c] = yv
            self.count = c + 1
            self.stats = surrogate.update_stats(self.stats, rows[:, j], yv)
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


def _sample_ising(state: _State, d: IterDraws, cfg: BBOConfig) -> ising.IsingProblem:
    """Surrogate fit + Thompson sample -> P Ising instances (h, B)."""
    if cfg.algo == "fmqa":
        P, mp = state.y.shape
        mask = (torch.arange(mp, device=state.y.device) < state.count).to(cfg.dtype)
        state.fm = surrogate.train_fm(state.fm, state.X, state.y, mask.expand(P, mp),
                                      cfg.fm_steps)
        return ising.IsingProblem(*surrogate.fm_to_ising(state.fm))
    if cfg.algo == "nbocs":
        alpha = surrogate.sample_nbocs_from(state.stats, d.z, cfg.sigma2)
    elif cfg.algo == "gbocs":
        alpha = surrogate.sample_gbocs_from(state.stats, d.gamma, d.z, b0=cfg.beta)
    else:
        alpha, state.hs = surrogate.sample_vbocs_from(state.stats, state.hs, d.gibbs)
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
    fm_normal: torch.Tensor | None = None,
) -> BBOResult:
    """Optimise P problems in lock-step from given draws.

    ``f_batch`` maps candidates (P, n) -> costs (P,); ``X0`` (P,
    init_points, n) is the initial design; ``draws`` yields one
    :class:`IterDraws` per iteration; ``fm_normal`` (P, n, fm_rank) is the
    standard normal behind FMQA's initial factors.  ``warm_x`` (P, n)
    warm-starts every problem: it is evaluated and appended before the first
    iteration and each solve seeds read 0 from the best-so-far spins."""
    cfg = cfg.resolved()
    P, _, n = X0.shape
    if cfg.algo == "fmqa" and fm_normal is None:
        raise ValueError("algo 'fmqa' needs fm_normal, the FM's initial draw")
    X0 = X0.to(cfg.dtype)
    mp = cfg.max_points + (1 if warm_x is not None else 0)
    state = _State(cfg, P, mp, X0.device, X0[:, 0], fm_normal)
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
            problems = _sample_ising(state, d, cfg)
            x, _ = ising.solve_many_from(
                cfg.solver, problems, d.x0, d.u, backend=cfg.backend,
                init_state=state.best_x if warm_x is not None else None,
            )
            x = x.to(cfg.dtype)
        x = _dedupe(state, x, d.flip)
        state.append(x, f_batch(x), cfg.augment)
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


def draw_iterations(cfg: BBOConfig, P: int, generator: torch.Generator, warm: bool = False):
    """Yield ``cfg.iters`` :class:`IterDraws` drawn lazily from
    ``generator`` (one iteration's uniforms at a time: at the BBO pool's
    size they are ~94 MB per iteration).  ``warm``: the dataset holds one
    more point (``run_bbo_many_from(warm_x=...)``), which moves the gamma
    shapes of gBOCS and vBOCS."""
    cfg = cfg.resolved()
    dev = generator.device
    n = cfg.n
    p = feat.num_features(n)
    trotter = ising.N_TROTTER if cfg.solver in ("qa", "sqa") else None
    for it in range(cfg.iters):
        count = cfg.init_points + int(warm) + it * cfg.points_per_iter
        if cfg.algo == "rs":
            xr = 2.0 * torch.randint(0, 2, (P, n), generator=generator, device=dev) - 1.0
            d = IterDraws(flip=None, x_rand=xr)
        else:
            d = IterDraws(flip=None)
            if cfg.algo in ("nbocs", "gbocs"):
                z = torch.randn((P, p), generator=generator, device=dev, dtype=cfg.dtype)
                d = d._replace(z=z)
            if cfg.algo == "gbocs":
                shape = torch.full((P,), surrogate.gbocs_shape(float(count)), device=dev)
                d = d._replace(gamma=surrogate.standard_gamma(shape, generator).to(cfg.dtype))
            if cfg.algo == "vbocs":
                m = torch.full((P,), float(count), device=dev)
                d = d._replace(gibbs=tuple(surrogate.draw_gibbs(m, p, cfg.gibbs_steps, generator)))
            x0, u = ising.draw_initial(P, cfg.num_reads, cfg.num_sweeps, n, generator, trotter)
            d = d._replace(x0=x0, u=u)
        yield d._replace(flip=torch.randint(0, n, (P,), generator=generator, device=dev))


def _take_rows(x, rows: slice):
    """The ``rows`` of every tensor in a draw (tensors, NamedTuples of
    them, sequences, None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x[rows]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_take_rows(v, rows) for v in x))
    return type(x)(_take_rows(v, rows) for v in x)


def run_bbo_many(
    cfg: BBOConfig,
    f_batch: Callable,
    num_problems: int,
    generator: torch.Generator,
    warm_x: torch.Tensor | None = None,
    rows: slice | None = None,
) -> BBOResult:
    """:func:`run_bbo_many_from` with every draw taken from ``generator``
    (on the device the problems live on).  ``rows``: draw for all
    ``num_problems`` but optimise only those problems (``f_batch`` and
    ``warm_x`` cover just them): a rank of a sharded pool solves its block
    of a chunk on the draws the whole chunk gives it."""
    c = cfg.resolved()
    dev = generator.device
    X0 = 2.0 * torch.randint(
        0, 2, (num_problems, c.init_points, c.n), generator=generator, device=dev,
    ) - 1.0
    fm_normal = None
    if c.algo == "fmqa":
        fm_normal = torch.randn((num_problems, c.n, c.fm_rank), generator=generator, device=dev)
    draws = draw_iterations(cfg, num_problems, generator, warm=warm_x is not None)
    if rows is not None:
        X0, fm_normal = X0[rows], _take_rows(fm_normal, rows)
        draws = (_take_rows(d, rows) for d in draws)
    return run_bbo_many_from(cfg, f_batch, X0.to(cfg.dtype), draws,
                             warm_x=warm_x, fm_normal=fm_normal)


def run_bbo_batch(cfg: BBOConfig, f: Callable, num_runs: int,
                  generator: torch.Generator) -> BBOResult:
    """The paper's protocol: ``num_runs`` independent runs (25; 100 for RS)
    of the black box ``f`` (e.g. ``decomposition.make_objective``, which
    takes a (runs, n) batch), in lock-step: one batched solve, so one
    kernel launch, per iteration for all runs."""
    return run_bbo_many(cfg, f, num_runs, generator)


def run_bbo(cfg: BBOConfig, f: Callable, generator: torch.Generator) -> BBOResult:
    """One BBO run of the black box ``f: x (n,) -> cost``; the fields of the
    result lose the leading run axis."""
    res = run_bbo_batch(cfg, lambda x: f(x[0])[None], 1, generator)
    return BBOResult(*(t[0] for t in res))
