"""Ising solvers: simulated annealing (SA), simulated quenching (SQ) and
simulated quantum annealing (SQA, the paper's "QA").

Counterpart of ``repro/core/ising.py``.  Every solver minimises

    E(x) = h . x + x^T B x ,   x in {-1, +1}^n ,

with ``B`` symmetric and zero-diagonal, over a batch of P problems with
``num_reads`` restart chains each, and keeps the best read per problem
(for SQA every Trotter replica of every read is a candidate).

``solve_many_from`` takes the initial spins and uniforms as tensors (the
draws ``repro``'s ``_solve_keys`` makes from per-problem keys), so it
realises exactly the chains the JAX solver realises; ``solve_many`` draws
them from a ``torch.Generator``.  The sweeps run through
:mod:`repro_torch.kernels.sa_sweep` (K1) and
:mod:`repro_torch.kernels.sqa_sweep` (K2): the CUDA kernels for CUDA
tensors (backend ``"cuda"``), the plain versions for CPU tensors
(``"torch"``).  ``solve_sa`` / ``solve_sq`` / ``solve_sqa`` / ``solve``
are the single-problem wrappers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.sa_sweep import sa_sweep_many, sq_sweep_many
from repro_torch.kernels.sqa_sweep import sqa_sweep_many

__all__ = [
    "IsingProblem",
    "random_problems",
    "ising_energy",
    "resolve_backend",
    "sqa_jperps",
    "draw_initial",
    "solve_many",
    "solve_many_from",
    "solve_sa",
    "solve_sq",
    "solve_sqa",
    "solve",
    "SOLVERS",
    "N_TROTTER",
]


class IsingProblem(NamedTuple):
    """A batch of Ising instances: h (P, n), B (P, n, n)."""

    h: torch.Tensor
    B: torch.Tensor

    @property
    def num_problems(self) -> int:
        return self.h.shape[0]

    @property
    def num_spins(self) -> int:
        return self.h.shape[-1]


def random_problems(generator: torch.Generator, num_problems: int, n: int,
                    scale: float = 0.3) -> IsingProblem:
    """Random symmetric zero-diagonal instances on the generator's device."""
    dev = generator.device
    h = torch.randn((num_problems, n), generator=generator, device=dev)
    B = torch.randn((num_problems, n, n), generator=generator, device=dev) * scale
    B = (B + B.transpose(1, 2)) / 2
    return IsingProblem(h, B * (1 - torch.eye(n, device=dev))[None])


def ising_energy(x: torch.Tensor, h: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """h . x + x^T B x over leading batch dimensions."""
    return (x * h).sum(-1) + (x * (B @ x.unsqueeze(-1)).squeeze(-1)).sum(-1)


_CANON = {"sa": "sa", "sq": "sq", "qa": "sqa", "sqa": "sqa"}
_DEFAULT_SWEEPS = {"sa": 64, "sq": 64, "sqa": 48}
_DEFAULT_TEMPERATURE = {"sq": 0.1, "sqa": 0.05}
N_TROTTER = 8           # Trotter replicas of the SQA solver unless asked otherwise


def resolve_backend(backend: str, device: torch.device) -> str:
    """The port's own solver backends: ``"cuda"`` (the kernel) for CUDA
    tensors, ``"torch"`` (the plain version) for CPU tensors.  ``"auto"``
    resolves from the device; the JAX package's ``"pallas"``/``"jnp"``
    names are accepted as their counterparts so a policy written for
    ``repro`` runs unchanged."""
    want = "cuda" if torch.device(device).type == "cuda" else "torch"
    alias = {"auto": want, "pallas": "cuda", "jnp": "torch"}.get(backend, backend)
    if alias not in ("cuda", "torch"):
        raise ValueError(f"unknown backend {backend!r} (auto|cuda|torch)")
    if alias != want:
        raise ValueError(
            f"backend {backend!r} cannot run on {device}: the sweeps run "
            f"where the tensors live ({want!r} here)"
        )
    return want


def _temperature_schedule(h, B, num_sweeps, hot=2.9, cold=0.4):
    """Geometric schedule between scaled max/min effective-field estimates
    (D-Wave ``neal`` defaults).  h (P, n), B (P, n, n) -> (P, S)."""
    row = h.abs() + 2.0 * B.abs().sum(-1)
    hmax = torch.clamp_min(row.amax(-1), 1e-9)                       # (P,)
    mags = torch.cat([h.abs(), 2.0 * B.abs().flatten(-2)], dim=-1)
    hmin = torch.where(mags > 1e-12, mags, hmax[:, None]).amin(-1)
    t_hot = hot * hmax
    t_cold = torch.clamp_min(cold * hmin, 1e-6)
    r = torch.linspace(0.0, 1.0, num_sweeps, device=h.device)
    return t_hot[:, None] * (t_cold / t_hot)[:, None] ** r[None, :]


def sqa_jperps(num_sweeps: int, n_trotter: int, temperature: float, gamma0: float,
               device=None) -> torch.Tensor:
    """Ferromagnetic inter-slice couplings J_perp(Gamma_s) (S,) in f32, the
    transverse field annealed geometrically from gamma0 to 1e-2."""
    r = torch.linspace(0.0, 1.0, num_sweeps, device=device)
    gammas = gamma0 * (1e-2 / gamma0) ** r
    pt = n_trotter * temperature
    ptt = torch.tensor(pt, dtype=torch.float32, device=device)
    return (-0.5 * pt) * torch.log(torch.tanh(torch.clamp_min(gammas / ptt, 1e-7)))


def draw_initial(P: int, num_reads: int, num_sweeps: int, n: int, generator: torch.Generator,
                 n_trotter: int | None = None):
    """Random initial spins x0 (P, R, n) and uniforms u (P, R, S, n); with
    ``n_trotter`` T, the SQA form x0 (P, R, T, n) and u (P, R, S, T, n)."""
    dev = generator.device
    rep = () if n_trotter is None else (n_trotter,)
    x0 = 2.0 * torch.randint(0, 2, (P, num_reads, *rep, n), generator=generator, device=dev) - 1.0
    u = torch.rand((P, num_reads, num_sweeps, *rep, n), generator=generator, device=dev)
    return x0.to(torch.float32), u


def solve_many_from(
    name: str,
    problems: IsingProblem,
    x0: torch.Tensor,
    u: torch.Tensor,
    *,
    temperature: float | None = None,
    backend: str = "auto",
    gamma0: float = 3.0,
    init_state: torch.Tensor | None = None,
):
    """Solve P problems from given draws: x0 (P, R, n) initial spins, u
    (P, R, S, n) uniforms (SQA: x0 (P, R, T, n), u (P, R, S, T, n)).
    Returns the best-of-candidates ``(x (P, n), e (P,))``.

    ``init_state`` (P, n) warm-starts read 0 of every problem (0 maps to
    +1; SQA: every replica of read 0), leaving the uniforms and the other
    reads untouched."""
    canon = _CANON.get(name)
    if canon is None:
        raise ValueError(f"unknown solver {name!r} (sa|sq|qa|sqa)")
    h, B = problems
    resolve_backend(backend, h.device)
    hf = h.to(torch.float32).contiguous()
    Bf = B.to(torch.float32).contiguous()
    x0 = x0.to(torch.float32)
    if init_state is not None:
        warm = torch.where(init_state.to(torch.float32) < 0.0, -1.0, 1.0)
        x0 = x0.clone()
        x0[:, 0] = warm[:, None, :] if canon == "sqa" else warm
    x0 = x0.contiguous()
    u = u.to(torch.float32).contiguous()
    if canon == "sa":
        temps = _temperature_schedule(hf, Bf, u.shape[2]).to(torch.float32).contiguous()
        xs, es = sa_sweep_many(hf, Bf, x0, u, temps)
    elif canon == "sq":
        t = _DEFAULT_TEMPERATURE["sq"] if temperature is None else temperature
        xs, es = sq_sweep_many(hf, Bf, x0, u, temperature=t)
    else:
        t = _DEFAULT_TEMPERATURE["sqa"] if temperature is None else temperature
        P, R, T, n = x0.shape
        jperps = sqa_jperps(u.shape[2], T, t, gamma0, h.device).contiguous()
        X, E = sqa_sweep_many(hf, Bf, x0, u, jperps, temperature=t)
        # every Trotter replica is a candidate: fold into the read axis
        xs, es = X.reshape(P, R * T, n), E.reshape(P, R * T)
    best = torch.argmin(es, dim=1)
    x = torch.take_along_dim(xs, best[:, None, None], dim=1)[:, 0]
    e = torch.take_along_dim(es, best[:, None], dim=1)[:, 0]
    return x, e


def solve_many(
    name: str,
    problems: IsingProblem,
    *,
    generator: torch.Generator,
    num_sweeps: int | None = None,
    num_reads: int = 10,
    temperature: float | None = None,
    backend: str = "auto",
    n_trotter: int = N_TROTTER,
    gamma0: float = 3.0,
    init_state: torch.Tensor | None = None,
):
    """:func:`solve_many_from` with x0 and uniforms drawn from
    ``generator`` (on the problems' device).  ``n_trotter`` and ``gamma0``
    apply to SQA only."""
    canon = _CANON.get(name)
    if canon is None:
        raise ValueError(f"unknown solver {name!r} (sa|sq|qa|sqa)")
    S = _DEFAULT_SWEEPS[canon] if num_sweeps is None else num_sweeps
    P, n = problems.h.shape
    x0, u = draw_initial(P, num_reads, S, n, generator,
                         n_trotter if canon == "sqa" else None)
    return solve_many_from(
        name, problems, x0, u, temperature=temperature, backend=backend,
        gamma0=gamma0, init_state=init_state,
    )


# ---------------------------------------------------------------------------
# Single-problem wrappers: problem i of ``solve_many`` is ``solve`` on the
# i-th problem's draws.
# ---------------------------------------------------------------------------

def _solve_one(name, generator, h, B, init_state, **kw):
    x, e = solve_many(
        name, IsingProblem(h[None], B[None]), generator=generator,
        init_state=None if init_state is None else init_state[None], **kw,
    )
    return x[0], e[0]


def solve_sa(generator: torch.Generator, h, B, num_sweeps: int = 64, num_reads: int = 10,
             backend: str = "auto", init_state=None):
    """Simulated annealing; returns the best of ``num_reads`` restarts."""
    return _solve_one("sa", generator, h, B, init_state, num_sweeps=num_sweeps,
                      num_reads=num_reads, backend=backend)


def solve_sq(generator: torch.Generator, h, B, num_sweeps: int = 64, num_reads: int = 10,
             temperature: float = 0.1, backend: str = "auto", init_state=None):
    """Simulated quenching: constant low temperature (paper: T = 0.1)."""
    return _solve_one("sq", generator, h, B, init_state, num_sweeps=num_sweeps,
                      num_reads=num_reads, temperature=temperature, backend=backend)


def solve_sqa(generator: torch.Generator, h, B, num_sweeps: int = 48, num_reads: int = 10,
              n_trotter: int = N_TROTTER, temperature: float = 0.05, gamma0: float = 3.0,
              backend: str = "auto", init_state=None):
    """Simulated QA: transverse field annealed geometrically Gamma0 -> ~0."""
    return _solve_one("sqa", generator, h, B, init_state, num_sweeps=num_sweeps,
                      num_reads=num_reads, n_trotter=n_trotter, temperature=temperature,
                      gamma0=gamma0, backend=backend)


SOLVERS = {"sa": solve_sa, "sq": solve_sq, "qa": solve_sqa, "sqa": solve_sqa}


def solve(name: str, generator: torch.Generator, h, B, **kw):
    """One problem h (n,), B (n, n) with the named solver -> (x (n,), e ())."""
    if name not in SOLVERS:
        raise ValueError(f"unknown solver {name!r} (sa|sq|qa|sqa)")
    return SOLVERS[name](generator, h, B, **kw)
