"""Ising solvers: simulated annealing (SA) and simulated quenching (SQ).

Counterpart of ``repro/core/ising.py``.  Every solver minimises

    E(x) = h . x + x^T B x ,   x in {-1, +1}^n ,

with ``B`` symmetric and zero-diagonal, over a batch of P problems with
``num_reads`` restart chains each, and keeps the best read per problem.

``solve_many_from`` takes the initial spins and uniforms as tensors (the
draws ``repro``'s ``_solve_keys`` makes from per-problem keys), so it
realises exactly the chains the JAX solver realises; ``solve_many`` draws
them from a ``torch.Generator``.  The sweeps run through
:mod:`repro_torch.kernels.sa_sweep`: the CUDA kernel for CUDA tensors
(backend ``"cuda"``), the plain version for CPU tensors (``"torch"``).
The SQA solver (the paper's "QA") waits for its kernel K2 (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.sa_sweep import sa_sweep_many, sq_sweep_many

__all__ = [
    "IsingProblem",
    "resolve_backend",
    "draw_initial",
    "solve_many",
    "solve_many_from",
]


class IsingProblem(NamedTuple):
    """A batch of Ising instances: h (P, n), B (P, n, n)."""

    h: torch.Tensor
    B: torch.Tensor


_CANON = {"sa": "sa", "sq": "sq", "qa": "sqa", "sqa": "sqa"}
_DEFAULT_SWEEPS = {"sa": 64, "sq": 64, "sqa": 48}
_DEFAULT_TEMPERATURE = {"sq": 0.1}


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


def draw_initial(P: int, num_reads: int, num_sweeps: int, n: int, generator: torch.Generator):
    """Random initial spins x0 (P, R, n) and uniforms u (P, R, S, n)."""
    dev = generator.device
    x0 = 2.0 * torch.randint(0, 2, (P, num_reads, n), generator=generator, device=dev) - 1.0
    u = torch.rand((P, num_reads, num_sweeps, n), generator=generator, device=dev)
    return x0.to(torch.float32), u


def solve_many_from(
    name: str,
    problems: IsingProblem,
    x0: torch.Tensor,
    u: torch.Tensor,
    *,
    temperature: float | None = None,
    backend: str = "auto",
    init_state: torch.Tensor | None = None,
):
    """Solve P problems from given draws: x0 (P, R, n) initial spins, u
    (P, R, S, n) uniforms.  Returns the best-of-reads ``(x (P, n), e (P,))``.

    ``init_state`` (P, n) warm-starts read 0 of every problem (0 maps to
    +1), leaving the uniforms and the other reads untouched."""
    canon = _CANON.get(name)
    if canon is None:
        raise ValueError(f"unknown solver {name!r} (sa|sq|qa|sqa)")
    if canon == "sqa":
        raise NotImplementedError(
            "solver 'qa'/'sqa' needs the SQA kernel K2, not ported yet "
            "(ROADMAP.md, Queue 2, K2)"
        )
    h, B = problems
    resolve_backend(backend, h.device)
    hf = h.to(torch.float32).contiguous()
    Bf = B.to(torch.float32).contiguous()
    x0 = x0.to(torch.float32)
    if init_state is not None:
        warm = torch.where(init_state.to(torch.float32) < 0.0, -1.0, 1.0)
        x0 = x0.clone()
        x0[:, 0, :] = warm
    x0 = x0.contiguous()
    u = u.to(torch.float32).contiguous()
    if canon == "sa":
        temps = _temperature_schedule(hf, Bf, u.shape[2]).to(torch.float32).contiguous()
        xs, es = sa_sweep_many(hf, Bf, x0, u, temps)
    else:
        t = _DEFAULT_TEMPERATURE["sq"] if temperature is None else temperature
        xs, es = sq_sweep_many(hf, Bf, x0, u, temperature=t)
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
    init_state: torch.Tensor | None = None,
):
    """:func:`solve_many_from` with x0 and uniforms drawn from
    ``generator`` (on the problems' device)."""
    canon = _CANON.get(name)
    if canon is None:
        raise ValueError(f"unknown solver {name!r} (sa|sq|qa|sqa)")
    S = _DEFAULT_SWEEPS[canon] if num_sweeps is None else num_sweeps
    P, n = problems.h.shape
    x0, u = draw_initial(P, num_reads, S, n, generator)
    return solve_many_from(
        name, problems, x0, u, temperature=temperature, backend=backend,
        init_state=init_state,
    )
