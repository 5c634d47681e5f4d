"""Surrogate models for black-box optimisation: nBOCS.

Counterpart of the nBOCS part of ``repro/core/surrogate.py``: incremental
sufficient statistics of the acquired dataset (``G = Phi^T Phi``,
``F = Phi^T y`` and scalar moments, one rank-1 update per point) and a
Thompson sample of the normal-prior Bayesian regression, which
``features.coeffs_to_ising`` turns into an Ising instance.  Every function
takes a leading batch of problems.  gBOCS, vBOCS and FMQA are not ported
yet (ROADMAP.md).

``sample_nbocs_from`` takes the standard-normal draw as a tensor (the JAX
function draws it inside); ``sample_nbocs`` draws it from a generator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import features as feat

__all__ = ["SuffStats", "init_stats", "update_stats", "sample_nbocs", "sample_nbocs_from"]


class SuffStats(NamedTuple):
    G: torch.Tensor       # (..., p, p)  Phi^T Phi
    F: torch.Tensor       # (..., p)     Phi^T y
    Sy: torch.Tensor      # (...)        sum y
    Syy: torch.Tensor     # (...)        sum y^2
    count: torch.Tensor   # (...)        number of points (float)


def init_stats(n: int, batch: tuple = (), dtype=torch.float32, device=None) -> SuffStats:
    p = feat.num_features(n)
    z = lambda *s: torch.zeros((*batch, *s), dtype=dtype, device=device)  # noqa: E731
    return SuffStats(G=z(p, p), F=z(p), Sy=z(), Syy=z(), count=z())


def update_stats(stats: SuffStats, x: torch.Tensor, y: torch.Tensor) -> SuffStats:
    """Add the points x (..., n) with costs y (...) to the statistics.

    The Gram matrix is updated IN PLACE (``baddbmm_``-style rank-1 add):
    at the BBO pool's size a fresh (P, p, p) outer product per iteration
    would be another 3.7 GB (P = 10,240 tiles, p = 301).  ``stats.G`` is
    therefore mutated; the other moments are small and rebuilt."""
    phi = feat.featurize(x)
    G = stats.G.view(-1, *stats.G.shape[-2:])
    ph = phi.reshape(-1, phi.shape[-1])
    G.baddbmm_(ph.unsqueeze(-1), ph.unsqueeze(-2))
    return SuffStats(
        G=stats.G,
        F=stats.F + phi * y.unsqueeze(-1),
        Sy=stats.Sy + y,
        Syy=stats.Syy + y * y,
        count=stats.count + 1.0,
    )


def _standardised(stats: SuffStats):
    """Moments of the regression against centred, scaled targets (an affine
    map of the coefficients that leaves the Ising argmin unchanged).
    Phi^T 1 = G[:, 0] because feature 0 is the constant 1."""
    m = torch.clamp_min(stats.count, 1.0)
    ybar = stats.Sy / m
    var = torch.clamp_min(stats.Syy / m - ybar ** 2, 1e-12)
    s = torch.sqrt(var)
    F_std = (stats.F - ybar.unsqueeze(-1) * stats.G[..., :, 0]) / s.unsqueeze(-1)
    return F_std


def sample_nbocs_from(stats: SuffStats, z: torch.Tensor, sigma2: float = 0.1) -> torch.Tensor:
    """Thompson sample alpha ~ posterior under alpha_k ~ N(0, sigma2), unit
    noise on standardised targets, from the standard-normal draw z (..., p):
    alpha = mu + L^{-T} z with L L^T = G + I / sigma2."""
    F_std = _standardised(stats)
    p = stats.G.shape[-1]
    A = stats.G + torch.eye(p, dtype=stats.G.dtype, device=stats.G.device) / sigma2
    L = torch.linalg.cholesky(A)
    mu = torch.cholesky_solve(F_std.unsqueeze(-1), L)
    dev = torch.linalg.solve_triangular(_mT(L), z.unsqueeze(-1), upper=True)
    return (mu + dev).squeeze(-1)


def _mT(a):
    return a.transpose(-1, -2)


def sample_nbocs(stats: SuffStats, generator: torch.Generator, sigma2: float = 0.1) -> torch.Tensor:
    """:func:`sample_nbocs_from` with z drawn from ``generator``."""
    z = torch.randn(stats.F.shape, generator=generator, dtype=stats.F.dtype,
                    device=stats.F.device)
    return sample_nbocs_from(stats, z, sigma2)
