"""Surrogate models for black-box optimisation (BOCS variants + FM).

Counterpart of ``repro/core/surrogate.py``.  The BOCS surrogates consume
incremental sufficient statistics of the acquired dataset (``G = Phi^T
Phi``, ``F = Phi^T y`` and scalar moments, one rank-1 update per point) and
return a Thompson sample of a quadratic model, which
``features.coeffs_to_ising`` turns into an Ising instance:

  * ``nbocs`` -- normal prior alpha_k ~ N(0, sigma2)            (conjugate)
  * ``gbocs`` -- normal-gamma prior, NIG posterior              (conjugate)
  * ``vbocs`` -- horseshoe prior, Makalic-Schmidt Gibbs sampler
  * ``fm``    -- factorisation machine of rank k_FM, Adam-trained, whose
    ``fm_to_ising`` gives the Ising terms directly.

Every function takes a leading batch of problems.  Each sampler has a
``*_from`` form that takes its normal and gamma draws as tensors (the JAX
functions draw them inside) and a form that draws them from a
``torch.Generator``.  PyTorch has no gamma sampler that takes a generator,
so :func:`standard_gamma` is one (Marsaglia-Tsang).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import features as feat

__all__ = [
    "SuffStats",
    "init_stats",
    "update_stats",
    "sample_nbocs",
    "sample_nbocs_from",
    "standard_gamma",
    "gbocs_shape",
    "sample_gbocs",
    "sample_gbocs_from",
    "HorseshoeState",
    "GibbsDraws",
    "init_horseshoe",
    "draw_gibbs",
    "sample_vbocs",
    "sample_vbocs_from",
    "FMState",
    "init_fm",
    "init_fm_from",
    "fm_predict",
    "train_fm",
    "fm_to_ising",
]


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
    yty_std = torch.clamp_min((stats.Syy - m * ybar ** 2) / var, 0.0)
    return F_std, yty_std


def sample_nbocs_from(stats: SuffStats, z: torch.Tensor, sigma2: float = 0.1) -> torch.Tensor:
    """Thompson sample alpha ~ posterior under alpha_k ~ N(0, sigma2), unit
    noise on standardised targets, from the standard-normal draw z (..., p):
    alpha = mu + L^{-T} z with L L^T = G + I / sigma2."""
    F_std, _ = _standardised(stats)
    p = stats.G.shape[-1]
    A = stats.G + torch.eye(p, dtype=stats.G.dtype, device=stats.G.device) / sigma2
    L = torch.linalg.cholesky(A)
    mu = torch.cholesky_solve(F_std.unsqueeze(-1), L).squeeze(-1)
    return mu + _chol_dev(L, z)


def _mT(a):
    return a.transpose(-1, -2)


def _chol_dev(L, z):
    """L^{-T} z: a N(0, P^{-1}) draw from z ~ N(0, I), L L^T = P."""
    return torch.linalg.solve_triangular(_mT(L), z.unsqueeze(-1), upper=True).squeeze(-1)


def _eye(p, like):
    return torch.eye(p, dtype=like.dtype, device=like.device)


def sample_nbocs(stats: SuffStats, generator: torch.Generator, sigma2: float = 0.1) -> torch.Tensor:
    """:func:`sample_nbocs_from` with z drawn from ``generator``."""
    z = torch.randn(stats.F.shape, generator=generator, dtype=stats.F.dtype,
                    device=stats.F.device)
    return sample_nbocs_from(stats, z, sigma2)


# ---------------------------------------------------------------------------
# Gamma variates from a generator
# ---------------------------------------------------------------------------

def standard_gamma(shape: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gamma(shape, rate 1) variates, one per entry of ``shape`` (every entry
    >= 1), by Marsaglia and Tsang's rejection method with normals and
    uniforms from ``generator``; never the global generator."""
    a = shape.to(torch.float32)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.empty_like(a)
    todo = torch.ones_like(a, dtype=torch.bool)
    while True:
        z = torch.randn(a.shape, generator=generator, device=a.device)
        u = torch.rand(a.shape, generator=generator, device=a.device)
        v = (1.0 + c * z) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp_min(1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
        if not bool(todo.any()):
            return out.to(shape.dtype)


# ---------------------------------------------------------------------------
# gBOCS -- normal-gamma prior NG(0, 1, a0=1, b0=beta); beta = 0.001 (Fig. 6)
# ---------------------------------------------------------------------------

def gbocs_shape(count, a0: float = 1.0):
    """The posterior precision's gamma shape a_n = a0 + count / 2 for
    statistics of ``count`` points."""
    return a0 + count / 2.0


def sample_gbocs_from(stats: SuffStats, gamma: torch.Tensor, z: torch.Tensor,
                      b0: float = 0.001) -> torch.Tensor:
    """Thompson sample of the normal-gamma regression from a Gamma(a_n, 1)
    draw ``gamma`` (...) (a_n from ``gbocs_shape``) and a standard normal
    z (..., p)."""
    F_std, yty = _standardised(stats)
    p = stats.G.shape[-1]
    L = torch.linalg.cholesky(stats.G + _eye(p, stats.G))      # V0 = I
    mu = torch.cholesky_solve(F_std.unsqueeze(-1), L).squeeze(-1)
    b_n = b0 + 0.5 * torch.clamp_min(yty - (mu * F_std).sum(-1), 0.0)
    prec = gamma / b_n                                          # sigma^{-2}
    sigma = torch.sqrt(1.0 / torch.clamp_min(prec, 1e-12))
    return mu + sigma.unsqueeze(-1) * _chol_dev(L, z)


def sample_gbocs(stats: SuffStats, generator: torch.Generator, a0: float = 1.0,
                 b0: float = 0.001) -> torch.Tensor:
    """:func:`sample_gbocs_from` with its draws taken from ``generator``."""
    gamma = standard_gamma(gbocs_shape(stats.count, a0), generator)
    z = torch.randn(stats.F.shape, generator=generator, dtype=stats.F.dtype,
                    device=stats.F.device)
    return sample_gbocs_from(stats, gamma, z, b0)


# ---------------------------------------------------------------------------
# vBOCS -- horseshoe prior, Makalic-Schmidt auxiliary-variable Gibbs sampler
# ---------------------------------------------------------------------------

class HorseshoeState(NamedTuple):
    alpha: torch.Tensor    # (..., p)
    beta2: torch.Tensor    # (..., p) local scales
    nu: torch.Tensor       # (..., p) auxiliaries
    tau2: torch.Tensor     # (...)    global scale
    xi: torch.Tensor       # (...)    auxiliary
    sigma2: torch.Tensor   # (...)    noise variance


class GibbsDraws(NamedTuple):
    """One Gibbs sweep's draws: a standard normal and five Gamma(shape, 1)
    variates at the shapes of :func:`draw_gibbs`."""

    z: torch.Tensor        # (..., p) normal for alpha
    beta2: torch.Tensor    # (..., p) shape 1
    nu: torch.Tensor       # (..., p) shape 1
    tau2: torch.Tensor     # (...)    shape (p + 1) / 2
    xi: torch.Tensor       # (...)    shape 1
    sigma2: torch.Tensor   # (...)    shape (count + p) / 2


def init_horseshoe(n: int, batch: tuple = (), dtype=torch.float32, device=None) -> HorseshoeState:
    p = feat.num_features(n)
    z = lambda *s: torch.zeros((*batch, *s), dtype=dtype, device=device)  # noqa: E731
    o = lambda *s: torch.ones((*batch, *s), dtype=dtype, device=device)  # noqa: E731
    return HorseshoeState(alpha=z(p), beta2=o(p), nu=o(p), tau2=o(), xi=o(), sigma2=o())


def draw_gibbs(count: torch.Tensor, p: int, steps: int,
               generator: torch.Generator) -> list[GibbsDraws]:
    """``steps`` sweeps' draws for statistics of ``count`` (...) points,
    every gamma variate of them from one rejection loop."""
    batch = tuple(count.shape)
    one = torch.ones(batch, dtype=torch.float32, device=count.device)
    shapes = torch.cat([
        one.unsqueeze(-1).expand(*batch, 2 * p),                 # beta2, nu
        torch.stack([one * (p + 1.0) / 2.0, one, (count + p) / 2.0], dim=-1),
    ], dim=-1)
    g = standard_gamma(shapes.unsqueeze(0).expand(steps, *shapes.shape), generator)
    out = []
    for k in range(steps):
        z = torch.randn((*batch, p), generator=generator, device=count.device)
        gk = g[k]
        out.append(GibbsDraws(z=z, beta2=gk[..., :p], nu=gk[..., p:2 * p], tau2=gk[..., 2 * p],
                              xi=gk[..., 2 * p + 1], sigma2=gk[..., 2 * p + 2]))
    return out


def _inv_gamma(gamma, scale):
    """InvGamma(shape, scale) from a Gamma(shape, 1) draw: scale / gamma."""
    return scale / torch.clamp_min(gamma, 1e-30)


def sample_vbocs_from(stats: SuffStats, state: HorseshoeState, draws):
    """Gibbs sweeps of the horseshoe regression, one per :class:`GibbsDraws`
    in ``draws``; returns the last alpha (the Thompson sample) and the
    carried chain state.  The conditionals need only (G, F, y^T y): the
    residual norm is y^T y - 2 alpha^T F + alpha^T G alpha."""
    F_std, yty = _standardised(stats)
    G = stats.G
    p = G.shape[-1]
    eye = _eye(p, G)
    for d in draws:
        sig = state.sigma2.unsqueeze(-1)
        d_inv = 1.0 / torch.clamp_min(state.tau2.unsqueeze(-1) * state.beta2, 1e-12)
        A = G / sig.unsqueeze(-1) + torch.diag_embed(d_inv) / sig.unsqueeze(-1)
        L = torch.linalg.cholesky(A + 1e-8 * eye)
        mu = torch.cholesky_solve((F_std / sig).unsqueeze(-1), L).squeeze(-1)
        alpha = mu + _chol_dev(L, d.z)

        a2 = alpha * alpha
        tau2_, sig_ = state.tau2.unsqueeze(-1), sig
        beta2 = _inv_gamma(d.beta2, 1.0 / state.nu + a2 / (2.0 * tau2_ * sig_))
        nu = _inv_gamma(d.nu, 1.0 + 1.0 / beta2)
        tau2 = _inv_gamma(d.tau2, 1.0 / state.xi + (a2 / beta2).sum(-1) / (2.0 * state.sigma2))
        xi = _inv_gamma(d.xi, 1.0 + 1.0 / tau2)
        Ga = (G @ alpha.unsqueeze(-1)).squeeze(-1)
        rss = torch.clamp_min(yty - 2.0 * (alpha * F_std).sum(-1) + (alpha * Ga).sum(-1), 0.0)
        pen = (a2 / (tau2.unsqueeze(-1) * beta2)).sum(-1)
        sigma2 = torch.clamp(_inv_gamma(d.sigma2, 0.5 * (rss + pen)), 1e-6, 1e6)
        state = HorseshoeState(alpha, beta2, nu, tau2, xi, sigma2)
    return state.alpha, state


def sample_vbocs(stats: SuffStats, state: HorseshoeState, generator: torch.Generator,
                 gibbs_steps: int = 4):
    """:func:`sample_vbocs_from` with ``gibbs_steps`` sweeps' draws taken
    from ``generator``."""
    draws = draw_gibbs(stats.count, stats.G.shape[-1], gibbs_steps, generator)
    return sample_vbocs_from(stats, state, draws)


# ---------------------------------------------------------------------------
# FM -- factorisation machine surrogate (FMQA; k_FM in {8, 12})
# ---------------------------------------------------------------------------

class FMState(NamedTuple):
    w0: torch.Tensor      # (...)
    w: torch.Tensor       # (..., n)
    V: torch.Tensor       # (..., n, k)
    opt_m: torch.Tensor   # (..., 1 + n + n*k) Adam first moment (flattened params)
    opt_v: torch.Tensor   # (..., 1 + n + n*k) Adam second moment
    step: torch.Tensor    # (...)


def _fm_flat(w0, w, V):
    return torch.cat([w0.unsqueeze(-1), w, V.flatten(-2)], dim=-1)


def init_fm_from(normal: torch.Tensor) -> FMState:
    """FM state from a standard normal (..., n, k): V = 0.01 normal, the
    other parameters and Adam's moments zero."""
    V = 0.01 * normal
    w0 = torch.zeros(V.shape[:-2], dtype=V.dtype, device=V.device)
    w = torch.zeros(V.shape[:-1], dtype=V.dtype, device=V.device)
    flat = _fm_flat(w0, w, V)
    return FMState(w0, w, V, torch.zeros_like(flat), torch.zeros_like(flat), torch.zeros_like(w0))


def init_fm(n: int, k: int, generator: torch.Generator, batch: tuple = (),
            dtype=torch.float32) -> FMState:
    """:func:`init_fm_from` with the normal drawn from ``generator``."""
    return init_fm_from(torch.randn((*batch, n, k), generator=generator,
                                    device=generator.device, dtype=dtype))


def fm_predict(w0, w, V, X):
    """Degree-2 FM on +-1 inputs (Eq. 11-12): X (..., m, n) -> (..., m)."""
    lin = (X @ w.unsqueeze(-1)).squeeze(-1)
    XV = X @ V                                   # (..., m, k)
    x2V2 = (X * X) @ (V * V)                     # (..., m, k)
    pair = 0.5 * (XV * XV - x2V2).sum(-1)
    return w0.unsqueeze(-1) + lin + pair


def train_fm(state: FMState, X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             steps: int = 50, lr: float = 0.05) -> FMState:
    """Full-batch Adam on the masked MSE of standardised targets,
    warm-started across BBO iterations.  X (..., m, n), y and mask (..., m).

    The gradient is written out (``jax.grad`` of the same loss in
    ``repro``): for residual r = 2 mask (pred - y_n) / m_eff,
    dL/dw0 = sum r, dL/dw = X^T r, dL/dV = X^T (r XV) - ((X*X)^T r) V.
    As in ``repro``, the mask multiplies: a padded row whose y is inf makes
    the loss NaN (0 * inf), which is what the BBO loop's inf-padded dataset
    does to the JAX package's FMQA as well."""
    m_eff = torch.clamp_min(mask.sum(-1), 1.0)
    ybar = (y * mask).sum(-1) / m_eff
    ystd = torch.sqrt(torch.clamp_min((mask * (y - ybar.unsqueeze(-1)) ** 2).sum(-1) / m_eff,
                                      1e-12))
    yn = (y - ybar.unsqueeze(-1)) / ystd.unsqueeze(-1)
    scale = (2.0 / m_eff).unsqueeze(-1) * mask                   # (..., m)
    Xt, X2t = X.transpose(-1, -2), (X * X).transpose(-1, -2)
    n, k = state.V.shape[-2:]
    w0, w, V = state.w0, state.w, state.V
    mom, vel, t = state.opt_m, state.opt_v, state.step
    for _ in range(steps):
        XV = X @ V
        pred = fm_predict(w0, w, V, X)
        r = scale * (pred - yn)                                   # dL/dpred
        gV = Xt @ (r.unsqueeze(-1) * XV) - (X2t @ r.unsqueeze(-1)) * V
        g = _fm_flat(r.sum(-1), (Xt @ r.unsqueeze(-1)).squeeze(-1), gV)
        t = t + 1.0
        mom = 0.9 * mom + 0.1 * g
        vel = 0.999 * vel + 0.001 * g * g
        mhat = mom / (1.0 - torch.pow(0.9, t)).unsqueeze(-1)
        vhat = vel / (1.0 - torch.pow(0.999, t)).unsqueeze(-1)
        flat = _fm_flat(w0, w, V) - lr * mhat / (torch.sqrt(vhat) + 1e-8)
        w0, w, V = flat[..., 0], flat[..., 1:1 + n], flat[..., 1 + n:].unflatten(-1, (n, k))
    return FMState(w0, w, V, mom, vel, t)


def fm_to_ising(state: FMState):
    """FM -> Ising terms: h = w, B_ij = <v_i, v_j> / 2 (i != j), zero diagonal."""
    B = state.V @ state.V.transpose(-1, -2) / 2.0
    return state.w, B - torch.diag_embed(torch.diagonal(B, dim1=-2, dim2=-1))
