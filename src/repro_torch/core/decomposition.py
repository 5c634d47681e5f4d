"""Integer decomposition  W ~ V = M C  (Kadowaki & Ambai, Sci. Rep. 2022).

Counterpart of ``repro/core/decomposition.py``.  ``M`` is a binary matrix
in {-1, +1}^{N x K}, ``C`` a real matrix in R^{K x D}.  Every function takes
optional leading batch dimensions (a stack of tiles), which is how the port
replaces ``vmap``:

  * the least-squares closure  C*(M) = (M^T M)^+ M^T W          (Eq. 6)
  * the NLIP objective  L(M) = ||W - M C*(M)||_F^2 in the Gram form
  * the original greedy rank-one algorithm (SPADE, Eq. 5)
  * the alternating baseline with exact 2^K per-row sign enumeration
  * LSB-first bit packing, the storage format shared with ``repro``.

Randomness: ``greedy_decompose_from`` takes the random restart signs as a
tensor (the JAX function draws them inside); ``greedy_decompose`` draws
them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "least_squares_C",
    "objective",
    "objective_from_x",
    "greedy_decompose",
    "greedy_decompose_from",
    "draw_restart_signs",
    "alternating_decompose",
    "sign_enumeration",
    "pack_bits",
    "unpack_bits",
    "GreedyResult",
]


def _mT(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def least_squares_C(M: torch.Tensor, W: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Optimal real factor  C*(M) = (M^T M)^+ M^T W  (Eq. 6).
    M (..., N, K), W (..., N, D) -> (..., K, D)."""
    M = M.to(W.dtype)
    G = _mT(M) @ M
    P = _mT(M) @ W
    lam, U = torch.linalg.eigh(G)
    lam_max = lam.amax(-1, keepdim=True)
    inv = torch.where(lam > tol * lam_max, 1.0 / lam, torch.zeros_like(lam))
    return (U * inv.unsqueeze(-2)) @ (_mT(U) @ P)


def objective(M: torch.Tensor, W: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Pseudo-Boolean cost  L(M) = ||W - M C*(M)||_F^2  (Eq. 8-9), Gram form:
    ||W||^2 - sum_i 1[lam_i > tol] |u_i^T M^T W|^2 / lam_i.  -> (...)."""
    M = M.to(W.dtype)
    lam, U = torch.linalg.eigh(_mT(M) @ M)
    T = _mT(U) @ (_mT(M) @ W)                                # (..., K, D)
    lam_max = torch.clamp_min(lam.amax(-1, keepdim=True), 1.0)
    keep = lam > tol * lam_max
    denom = torch.where(keep, lam, torch.ones_like(lam)).unsqueeze(-1)
    proj = torch.where(keep.unsqueeze(-1), T * T / denom, torch.zeros_like(T))
    return (W * W).sum((-2, -1)) - proj.sum((-2, -1))


def objective_from_x(x: torch.Tensor, W: torch.Tensor, K: int, tol: float = 1e-6) -> torch.Tensor:
    """Objective on flattened spins x (..., N*K) (row-major M)."""
    N = W.shape[-2]
    return objective(x.reshape(*x.shape[:-1], N, K), W, tol)


class GreedyResult(NamedTuple):
    M: torch.Tensor           # (..., N, K) in {-1, +1}
    C: torch.Tensor           # (..., K, D)
    cost: torch.Tensor        # ||W - M C||_F^2 with the greedy C
    cost_refit: torch.Tensor  # ||W - M C*(M)||_F^2 after least-squares refit


def _sign1(v: torch.Tensor) -> torch.Tensor:
    """sign with 0 -> +1."""
    return torch.where(v < 0, -torch.ones_like(v), torch.ones_like(v))


def _rank_one_best(R: torch.Tensor, m_rand: torch.Tensor, iters: int):
    """Best rank-one binary fit  min_{m,c} ||R - m c^T||^2  over the
    deterministic power-iteration start plus the given random starts.
    R (..., N, D), m_rand (..., restarts, N) -> m (..., N), c (..., D)."""
    N, D = R.shape[-2], R.shape[-1]
    v = torch.full((*R.shape[:-2], D, 1), D ** -0.5, dtype=R.dtype, device=R.device)
    for _ in range(8):
        v = _mT(R) @ (R @ v)
        v = v / (torch.linalg.vector_norm(v, dim=-2, keepdim=True) + 1e-30)
    m_det = _sign1((R @ v).squeeze(-1))
    m = torch.cat([m_det.unsqueeze(-2), m_rand.to(R.dtype)], dim=-2)   # (..., R+1, N)
    for _ in range(iters):
        c = (m @ R) / N                                  # (..., R+1, D) = (R^T m)/N
        m = _sign1(c @ _mT(R))                            # sign(R c)
    c = (m @ R) / N
    cost = (R * R).sum((-2, -1)).unsqueeze(-1) - N * (c * c).sum(-1)
    best = torch.argmin(cost, dim=-1, keepdim=True)       # first minimum, as jnp
    m = torch.take_along_dim(m, best.unsqueeze(-1), dim=-2).squeeze(-2)
    c = torch.take_along_dim(c, best.unsqueeze(-1), dim=-2).squeeze(-2)
    return m, c


def greedy_decompose_from(
    W: torch.Tensor, K: int, restart_signs: torch.Tensor, iters: int = 16
) -> GreedyResult:
    """The paper's original algorithm: K sequential rank-one fits (Eq. 5).

    W (..., N, D); ``restart_signs`` (..., K, restarts, N) are the +-1
    random starts of each step (``repro`` draws them as
    ``sign(normal(fold_in(fold_in(key, k), 17), (restarts, N)))``)."""
    R = W
    ms, cs = [], []
    for k in range(K):
        m, c = _rank_one_best(R, restart_signs[..., k, :, :], iters)
        R = R - m.unsqueeze(-1) * c.unsqueeze(-2)
        ms.append(m)
        cs.append(c)
    M = torch.stack(ms, dim=-1)
    C = torch.stack(cs, dim=-2)
    return GreedyResult(M=M, C=C, cost=(R * R).sum((-2, -1)), cost_refit=objective(M, W))


def draw_restart_signs(shape, K: int, restarts: int, N: int, generator, dtype=torch.float32):
    """Random +-1 restart starts (*shape, K, restarts, N) from ``generator``
    (on the generator's device)."""
    bits = torch.randint(
        0, 2, (*shape, K, restarts, N), generator=generator, device=generator.device
    )
    return (2 * bits - 1).to(dtype)


def greedy_decompose(
    W: torch.Tensor, K: int, generator: torch.Generator, iters: int = 16, restarts: int = 4
) -> GreedyResult:
    """:func:`greedy_decompose_from` with restart signs drawn from
    ``generator`` (which must live on W's device)."""
    signs = draw_restart_signs(W.shape[:-2], K, restarts, W.shape[-2], generator, W.dtype)
    return greedy_decompose_from(W, K, signs, iters)


def sign_enumeration(K: int, device=None) -> torch.Tensor:
    """All 2^K sign vectors in {-1,+1}^K, shape (2^K, K); bit k of row e
    is column k (LSB-first), as in ``repro``."""
    idx = torch.arange(2 ** K, device=device)
    bits = (idx[:, None] >> torch.arange(K, device=device)[None, :]) & 1
    return (2 * bits - 1).to(torch.float32)


def alternating_decompose(
    W: torch.Tensor,
    K: int,
    M0: torch.Tensor | None = None,
    iters: int = 25,
    generator: torch.Generator | None = None,
):
    """Block-coordinate descent: exact C for fixed M, exact per-row M for
    fixed C by enumerating the 2^K sign patterns.  W (..., N, D).

    ``M0`` (..., N, K) is the start; without it a random start is drawn
    from ``generator``.  Returns (M, C, objective)."""
    E = sign_enumeration(K, W.device).to(W.dtype)               # (2^K, K)
    if M0 is None:
        if generator is None:
            raise ValueError("alternating_decompose needs M0 or a generator")
        M = _sign1(torch.randn(W.shape[:-1] + (K,), generator=generator,
                               device=W.device, dtype=W.dtype))
    else:
        M = M0.to(W.dtype)
    quad_e = None
    for _ in range(iters):
        C = least_squares_C(M, W)                                # (..., K, D)
        G = C @ _mT(C)                                           # (..., K, K)
        lin = E @ (C @ _mT(W))                                   # (..., 2^K, N)
        quad_e = torch.einsum("ek,...kl,el->...e", E, G, E)      # (..., 2^K)
        scores = quad_e.unsqueeze(-1) - 2.0 * lin
        M = E[torch.argmin(scores, dim=-2)]                      # (..., N, K)
    C = least_squares_C(M, W)
    return M, C, objective(M, W)


def pack_bits(M: torch.Tensor) -> torch.Tensor:
    """Pack a {-1,+1} matrix (..., N, K) into uint8 (..., N, ceil(K/8));
    +1 -> bit 1, bit j of byte b holds column 8*b + j (LSB-first)."""
    K = M.shape[-1]
    Kp = -(-K // 8) * 8
    bits = (M > 0).to(torch.uint8)
    bits = torch.nn.functional.pad(bits, (0, Kp - K))
    bits = bits.reshape(*M.shape[:-1], Kp // 8, 8).to(torch.int32)
    weights = (1 << torch.arange(8, device=M.device, dtype=torch.int32))
    return (bits * weights).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor, K: int, dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: uint8 (..., N, ceil(K/8)) -> (..., N, K)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shifts) & 1
    M = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :K]
    return 2 * M.to(dtype) - 1
