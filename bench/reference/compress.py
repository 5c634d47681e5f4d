"""Plain checks of a compressed artifact, tile by tile.

Imports nothing of the program.  A tile's answer is its packed signs M and
its stored factor C, and both are judged.

C: for the program's M the least-squares factor ``C* = pinv(M) W`` is
worked out again in float64; since ``W - M C*`` is orthogonal to M's
columns, a stored C costs ``||M (C - C*)||^2`` more squared residual than
C*.  ``c_excess`` is that excess, pooled over the sampled tiles, over the
excess of C* rounded to the stored dtype: about 1 when C is C* as stored,
more when C was worked out less exactly.

M: the compression's own equations are run again here in float64 from the
same random restarts (the greedy start, K rank-one fits each the best of a
power-iteration start and ``RESTARTS`` random sign starts refined by
``GREEDY_ITERS`` sign iterations, then ``SWEEPS`` sweeps of alternating
descent: exact C for fixed M, each row's best of the 2^K sign patterns for
fixed C).  The number compared, ``m_mismatch``, is the share of the
sampled tiles whose M is not the reference's: about 0 when the program
follows the equations, more where it searched less exactly.  Reported
beside it, ``m_excess`` is the program's squared residual ``||W - M
C*(M)||^2``, pooled over the tiles, over the reference's, less 1.  The
restarts are drawn as the
configuration's seed rule states: per tensor slice, a generator on the
device seeded by the splitmix64 chain of (seed, leaf index, slice), ±1 from
``randint(0, 2, (tiles, K, RESTARTS, tn))``.

The controls are the reference in the lower precision: ``control_c`` works
out C with every product and running sum rounded to bfloat16, and
``decompose(..., dtype=torch.bfloat16)`` runs the greedy start and the
sweeps with bfloat16 operands and results (the Gram matrices' eigh, on
integers, in float32).
"""

from __future__ import annotations

import torch

from reference.common import unpack_signs

RESTARTS, POWER_ITERS, GREEDY_ITERS, SWEEPS = 4, 8, 16, 25
EIG_TOL = 1e-6


def tiles(W: torch.Tensor, tn: int, td: int) -> torch.Tensor:
    """(..., d_in, d_out) -> (n, tn, td), slices in order, tiles row-major."""
    d_in, d_out = W.shape[-2:]
    W = W.reshape(-1, d_in // tn, tn, d_out // td, td)
    return W.permute(0, 1, 3, 2, 4).reshape(-1, tn, td)


def optimal_c(M: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """float64 least-squares C* (n, K, td) for M (n, tn, K), W (n, tn, td)."""
    return torch.linalg.pinv(M.double()) @ W.double()


def control_c(M: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The reference's C computed in bfloat16 (module docstring): every
    product and every running sum rounded to bfloat16."""
    bf = torch.bfloat16
    Mb, Wb = M.to(bf), W.to(bf)
    P = torch.zeros(M.shape[0], M.shape[2], W.shape[2], dtype=bf, device=W.device)
    for i in range(M.shape[1]):
        P = P + Mb[:, i, :, None] * Wb[:, i, None, :]
    Ginv = torch.linalg.pinv(M.transpose(-1, -2).double() @ M.double()).to(bf)
    C = torch.zeros_like(P)
    for k in range(P.shape[1]):
        C = C + Ginv[:, :, k, None] * P[:, k, None, :]
    return C


def c_excess(M_packed: torch.Tensor, C: torch.Tensor, W: torch.Tensor) -> tuple:
    """(excess of the stored C, excess of C* rounded to C's dtype), summed
    over the tiles: M_packed (n, tn, kb), C (n, K, td) as stored, W (n, tn,
    td)."""
    K = C.shape[-2]
    M = unpack_signs(M_packed, K).double()
    Copt = optimal_c(M, W)
    got = M @ (C.double() - Copt)
    best = M @ (Copt.to(C.dtype).double() - Copt)
    return float((got * got).sum()), float((best * best).sum())


# ---- M: the greedy start and the alternating descent -----------------------

def mix(*parts: int) -> int:
    """The seed rule's 63-bit splitmix64 chain of whole numbers."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z & 0x7FFFFFFFFFFFFFFF


def restart_signs(device, n_tiles: int, K: int, tn: int, *parts: int) -> torch.Tensor:
    """±1 float64 (n_tiles, K, RESTARTS, tn) from the generator of ``parts``."""
    g = torch.Generator(device=device)
    g.manual_seed(mix(*parts))
    bits = torch.randint(0, 2, (n_tiles, K, RESTARTS, tn), generator=g, device=device)
    return (2 * bits - 1).double()


def _sign(v: torch.Tensor) -> torch.Tensor:
    """sign with 0 -> +1."""
    return torch.where(v < 0, -1.0, 1.0).to(v.dtype)


def _t(a: torch.Tensor) -> torch.Tensor:
    return a.transpose(-1, -2)


def _rank_one(R: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """The best ±1 m of ``min ||R - m c^T||`` (c = R^T m / tn) over a start
    from R's leading right singular vector (``POWER_ITERS`` power steps from
    the constant vector) and the random ``starts`` (n, RESTARTS, tn), each
    refined by ``GREEDY_ITERS`` steps m <- sign(R R^T m); ties go to the
    first.  R (n, tn, td) -> m (n, tn)."""
    tn, td = R.shape[-2:]
    v = torch.full((R.shape[0], td, 1), td ** -0.5, dtype=R.dtype, device=R.device)
    for _ in range(POWER_ITERS):
        v = _t(R) @ (R @ v)
        v = v / (torch.linalg.vector_norm(v, dim=-2, keepdim=True) + 1e-30)
    m = torch.cat([_sign(R @ v).transpose(-1, -2), starts.to(R.dtype)], dim=-2)
    for _ in range(GREEDY_ITERS):
        m = _sign(((m @ R) / tn) @ _t(R))
    c = (m @ R) / tn
    best = torch.argmin((R * R).sum((-2, -1))[:, None] - tn * (c * c).sum(-1), dim=-1)
    return m[torch.arange(R.shape[0], device=R.device), best]


def _least_squares(M: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """(M^T M)^+ M^T W, the pseudo-inverse cut at ``EIG_TOL`` of the
    largest eigenvalue; the eigh in at least float32."""
    G = _t(M) @ M
    lam, U = torch.linalg.eigh(G.float() if G.dtype == torch.bfloat16 else G)
    inv = torch.where(lam > EIG_TOL * lam.amax(-1, keepdim=True), 1.0 / lam,
                      torch.zeros_like(lam))
    U, inv = U.to(W.dtype), inv.to(W.dtype)
    return (U * inv[..., None, :]) @ (_t(U) @ (_t(M) @ W))


def decompose(W: torch.Tensor, signs: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    """M (n, tn, K) in {-1, +1} of W (n, tn, td) from the restarts ``signs``
    (n, K, RESTARTS, tn), computed in ``dtype``."""
    W = W.to(dtype)
    K = signs.shape[1]
    R, cols = W, []
    for k in range(K):
        m = _rank_one(R, signs[:, k])
        c = (m[:, None, :] @ R)[:, 0] / W.shape[1]
        R = R - m[..., None] * c[:, None, :]
        cols.append(m)
    M = torch.stack(cols, -1)
    idx = torch.arange(2 ** K, device=W.device)
    E = (((idx[:, None] >> torch.arange(K, device=W.device)) & 1) * 2 - 1).to(dtype)
    for _ in range(SWEEPS):
        C = _least_squares(M, W)
        quad = torch.einsum("ek,nkl,el->ne", E, C @ _t(C), E)
        scores = quad[..., None] - 2.0 * (E @ (C @ _t(W)))
        M = E[torch.argmin(scores, dim=-2)]
    return M


def residual(M: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """float64 ||W - M C*(M)||^2 of each tile."""
    M, W = M.double(), W.double()
    d = W - M @ _least_squares(M, W)
    return (d * d).sum((-2, -1))


def leaf_indices(paths) -> dict:
    """path -> its index in the parameter tree's flat order (the seed
    rule's leaf index): keys sorted at every level of the tree."""
    return {p: i for i, p in enumerate(sorted(paths, key=lambda p: p.split("/")))}
