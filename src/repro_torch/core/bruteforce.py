"""Brute-force exact search over all 2^(N*K) binary matrices.

Counterpart of ``repro/core/bruteforce.py``.  The paper uses brute force to
obtain the exact and second-best solutions that calibrate its residual-error
plots.  Each chunk of candidate codes is evaluated with the Gram-form
objective (one batched eigh) on W's device, and a running top-k of the
smallest costs stays there; only the final top-k comes to the host.  On a
CUDA device each chunk is evaluated in pieces of at most
``decomposition.EIGH_MAX_BATCH`` matrices, below cuSOLVER's batched-eigh
limit; every matrix's cost is computed on its own, so the pieces give the
costs the whole chunk would.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import decomposition

__all__ = ["BruteForceResult", "brute_force", "exact_solutions"]


class BruteForceResult(NamedTuple):
    best_cost: float          # L(M*) -- squared Frobenius residual
    second_cost: float        # best cost strictly worse than best_cost
    best_norm: float          # ||f(M*)||_2
    solutions: np.ndarray     # (num_exact, N, K) all minimisers (the orbit)
    costs_topk: np.ndarray    # (topk,) smallest costs found, ascending


def _codes_to_pm1(codes: torch.Tensor, n: int, dtype) -> torch.Tensor:
    bits = (codes[:, None] >> torch.arange(n, device=codes.device)[None, :]) & 1
    return (2 * bits - 1).to(dtype)


def _chunk_costs(start: int, W: torch.Tensor, n: int, K: int, chunk: int) -> torch.Tensor:
    piece = min(chunk, decomposition.EIGH_MAX_BATCH) if W.device.type == "cuda" else chunk
    out = []
    for a in range(start, start + chunk, piece):
        codes = torch.arange(a, min(a + piece, start + chunk), dtype=torch.int64,
                             device=W.device)
        out.append(decomposition.objective_from_x(_codes_to_pm1(codes, n, W.dtype), W, K))
    return torch.cat(out)


def brute_force(
    W: torch.Tensor,
    K: int,
    chunk: int = 1 << 14,
    topk: int = 64,
    rtol: float = 1e-5,
) -> BruteForceResult:
    """Exhaustive search; returns the optimum, the second-best *distinct*
    cost (the paper's grey line) and every minimiser (the symmetry orbit)."""
    N, _ = W.shape
    n = N * K
    if n > 30:
        raise ValueError("brute force is only feasible for n <= 30")
    total = 1 << n
    if total % chunk:
        raise ValueError("chunk must divide 2^n")
    k = min(topk, chunk)
    best_costs = best_codes = None
    for start in range(0, total, chunk):
        costs = _chunk_costs(start, W, n, K, chunk)
        cand_costs, idx = torch.topk(costs, k, largest=False)
        cand_codes = start + idx
        if best_costs is None:
            best_costs, best_codes = cand_costs, cand_codes
        else:
            cc = torch.cat([best_costs, cand_costs])
            cd = torch.cat([best_codes, cand_codes])
            keep = torch.argsort(cc, stable=True)[:topk]
            best_costs, best_codes = cc[keep], cd[keep]

    order = torch.argsort(best_costs, stable=True)
    best_costs = best_costs[order].cpu().numpy()
    best_codes = best_codes[order].cpu().numpy()
    c0 = float(best_costs[0])
    tol = rtol * max(abs(c0), 1e-12)
    is_opt = best_costs <= c0 + tol
    worse = best_costs[~is_opt]
    second = float(worse[0]) if worse.size else float("nan")

    sol_codes = best_codes[is_opt]
    bits = (sol_codes[:, None] >> np.arange(n)[None, :]) & 1
    sols = (2 * bits - 1).astype(np.float32).reshape(-1, N, K)
    return BruteForceResult(
        best_cost=c0,
        second_cost=second,
        best_norm=float(np.sqrt(max(c0, 0.0))),
        solutions=sols,
        costs_topk=best_costs,
    )


def exact_solutions(result: BruteForceResult) -> np.ndarray:
    """All distinct exact solutions (K! * 2^K of them, e.g. 48, when the
    optimum is unique up to the symmetry)."""
    sols = result.solutions
    flat = (sols.reshape(sols.shape[0], -1) > 0).astype(np.uint8)
    _, idx = np.unique(flat, axis=0, return_index=True)
    return sols[np.sort(idx)]
