"""Quadratic feature map for the BOCS surrogate models.

Counterpart of ``repro/core/features.py``: ``phi(x) = [1, x_1..x_n,
x_1 x_2, ..., x_{n-1} x_n]`` with the pairs in row-major upper-triangular
order, and the split of regression coefficients into Ising terms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["num_features", "pair_indices", "featurize", "coeffs_to_ising"]


def num_features(n: int) -> int:
    """1 (bias) + n (linear) + n(n-1)/2 (pairwise)."""
    return 1 + n + n * (n - 1) // 2


@functools.lru_cache(maxsize=None)
def pair_indices(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Upper-triangular index pair (i, j), i < j, in fixed row-major order."""
    return np.triu_indices(n, k=1)


def featurize(x: torch.Tensor) -> torch.Tensor:
    """phi(x) for x (..., n) -> (..., num_features(n))."""
    n = x.shape[-1]
    iu, ju = (torch.as_tensor(a, device=x.device) for a in pair_indices(n))
    pairs = x[..., iu] * x[..., ju]
    one = torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    return torch.cat([one, x, pairs], dim=-1)


def coeffs_to_ising(alpha: torch.Tensor, n: int):
    """Regression coefficients alpha (..., p) -> Ising terms h (..., n) and
    symmetric zero-diagonal B (..., n, n) with B_ij = B_ji = alpha_ij / 2,
    so that x^T B x = sum_{i<j} alpha_ij x_i x_j."""
    iu, ju = (torch.as_tensor(a, device=alpha.device) for a in pair_indices(n))
    h = alpha[..., 1 : 1 + n]
    B = torch.zeros(alpha.shape[:-1] + (n, n), dtype=alpha.dtype, device=alpha.device)
    B[..., iu, ju] = alpha[..., 1 + n :] / 2.0
    return h, B + B.transpose(-1, -2)
