"""Solution-space symmetry of the integer decomposition.

Counterpart of ``repro/core/symmetry.py``.  ``V = sum_i m_i c_i^T`` is
invariant under permuting the K rank-one terms and flipping the sign of any
(m_i, c_i) pair, so every solution M has an orbit of K! * 2^K equivalent
binary matrices (48 for K = 3).  The orbit maps are the JAX package's, in
the same order: ``orbit`` and ``orbit_flat`` take tensors with leading batch
dimensions (the nBOCSa augmentation of P runs at once); the clustering
helpers work on numpy arrays, as in ``repro``.
"""

from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

__all__ = [
    "orbit_size",
    "orbit_maps",
    "orbit",
    "orbit_flat",
    "canonical_key",
    "dedupe_exact",
    "cluster_exact_solutions",
    "assign_domains",
]


def orbit_size(K: int) -> int:
    return int(math.factorial(K) * 2**K)


@functools.lru_cache(maxsize=None)
def orbit_maps(K: int) -> tuple[np.ndarray, np.ndarray]:
    """(perms, signs): all column permutations (K!*2^K, K) int and the
    matching +-1 sign patterns (K!*2^K, K)."""
    perms = np.array(list(itertools.permutations(range(K))), dtype=np.int32)
    signs = np.array(
        [[(1 if (s >> k) & 1 else -1) for k in range(K)] for s in range(2**K)],
        dtype=np.float32,
    )
    P = np.repeat(perms, 2**K, axis=0)             # (K!*2^K, K)
    S = np.tile(signs, (len(perms), 1))            # (K!*2^K, K)
    return P, S


def orbit(M: torch.Tensor) -> torch.Tensor:
    """All K!*2^K equivalent matrices of M (..., N, K) -> (..., orbit, N, K)."""
    P, S = orbit_maps(M.shape[-1])
    perms = torch.as_tensor(P, dtype=torch.long, device=M.device)
    signs = torch.as_tensor(S, dtype=M.dtype, device=M.device)
    return M[..., perms].movedim(-2, -3) * signs[:, None, :]


def orbit_flat(x: torch.Tensor, N: int, K: int) -> torch.Tensor:
    """Orbit on flattened spin vectors: (..., N*K) -> (..., orbit, N*K)."""
    O = orbit(x.reshape(*x.shape[:-1], N, K))
    return O.reshape(*x.shape[:-1], orbit_size(K), N * K)


def _orbit_np(M: np.ndarray) -> np.ndarray:
    P, S = orbit_maps(M.shape[-1])
    return np.transpose(M[:, P], (1, 0, 2)) * S[:, None, :]


def canonical_key(M: np.ndarray) -> bytes:
    """Lexicographically-minimal orbit element, as a hashable key."""
    O = _orbit_np(np.asarray(M, np.float32))
    flat = (O.reshape(O.shape[0], -1) > 0).astype(np.uint8)
    order = np.lexsort(flat.T[::-1])
    return flat[order[0]].tobytes()


def dedupe_exact(Ms: np.ndarray) -> np.ndarray:
    """Drop orbit-equivalent duplicates from a stack of solutions."""
    seen, keep = set(), []
    for i, M in enumerate(Ms):
        k = canonical_key(M)
        if k not in seen:
            seen.add(k)
            keep.append(i)
    return Ms[np.array(keep, dtype=np.int64)]


def cluster_exact_solutions(Ms: np.ndarray, num_domains: int = 4) -> np.ndarray:
    """Ward hierarchical clustering of exact solutions by Hamming distance,
    cut into ``num_domains`` groups (paper Fig. 5b).  Returns labels."""
    from scipy.cluster.hierarchy import fcluster, linkage

    flat = (Ms.reshape(Ms.shape[0], -1) > 0).astype(np.float64)
    Z = linkage(flat, method="ward")
    return fcluster(Z, t=num_domains, criterion="maxclust") - 1


def assign_domains(X: np.ndarray, exact: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Assign each candidate x (rows of X, flattened +-1) to the domain of the
    Hamming-closest exact solution (paper Fig. 4)."""
    Xf = X.reshape(X.shape[0], -1)
    Ef = exact.reshape(exact.shape[0], -1)
    # Hamming distance for +-1 vectors: (n - x.e)/2
    dots = Xf @ Ef.T
    nearest = np.argmax(dots, axis=1)
    return labels[nearest]
