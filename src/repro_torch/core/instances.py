"""Problem-instance generation (paper Methods: "Shrunk VGG matrix").

Counterpart of ``repro/core/instances.py``.  The paper shrinks VGG16's last
fully connected layer (4096 x 1000) via SVD to an 8 x 100 matrix.  Without
the pretrained weights an instance reproduces the statistics of that
construction: W = A diag(sigma) B with Gaussian A (N x r), B (r x D) at the
scales of rows of orthogonal matrices, a power-law spectrum sigma_i = i^-0.8,
and ||W||_F = 1.  Ten seeds give the paper's ten instances.

The ``*_from`` forms take the standard normal factors (``repro`` draws them
with ``jax.random``); the seeded forms draw them from a CPU generator, so an
instance is the same matrix on every device, and place it on ``device``
(default: the GPU).
"""

from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device

__all__ = [
    "shrunk_vgg_instance",
    "shrunk_vgg_instance_from",
    "random_instance",
    "random_instance_from",
    "paper_instances",
]


def shrunk_vgg_instance_from(A: torch.Tensor, B: torch.Tensor, gamma: float = 0.8) -> torch.Tensor:
    """W (N x D) from standard normal factors A (N, rank), B (rank, D)."""
    rank = A.shape[1]
    A = A / math.sqrt(4096.0)
    B = B / math.sqrt(1000.0)
    sigma = torch.arange(1, rank + 1, dtype=A.dtype, device=A.device) ** (-gamma)
    W = A @ (sigma[:, None] * B)
    # ||W||_F = 1: the paper's residual measure divides by ||W||, so the
    # scale is immaterial; normalising aids f32 conditioning
    return W / torch.linalg.vector_norm(W)


def shrunk_vgg_instance(seed: int, N: int = 8, D: int = 100, rank: int = 8,
                        gamma: float = 0.8, dtype=torch.float32, device=None) -> torch.Tensor:
    """One shrunk-VGG-like instance W (N x D) on ``device``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((N, rank), generator=g, dtype=dtype)
    B = torch.randn((rank, D), generator=g, dtype=dtype)
    return shrunk_vgg_instance_from(A.to(device), B.to(device), gamma)


def random_instance_from(Z: torch.Tensor) -> torch.Tensor:
    """Unstructured control instance from a standard normal Z (N, D)."""
    return Z / torch.linalg.vector_norm(Z)


def random_instance(seed: int, N: int = 8, D: int = 100, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Unstructured Gaussian control instance on ``device``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed ^ 0x5EED)
    return random_instance_from(torch.randn((N, D), generator=g, dtype=dtype).to(device))


def paper_instances(num: int = 10, **kw) -> list[torch.Tensor]:
    """The paper's ten instances (seeds 0..9)."""
    return [shrunk_vgg_instance(seed, **kw) for seed in range(num)]
