"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; skips elsewhere.  Imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import bitlinear as bl
from repro_torch.kernels import ref
from repro_torch.kernels import sa_sweep as sa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dyadic_problems(rng, P, n):
    """h, B on the grid k/64 with |.| <= 4: every field and energy sum is
    exact in float32, so any summation order gives the same bits."""
    h = rng.integers(-256, 257, (P, n)) / 64.0
    B = rng.integers(-256, 257, (P, n, n)) / 64.0
    B = np.triu(B, 1)
    B = B + np.swapaxes(B, 1, 2)
    return h.astype(np.float32), B.astype(np.float32)


@pytest.mark.parametrize("P,C,S,n", [(64, 4, 24, 24), (16, 3, 8, 40), (8, 10, 4, 100)])
def test_sa_sweep_kernel_bit_identical(dev, P, C, S, n):
    rng = np.random.default_rng(P * n + C)
    h, B = _dyadic_problems(rng, P, n)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(8.0, 0.05, S, dtype=np.float32), (P, S)).copy()
    args = [torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps)]
    before = sa.sa_sweep_many.launches
    xk, ek = sa.sa_sweep_many(*args)
    torch.cuda.synchronize()
    assert sa.sa_sweep_many.launches == before + 1
    xr, er = ref.sa_sweep_many_ref(*args)
    assert torch.equal(xk, xr)
    assert torch.equal(ek, er)


@pytest.mark.parametrize("T", [1, 13, 40])
@pytest.mark.parametrize("K", [3, 4, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitlinear_kernel_matches_plain(dev, T, K, dtype):
    g = torch.Generator(device=dev).manual_seed(T * 16 + K)
    n_r, n_c, tn, td = 3, 2, 16, 160
    kb = (K + 7) // 8
    mp = torch.randint(0, 256, (n_r, n_c, tn, kb), generator=g, device=dev, dtype=torch.uint8)
    C = (torch.randn(n_r, n_c, K, td, generator=g, device=dev) * 0.2).to(dtype)
    x = torch.randn(T, n_r * tn, generator=g, device=dev).to(dtype)
    before = bl.bitlinear.launches
    yk = bl.bitlinear(x, mp, C)
    torch.cuda.synchronize()
    assert bl.bitlinear.launches == before + 1
    yr = ref.bitlinear_ref(x, mp, C)
    assert yk.dtype == dtype and yk.shape == (T, n_c * td)
    if dtype == torch.float32:
        torch.testing.assert_close(yk, yr, rtol=1e-4, atol=1e-4)
    else:
        scale = yr.float().abs().max().item()
        assert (yk.float() - yr.float()).abs().max().item() <= 2e-2 * scale
