"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; skips elsewhere.  Imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.kernels import bitlinear as bl
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sa_sweep as sa
from repro_torch.kernels import sqa_sweep as sqa
from repro_torch.models import init_model
from repro_torch.models.params import split
from repro_torch.serving import Engine

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


@pytest.mark.parametrize("P,C,T,S,n", [(1, 1, 3, 5, 40), (7, 13, 1, 4, 24), (2, 9, 2, 6, 8),
                                       (3, 4, 16, 3, 33), (25, 10, 8, 16, 24)])
def test_sqa_sweep_kernel_bit_identical(dev, P, C, T, S, n):
    rng = np.random.default_rng(P * n + C * T)
    h, B = _dyadic_problems(rng, P, n)
    X0 = np.where(rng.random((P, C, T, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, T, n), dtype=np.float32)
    jp = np.geomspace(2.0, 1e-3, S).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (h, B, X0, u, jp)]
    before = sqa.sqa_sweep_many.launches
    Xk, Ek = sqa.sqa_sweep_many(*args, temperature=0.05)
    torch.cuda.synchronize()
    assert sqa.sqa_sweep_many.launches == before + 1
    Xr, Er = ref.sqa_sweep_many_ref(*args, temperature=0.05)
    assert torch.equal(Xk, Xr)
    assert torch.equal(Ek, Er)


def test_sqa_sweep_kernel_refuses_shapes_beyond_shared_memory(dev):
    P, C, T, n = 1, 8, 64, sqa.max_spins(8, 64) + 1
    with pytest.raises(ValueError, match="shared-memory limit"):
        sqa.sqa_sweep_many(torch.zeros(P, n, device=dev), torch.zeros(P, n, n, device=dev),
                           torch.ones(P, C, T, n, device=dev),
                           torch.zeros(P, C, 1, T, n, device=dev), torch.zeros(1, device=dev))


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


@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("T", [1, 13, 40])
@pytest.mark.parametrize("K", [3, 4, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bitlinear_grouped_kernel_matches_plain(dev, E, T, K, dtype):
    g = torch.Generator(device=dev).manual_seed(E * 1000 + T * 16 + K)
    n_r, n_c, tn, td = 3, 2, 16, 160
    kb = (K + 7) // 8
    mp = torch.randint(0, 256, (E, n_r, n_c, tn, kb), generator=g, device=dev,
                       dtype=torch.uint8)
    C = (torch.randn(E, n_r, n_c, K, td, generator=g, device=dev) * 0.2).to(dtype)
    x = torch.randn(E, T, n_r * tn, generator=g, device=dev).to(dtype)
    before = bl.bitlinear_grouped.launches
    yk = bl.bitlinear_grouped(x, mp, C)
    torch.cuda.synchronize()
    assert bl.bitlinear_grouped.launches == before + 1
    yr = ref.bitlinear_grouped_ref(x, mp, C)
    assert yk.dtype == dtype and yk.shape == (E, T, n_c * td)
    if dtype == torch.float32:
        torch.testing.assert_close(yk, yr, rtol=1e-4, atol=1e-4)
    else:
        scale = yr.float().abs().max().item()
        assert (yk.float() - yr.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("B,H,KV,S,hd,win", [
    (2, 4, 2, 128, 32, 0),
    (1, 8, 8, 256, 64, 64),     # MHA + sliding window
    (2, 4, 1, 128, 16, 0),      # MQA
    (1, 2, 2, 64, 128, 32),
    (2, 8, 2, 100, 128, 0),     # ragged S: the last query and kv tiles are partial
    (1, 4, 2, 1, 64, 0),        # one position
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, H, KV, S, hd, win, dtype):
    g = torch.Generator(device=dev).manual_seed(B * S + hd)
    q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
    before = fa.flash_attention.launches
    o = fa.flash_attention(q, k, v, win)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    r = ref.flash_attention_ref(q, k, v, win)
    assert o.dtype == dtype and o.shape == q.shape
    # the Pallas kernel's tolerance against its oracle (tests/test_kernels.py)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(o.float(), r.float(), rtol=tol, atol=tol)


def test_engine_serves_through_both_kernels(dev):
    """A reduced bf16 model compressed on the card: every prefill attention
    goes through K5, every compressed layer of every step through K3, and
    the tokens are in range."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("qwen3-32b")), dtype="bfloat16")
    values, _ = split(init_model(cfg, seed=0, device=dev))
    policy = CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                               min_size=4096)
    cvals, art = execute_plan(plan_compression(values, policy), values, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), device=dev)
    before = (fa.flash_attention.launches, bl.bitlinear.launches)
    try:
        eng = Engine(cfg, cvals, max_len=24, batch=2, eos_id=cfg.vocab_size, artifact=art)
        out = eng.generate(prompts, 8)
    finally:
        ops.disable_kernels()
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before[0] == cfg.num_layers
    # one launch per compressed weight per layer (its group slice) per forward
    per_forward = sum(math.prod(e["group_dims"]) for e in art.manifest["tensors"].values())
    assert bl.bitlinear.launches - before[1] == per_forward * 8
    assert out.shape == (2, 24) and torch.equal(out[:, :16], prompts)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size


def test_engine_serves_moe_through_the_grouped_kernel(dev):
    """Reduced bf16 granite-moe compressed on the card: every expert stack
    of every layer and step goes through K4, the attention projections
    through K3, and the tokens are in range."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("granite-moe-1b-a400m")),
                              dtype="bfloat16")
    values, _ = split(init_model(cfg, seed=0, device=dev))
    policy = CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                               min_size=4096)
    cvals, art = execute_plan(plan_compression(values, policy), values, seed=0, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (2, 16), device=dev)
    before = (bl.bitlinear.launches, bl.bitlinear_grouped.launches)
    try:
        eng = Engine(cfg, cvals, max_len=24, batch=2, eos_id=cfg.vocab_size, artifact=art)
        out = eng.generate(prompts, 8)
    finally:
        ops.disable_kernels()
    torch.cuda.synchronize()
    assert eng.compression["grouped_tensors"] == 3
    tensors = art.manifest["tensors"].values()
    per_forward = {n: sum(e["group_dims"][0] for e in tensors if (len(e["group_dims"]) == 2) == g)
                   for n, g in (("k3", False), ("k4", True))}
    assert per_forward["k4"] == 3 * cfg.num_layers
    assert bl.bitlinear.launches - before[0] == per_forward["k3"] * 8
    assert bl.bitlinear_grouped.launches - before[1] == per_forward["k4"] * 8
    assert out.shape == (2, 24) and torch.equal(out[:, :16], prompts)
    assert int(out.min()) >= 0 and int(out.max()) < cfg.vocab_size
