"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Needs an NVIDIA GPU with ``nvcc``; skips elsewhere.  Imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_cuda.py
"""

import ctypes
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
from repro_torch.models import forward, init_cache, init_model
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


# (64, 4) and (8, 10) run 32 lanes per chain; (4096, 10, ., 24) 4 lanes, 8
# chains per warp; (4100, 4, ., 24) 8 lanes; (410, 10, ., 100) 16 lanes; (25,
# 10, 64, 24) is the paper's BBO loop (phase 6)
@pytest.mark.parametrize("P,C,S,n", [(64, 4, 24, 24), (16, 3, 8, 40), (8, 10, 4, 100),
                                     (25, 10, 64, 24), (4096, 10, 4, 24), (4100, 4, 4, 24),
                                     (410, 10, 4, 100)])
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


# the global-memory body (n above max_spins(C)): the budget allocator's
# shape (6 penalty problems x 8 reads) at n = 238 and 1,024, and a direct-
# acceptance launch (4,096 chains)
# and few chains at C = 1, 3, 8 (each chain split over a block's warps, the
# form sa.global_warps picks while the chains run in one wave) just above
# the shared body's limit (241: max_spins is 240 at one chain, 239 at three)
# and at 1,000 (a ragged last warp, rows off 16-byte boundaries), and 136
# chains, past one wave of split blocks on an H100's 132 SMs (split at
# 1,000 spins, two waves; a warp a chain at 300); each launch runs the
# body it reports, the one the mirror of the rule names
@pytest.mark.parametrize("P,C,S,n", [(6, 8, 6, 238), (6, 8, 3, 1024), (2, 3, 4, 300),
                                     (512, 8, 2, 241), (1, 1, 5, 241), (2, 3, 3, 241),
                                     (1, 8, 2, 1000), (1, 1, 2, 1000), (3, 3, 2, 1000),
                                     (17, 8, 2, 300), (17, 8, 2, 1000)])
def test_sa_sweep_global_body_bit_identical(dev, P, C, S, n):
    assert not sa.shared_body(n, C)
    body = ("global/split" if sa.global_warps(P * C, n, bl.device_sms(dev)) > 1
            else "global/warp")
    rng = np.random.default_rng(P * n + C)
    h, B = _dyadic_problems(rng, P, n)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(8.0, 0.05, S, dtype=np.float32), (P, S)).copy()
    args = [torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps)]
    before, by_body = sa.sa_sweep_many.launches, dict(sa.sa_sweep_many.by_body)
    xk, ek = sa.sa_sweep_many(*args)
    torch.cuda.synchronize()
    assert sa.sa_sweep_many.launches == before + 1
    assert sa.sa_sweep_many.by_body[body] == by_body[body] + 1
    xr, er = ref.sa_sweep_many_ref(*args)
    assert torch.equal(xk, xr)
    assert torch.equal(ek, er)


@pytest.mark.parametrize("n", [301, 1000])
def test_sa_sweep_global_body_takes_an_unaligned_b(dev, n):
    """The global-memory body copies B's rows in 16-byte pieces: a B view
    off a 16-byte boundary is copied by the wrapper, with the same result."""
    rng = np.random.default_rng(5)
    P, C, S = 2, 3, 3
    h, B = _dyadic_problems(rng, P, n)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(8.0, 0.05, S, dtype=np.float32), (P, S)).copy()
    args = [torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps)]
    flat = torch.zeros(P * n * n + 1, device=dev)
    flat[1:] = args[1].reshape(-1)
    Bv = flat[1:].view(P, n, n)
    assert Bv.data_ptr() % 16
    xk, ek = sa.sa_sweep_many(args[0], Bv, *args[2:])
    xr, er = ref.sa_sweep_many_ref(*args)
    assert torch.equal(xk, xr) and torch.equal(ek, er)


@pytest.mark.parametrize("split", [None, True, False])
@pytest.mark.parametrize("P,C,n", [(6, 8, 200), (3, 5, 40), (4100, 1, 24), (6, 8, 237),
                                   (1, 1, 237)])
def test_sa_sweep_bodies_identical_on_rounded_sums(dev, P, C, n, split):
    """Normal h and B, whose sums round: the global-memory body, a warp a
    chain or each chain split over a block's warps (``split``; None: the
    rule's), makes the shared-memory body's every addition in its order, so
    their bits agree."""
    rng = np.random.default_rng(n)
    h = rng.standard_normal((P, n)).astype(np.float32)
    B = np.triu(rng.standard_normal((P, n, n)), 1).astype(np.float32)
    B = B + np.swapaxes(B, 1, 2)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    S = 4
    u = rng.random((P, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(30.0, 0.5, S, dtype=np.float32), (P, S)).copy()
    args = [torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps)]
    assert sa.shared_body(n, C) and sa.lanes_per_chain(P, C, n) == 32
    xs, es = sa.sa_sweep_many(*args)
    xg, eg = sa.sa_sweep_many_global(*args, split=split)
    torch.cuda.synchronize()
    assert torch.equal(xs, xg)
    assert torch.equal(es, eg)


def test_sa_sweep_body_rule_is_the_librarys(dev):
    lib = sa._build.load("sa_sweep")
    lib.sa_sweep_shared_body.restype = ctypes.c_int
    lib.sa_sweep_max_spins.restype = ctypes.c_int
    assert lib.sa_sweep_max_spins() == sa.MAX_SPINS
    for C in (1, 2, 7, 8, 9, 64):
        for n in (1, 24, 200, 236, 237, 238, 239, 240, 241, 256, 257, 1024):
            assert bool(lib.sa_sweep_shared_body(n, C)) == sa.shared_body(n, C), (n, C)
    fn = lib.sa_sweep_global_warps
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    for chains in (1, 48, 114, 115, 132, 133, 256, 264, 265, 8192):
        for n in (24, 238, 256, 257, 511, 512, 513, 1000, 1024):
            for sms in (132, 114):
                assert fn(chains, n, sms) == sa.global_warps(chains, n, sms), (chains, n, sms)


def test_sa_sweep_refuses_above_its_limit(dev):
    P, C, S, n = 1, 2, 1, sa.MAX_SPINS + 1
    with pytest.raises(ValueError, match="limit of 1024"):
        sa.sa_sweep_many(torch.zeros(P, n, device=dev), torch.zeros(P, n, n, device=dev),
                         torch.ones(P, C, n, device=dev), torch.zeros(P, C, S, n, device=dev),
                         torch.ones(P, S, device=dev))


def _dyadic_curves(n_tensors):
    """RD curves whose QUBO (compression/autotune/allocate.py) has dyadic h
    and B: 5 hull points a tensor at 0, 8, 16, 24, 40 extra bytes,
    distortions c x (32, 16, 8, 4, 0) with c in {1, 2, 4} (spread 128), and
    a headroom of 64 bytes: every field sum is exact in float32."""
    from repro_torch.compression.autotune import ProbeResult, RDPoint

    out = []
    for i in range(n_tensors):
        c, base = (1, 2, 4)[i % 3], 64 + 8 * i
        pts = tuple(RDPoint(32, 128, K, base + extra, float(c * d))
                    for K, extra, d in zip((1, 2, 3, 4, 5), (0, 8, 16, 24, 40),
                                           (32, 16, 8, 4, 0)))
        out.append(ProbeResult(f"t{i}", base + 64, 1.0, pts))
    return out


def test_qubo_allocator_above_the_shared_limit_is_its_cpu_run(dev):
    """60 tensors x 5 hull points + 6 slack spins = 306 spins: K1's
    global-memory body, one launch, and the allocation the plain version
    gives on the CPU from the same draws."""
    from repro_torch.compression.autotune import allocate as al
    from repro_torch.core import ising

    probes = _dyadic_curves(60)
    budget = sum(p.min_bytes for p in probes) + 64
    g = torch.Generator().manual_seed(0)
    draws = {}

    def draw(P, R, S, n):
        if not draws:
            draws["x0"], draws["u"] = ising.draw_initial(P, R, S, n, g)
        return draws["x0"], draws["u"]

    cpu = al.allocate_budget_from(probes, budget, draw, engine="qubo", device="cpu")
    before = sa.sa_sweep_many.launches
    card = al.allocate_budget_from(probes, budget, draw, engine="qubo", device=dev)
    assert sa.sa_sweep_many.launches == before + 1
    assert cpu.num_spins == card.num_spins == 306 and not sa.shared_body(306, 8)
    assert card.to_dict() | {"solve_s": 0} == cpu.to_dict() | {"solve_s": 0}
    assert card.total_bytes <= budget


# the wavefront's shapes: T = 1 (the sequential sweep), T = 2, 3, 8 (every
# slice in flight), n < T (T = 13, n = 5: skew 1), and fewer groups than
# slices (T = 16; T = 8 at n = 40): fields pass between groups
@pytest.mark.parametrize("P,C,T,S,n", [(1, 1, 3, 5, 40), (7, 13, 1, 4, 24), (2, 9, 2, 6, 8),
                                       (3, 4, 16, 3, 33), (25, 10, 8, 16, 24), (2, 3, 13, 5, 5),
                                       (2, 3, 16, 3, 24), (2, 5, 8, 3, 40)])
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


@pytest.mark.parametrize("kernel", ["sa", "sqa"])
def test_annealers_on_rounded_sums_match_plain_decisions(dev, kernel):
    """Normal h and B: the kernels' fields sum in index order, the plain
    versions' through einsum, so only the spins' flips are compared where
    both start from the same fields: h alone (B = 0)."""
    rng = np.random.default_rng(3)
    P, C, T, S, n = 25, 10, 8, 16, 24
    h = rng.standard_normal((P, n)).astype(np.float32)
    B = np.zeros((P, n, n), np.float32)
    if kernel == "sa":
        x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
        u = rng.random((P, C, S, n), dtype=np.float32)
        temps = np.broadcast_to(np.geomspace(3.0, 0.05, S, dtype=np.float32), (P, S)).copy()
        args = [torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps)]
        out, want = sa.sa_sweep_many(*args), ref.sa_sweep_many_ref(*args)
    else:
        X0 = np.where(rng.random((P, C, T, n)) < 0.5, -1.0, 1.0).astype(np.float32)
        u = rng.random((P, C, S, T, n), dtype=np.float32)
        jp = np.geomspace(2.0, 1e-3, S).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (h, B, X0, u, jp)]
        out, want = sqa.sqa_sweep_many(*args, 0.3), ref.sqa_sweep_many_ref(*args, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])


@pytest.mark.parametrize("library", ["sa_sweep", "sqa_sweep"])
def test_expf_never_decreases_below_zero(dev, library):
    assert sa.expf_decreases(dev, library) == 0


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
    (2, 4, 4, 200, 64, 4096),   # MHA, a window past S (zamba2's shared block)
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


def test_zamba2_forward_through_the_kernels_matches_plain(dev):
    """Reduced bf16 zamba2 (14 layers: two groups and a remainder) compressed
    on the card (in_proj at td 37): a 40-token prefill through K3 and K5
    (one launch per shared-block call) and a decode step through K3 against
    the plain path, within 5e-2 of max|logit|, as chip_smoke.py holds the
    whole model."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("zamba2-1.2b")), dtype="bfloat16",
                              num_layers=14)
    values, _ = split(init_model(cfg, seed=0, device=dev))
    policy = CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                               min_size=4096)
    cvals, art = execute_plan(plan_compression(values, policy), values, seed=0, device=dev)
    tensors = art.manifest["tensors"]
    assert tensors["groups/0/ssm/in_proj/w"]["tile_d"] == 37
    n_shared = cfg.num_groups       # one ssm_attn layer a group, none in the remainder
    per_forward = sum(n_shared if p.startswith("shared/") else
                      (e["group_dims"][0] if e["group_dims"] else 1) for p, e in tensors.items())
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=dev)

    def run(kernels):
        if kernels:
            ops.enable_kernels()
        try:
            cache = init_cache(cfg, 2, 44, device=dev)
            with torch.inference_mode():
                l0, cache, _ = forward(cvals, {"tokens": tokens}, cfg, cache=cache)
                l1, _, _ = forward(cvals, {"tokens": tokens[:, :1]}, cfg, cache=cache,
                                   pos_offset=40)
        finally:
            ops.disable_kernels()
        return l0.float(), l1.float()

    before = (fa.flash_attention.launches, bl.bitlinear.launches)
    kernel = run(True)
    torch.cuda.synchronize()
    assert (fa.flash_attention.launches - before[0],
            bl.bitlinear.launches - before[1]) == (n_shared, 2 * per_forward)
    plain = run(False)
    for k, p in zip(kernel, plain):
        assert bool(torch.isfinite(k).all())
        assert (k - p).abs().max().item() <= 5e-2 * p.abs().max().item()


def test_scheduler_on_the_card_is_identical_under_eviction(dev):
    """Reduced bf16 zamba2 compressed on the card, served by the
    continuous-batching scheduler (2 slots, pages of 8, the shared block's KV
    paged): a pool cut so that a request that has decoded is evicted gives
    the tokens of a full pool, and K3 launches once per compressed call per
    forward (prefill forwards + decode ticks), K5 once per shared-block call
    per prefill forward."""
    from repro_torch.serving import Scheduler

    cfg = dataclasses.replace(reduced_for_smoke(get_config("zamba2-1.2b")), dtype="bfloat16",
                              num_layers=14)
    values, _ = split(init_model(cfg, seed=0, device=dev))
    policy = CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                               min_size=4096)
    cvals, art = execute_plan(plan_compression(values, policy), values, seed=0, device=dev)
    tensors = art.manifest["tensors"]
    n_shared = cfg.num_groups
    per_forward = sum(n_shared if p.startswith("shared/") else
                      (e["group_dims"][0] if e["group_dims"] else 1) for p, e in tensors.items())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=16).astype(np.int32) for _ in range(3)]

    def run(num_pages):
        eng = Engine(cfg, cvals, max_len=32, batch=1, eos_id=cfg.vocab_size, artifact=art)
        sched = Scheduler(eng, num_slots=2, page_size=8, num_pages=num_pages, device=dev)
        before = (fa.flash_attention.launches, bl.bitlinear.launches)
        try:
            toks = sched.generate_batch(prompts, max_tokens=12)
        finally:
            ops.disable_kernels()
        torch.cuda.synchronize()
        st = sched.stats
        assert st.prefill_chunks == st.admitted        # one exact-length chunk each
        assert (fa.flash_attention.launches - before[0],
                bl.bitlinear.launches - before[1]) == (
            n_shared * st.prefill_chunks, per_forward * (st.prefill_chunks + st.decode_steps))
        assert sched.pool.pages_in_use == 0
        return toks, st

    full, st_full = run(None)
    # 7 usable pages: two running requests of 2 pages a prompt outgrow them,
    # and the one that needs a page evicts the other after 10 and 11 tokens
    cut, st_cut = run(8)
    assert st_full.evictions == 0 and st_cut.evictions > 0
    assert cut == full
    assert all(len(t) == 12 and all(0 <= v < cfg.vocab_size for v in t) for t in full)


# ---------------------------------------------------------------------------
# K3/K4 schedules x bit algebras x activation dtypes, and the autotuner
# ---------------------------------------------------------------------------

def _variant_operands(g, dev, lead, T, n_r, n_c, tn, K, td, xd, cd):
    """int8 activations take C on the grid k/256 (|k| <= 16) and x in
    [-8, 8]: every f32 sum is exact, so the int8 output must be equal."""
    kb = (K + 7) // 8
    mp = torch.randint(0, 256, lead + (n_r, n_c, tn, kb), generator=g, device=dev,
                       dtype=torch.uint8)
    if xd == torch.int8:
        C = torch.randint(-16, 17, lead + (n_r, n_c, K, td), generator=g, device=dev) / 256
        x = torch.randint(-8, 9, lead + (T, n_r * tn), generator=g, device=dev,
                          dtype=torch.int8)
    else:
        C = torch.randn(lead + (n_r, n_c, K, td), generator=g, device=dev) * 0.2
        x = torch.randn(lead + (T, n_r * tn), generator=g, device=dev).to(xd)
    return x, mp, C.to(cd)


def _assert_variant(yk, yr, xd, cd):
    assert yk.dtype == yr.dtype and yk.shape == yr.shape
    if xd == torch.int8:
        assert torch.equal(yk, yr)
    elif xd == cd == torch.float32:
        torch.testing.assert_close(yk, yr, rtol=1e-4, atol=1e-4)
    else:       # z is rounded to bf16 before z @ C
        scale = yr.float().abs().max().item()
        assert (yk.float() - yr.float()).abs().max().item() <= 2e-2 * scale


# the last five: tile widths that are no multiple of 16 (zamba2's in_proj
# td 131, mamba2-130m's 419, the reduced configs' 37, one n-tile of padding
# at 17) at tn 32, K 4; (33, ..., 131) has n_c 5, no multiple of the
# tensor-core block's four column tiles
SCHEDULE_SHAPES = [(1, 3, 2, 16, 3, 160), (13, 3, 2, 16, 9, 160), (40, 4, 3, 8, 3, 128),
                   (4, 5, 2, 16, 4, 48), (4, 8, 3, 32, 4, 131), (40, 6, 2, 32, 4, 37),
                   (4, 5, 2, 32, 4, 419), (33, 3, 5, 32, 4, 131), (20, 4, 6, 32, 4, 17)]


def _on_tensor_cores(mode, T, tn, K, td, xd, cd):
    """Whether a call runs the grid's tensor-core body, by the Python mirror
    of the library's rule."""
    return mode == "grid" and bl.grid_on_tensor_cores(T, tn, K, td, xd.itemsize, cd.itemsize)


@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("mode,opts", [("grid", {}), ("grid", {"block_t": 16, "r_chunk": 2}),
                                       ("decode", {}), ("stream", {}),
                                       ("stream", {"r_chunk": 2}), ("stream", {"r_chunk": 4}),
                                       ("stream", {"r_chunk": 8})])
def test_bitlinear_schedules_match_plain(dev, mode, opts, math_, cd, xd):
    g = torch.Generator(device=dev).manual_seed(7)
    for T, n_r, n_c, tn, K, td in SCHEDULE_SHAPES:
        x, mp, C = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, xd, cd)
        before = bl.bitlinear.by_schedule[f"{mode}/{math_}"]
        tc_before = bl.bitlinear.tensor_core_launches
        yk = bl.bitlinear(x, mp, C, mode=mode, math=math_, **opts)
        torch.cuda.synchronize()
        assert bl.bitlinear.by_schedule[f"{mode}/{math_}"] == before + 1
        # the shapes above T = 4 with K <= 8 take the tensor cores, odd td
        # included, and only for the grid with bf16 x and C
        on_mma = _on_tensor_cores(mode, T, tn, K, td, xd, cd)
        assert on_mma == (mode == "grid" and xd == cd == torch.bfloat16 and T > 4 and K <= 8)
        assert bl.bitlinear.tensor_core_launches == tc_before + on_mma
        _assert_variant(yk, ref.bitlinear_ref(x, mp, C, math_), xd, cd)


@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("mode", ["grid", "decode"])
def test_bitlinear_grouped_schedules_match_plain(dev, mode, math_, xd):
    g = torch.Generator(device=dev).manual_seed(8)
    for E, T in ((1, 13), (3, 4), (4, 1)):
        for cd in (torch.float32, torch.bfloat16):
            x, mp, C = _variant_operands(g, dev, (E,), T, 3, 2, 16, 9, 96, xd, cd)
            before = bl.bitlinear_grouped.by_schedule[f"{mode}/{math_}"]
            yk = bl.bitlinear_grouped(x, mp, C, mode=mode, math=math_)
            torch.cuda.synchronize()
            assert bl.bitlinear_grouped.by_schedule[f"{mode}/{math_}"] == before + 1
            _assert_variant(yk, ref.bitlinear_grouped_ref(x, mp, C, math_), xd, cd)


def test_bitlinear_refuses_what_the_card_does_not_serve(dev):
    x = torch.zeros(128, 25600, dtype=torch.float32, device=dev)
    mp = torch.zeros(800, 1, 32, 1, dtype=torch.uint8, device=dev)
    C = torch.zeros(800, 1, 4, 128, device=dev)
    with pytest.raises(ValueError, match="shared memory"):      # 128 rows of partial y per warp
        bl.bitlinear(x, mp, C, mode="decode")
    with pytest.raises(ValueError, match="jnp"):                # the plain version
        bl.bitlinear(x, mp, C, mode="jnp")
    assert bl.bitlinear(x[:4].bfloat16(), mp, C, mode="auto").shape == (4, 128)


def test_block_layout_is_what_the_launch_admits(dev):
    """smem_bytes (the library's layout) is the exact budget a launch
    takes: at that budget it launches, one byte under it is refused."""
    g = torch.Generator(device=dev).manual_seed(9)
    for T, n_r, n_c, tn, K, td in SCHEDULE_SHAPES:
        for xd, cd in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                       (torch.int8, torch.float32)):
            x, mp, C = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, xd, cd)
            for mode, rc in (("grid", 2), ("decode", 1), ("stream", 2)):
                rc = bl.resolve_r_chunk(n_r, rc)
                need = bl.smem_bytes(mode, T=T, n_r=n_r, tn=tn, K=K, td=td,
                                     x_itemsize=x.element_size(), c_itemsize=C.element_size(),
                                     r_chunk=rc)
                y = bl.bitlinear(x, mp, C, mode=mode, r_chunk=rc, smem_budget=need)
                _assert_variant(y, ref.bitlinear_ref(x, mp, C), xd, cd)
                with pytest.raises(ValueError, match=f"needs {need} bytes of shared memory"):
                    bl.bitlinear(x, mp, C, mode=mode, r_chunk=rc, smem_budget=need - 1)
    # decode stages a few r tiles at a time, not every row of x: its block
    # does not grow with d_in, and qwen3-32b's down (d_in 25,600) fits at
    # T = 4 and 16 in every activation dtype
    budget = bl.device_smem_budget(dev)
    for xs in (4, 2, 1):
        sizes = {bl.smem_bytes("decode", T=4, n_r=n_r, tn=32, K=4, td=128, x_itemsize=xs,
                               c_itemsize=4) for n_r in (8, 160, 800)}
        assert len(sizes) == 1
        assert bl.decode_path_ok(4, 800, 32, 4, 128, xs, budget)
        assert bl.decode_path_ok(16, 800, 32, 4, 128, xs, budget)


# (E, T, n_r, n_c, tn, K, td): r tiles that no S divides evenly (S = 8 over
# n_r = 7 leaves a block without tiles), E = 32, BBO's 8-byte M tiles (tn = 8,
# K = 3), T > 8 in row groups with kb = 2, td > 128 in two column chunks (C
# read from device memory), tn, td that fit no vector (direct loads), and
# odd td: zamba2's in_proj tile (td 131: a C tile of 1,048 bf16 bytes, not
# staged), mamba2-130m's (td 419, four column chunks) and the reduced
# configs' (td 37)
DECODE_SHAPES = [(1, 4, 7, 3, 32, 4, 128), (32, 3, 5, 2, 32, 4, 128), (1, 5, 11, 2, 8, 3, 128),
                 (1, 37, 6, 2, 16, 9, 48), (1, 1, 9, 3, 16, 9, 160), (2, 4, 13, 2, 12, 3, 20),
                 (1, 4, 8, 3, 32, 4, 131), (1, 4, 24, 8, 32, 4, 419), (1, 3, 6, 2, 32, 4, 37)]
# odd td: C staged raw at td 131 (bl.decode_layout; T <= 4), from device
# memory by one set of blocks per chunk at 419 and above T = 4: K3 and K4
# (E = 2) at zamba2's td 131 and mamba2-130m's 419 at T = 1, 2, 4, T > 8
# in row groups, and r tiles no S divides
DECODE_ODD_SHAPES = [(2, 4, 9, 3, 32, 4, 131), (2, 2, 7, 2, 32, 4, 419),
                     (1, 13, 5, 2, 32, 4, 419), (1, 1, 33, 2, 32, 4, 131),
                     (2, 4, 24, 2, 32, 4, 419), (1, 2, 64, 3, 32, 4, 131)]


@pytest.mark.parametrize("shapes", ["tiles", "odd_td"])
@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("S", [1, 2, 8, 16, None])
def test_decode_matches_plain_at_every_cluster_size(dev, monkeypatch, S, math_, cd, xd, shapes):
    """The decode kernel against the plain version with r split over
    clusters of S blocks (16: non-portable; None: the rule's S, else the
    rule pinned to S), counted by the S of the launch."""
    g = torch.Generator(device=dev).manual_seed(14)
    cases = DECODE_SHAPES if shapes == "tiles" else DECODE_ODD_SHAPES
    want = [bl.decode_cluster_size(E * n_c, n_r, bl.device_sms(dev)) if S is None else S
            for E, T, n_r, n_c, tn, K, td in cases]
    if S is not None:
        monkeypatch.setattr(bl, "decode_cluster_size", lambda *a: S)
    for (E, T, n_r, n_c, tn, K, td), want_s in zip(cases, want):
        lead = (E,) if E > 1 else ()
        fn, plain = ((bl.bitlinear_grouped, ref.bitlinear_grouped_ref) if lead
                     else (bl.bitlinear, ref.bitlinear_ref))
        x, mp, C = _variant_operands(g, dev, lead, T, n_r, n_c, tn, K, td, xd, cd)
        before = dict(fn.decode_clusters)
        yk = fn(x, mp, C, mode="decode", math=math_)
        torch.cuda.synchronize()
        assert fn.decode_clusters.get(want_s, 0) == before.get(want_s, 0) + 1
        assert sum(fn.decode_clusters.values()) == sum(before.values()) + 1
        _assert_variant(yk, plain(x, mp, C, math_), xd, cd)


@pytest.mark.parametrize("td", [128, 131, 419])
@pytest.mark.parametrize("S", [1, 8, None])
@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16])
def test_decode_launches_give_identical_bits(dev, monkeypatch, xd, S, td):
    """Partial sums are added in a fixed order (warps, then cluster ranks):
    two launches on the same inputs give the same bits (S: the rule pinned
    to it; None: the rule's), at qwen's td 128 and the odd td of zamba2's
    (C staged raw) and mamba2-130m's in_proj."""
    g = torch.Generator(device=dev).manual_seed(15)
    if S is not None:
        monkeypatch.setattr(bl, "decode_cluster_size", lambda *a: S)
    shapes = ((1, 4, 160, 4, 32, 4, td), (32, 4, 32, 4, 32, 4, td), (1, 4, 640, 8, 8, 3, td))
    for E, T, n_r, n_c, tn, K, td in shapes:
        lead = (E,) if E > 1 else ()
        fn = bl.bitlinear_grouped if lead else bl.bitlinear
        x, mp, C = _variant_operands(g, dev, lead, T, n_r, n_c, tn, K, td, xd, xd)
        y0 = fn(x, mp, C, mode="decode", math="bitplane")
        y1 = fn(x, mp, C, mode="decode", math="bitplane")
        torch.cuda.synchronize()
        assert torch.equal(y0, y1)


def test_decode_layout_is_the_librarys(dev):
    """bl.decode_layout (the Python mirror) is what the built library's
    decode_geom computes (bl.built_decode_layout): r tiles a stage, how C
    is staged, blocks along td."""
    for T in (1, 4, 13):
        for tn, K in ((32, 4), (8, 3), (16, 9), (12, 3)):
            for td in (20, 37, 48, 128, 129, 131, 160, 161, 419):
                for xs in (4, 2, 1):
                    for cs in (4, 2):
                        kw = dict(T=T, tn=tn, K=K, td=td, x_itemsize=xs, c_itemsize=cs)
                        assert bl.built_decode_layout(**kw) == bl.decode_layout(**kw), kw


# (T, n_r, n_c, tn, K, td): ragged T in one and several register groups, T
# past a block's STREAM_ROWS (several row blocks, the last partial), qwen's
# tile and the BBO tile (M from device memory), C wider than one column chunk
# (a box reaching past td), r tiles no r_chunk divides, int8-sized tiles,
# and odd td (zamba2's 131, whose bf16 C map TMA refuses; mamba2-130m's 419
# in four column chunks; the reduced configs' 37)
STREAM_SHAPES = [(3, 6, 2, 32, 4, 128), (13, 5, 3, 16, 9, 160), (37, 12, 2, 32, 4, 128),
                 (70, 9, 2, 8, 3, 128), (300, 4, 2, 32, 4, 64), (5, 7, 3, 16, 3, 32),
                 (4, 40, 3, 32, 4, 128), (4, 8, 3, 32, 4, 131), (4, 24, 8, 32, 4, 419),
                 (37, 6, 2, 32, 4, 37)]


@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("rc", [1, 3, 8])
def test_stream_matches_plain_at_ragged_and_long_t(dev, rc, math_, xd):
    """Stream against the plain version at T in one, several and partial
    register groups and row blocks, counted by the wrapper at the rule's S
    with the parts the Python rule predicts."""
    g = torch.Generator(device=dev).manual_seed(16)
    for T, n_r, n_c, tn, K, td in STREAM_SHAPES:
        for cd in (torch.float32, torch.bfloat16):
            x, mp, C = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, xd, cd)
            rcr = bl.resolve_r_chunk(n_r, rc)
            geo = bl.stream_geometry(T=T, tn=tn, K=K, td=td, x_itemsize=x.element_size(),
                                     c_itemsize=C.element_size(), r_chunk=rcr)
            if geo["smem"] > bl.device_smem_budget(dev):
                continue
            parts = "+".join(k for k, v in geo["maps"].items() if v) or "none"
            before = dict(bl.bitlinear.stream_maps)
            yk = bl.bitlinear(x, mp, C, mode="stream", math=math_, r_chunk=rc)
            torch.cuda.synchronize()
            assert bl.bitlinear.stream_maps.get(parts, 0) == before.get(parts, 0) + 1
            _assert_variant(yk, ref.bitlinear_ref(x, mp, C, math_), xd, cd)


@pytest.mark.parametrize("rc", [1, 4])
@pytest.mark.parametrize("xd", [torch.float32, torch.bfloat16])
def test_stream_launches_give_identical_bits(dev, xd, rc):
    """Partial sums are added in a fixed order (a warp's stages, the warps,
    then the cluster's ranks): two launches give the same bits, at qwen's
    gate-like and the BBO tiles' shapes, whose launches split r over
    clusters."""
    g = torch.Generator(device=dev).manual_seed(17)
    for T, n_r, n_c, tn, K, td in ((4, 160, 4, 32, 4, 128), (4, 640, 8, 8, 3, 128),
                                   (37, 96, 2, 32, 4, 128)):
        x, mp, C = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, xd, xd)
        y0 = bl.bitlinear(x, mp, C, mode="stream", math="bitplane", r_chunk=rc)
        y1 = bl.bitlinear(x, mp, C, mode="stream", math="bitplane", r_chunk=rc)
        torch.cuda.synchronize()
        assert torch.equal(y0, y1)
        _assert_variant(y0, ref.bitlinear_ref(x, mp, C, "bitplane"), xd, xd)


def test_stream_layout_is_the_python_mirror(dev):
    """The library's layout (shared memory, the parts it maps) is what
    bitlinear.stream_geometry and stream_tensor_maps compute, which the CPU
    tests hold to TMA's rules."""
    lib = bl._build.load("bitlinear_stream")
    lib.bitlinear_stream_layout_maps.argtypes = [ctypes.c_int] * 8
    lib.bitlinear_stream_layout_maps.restype = ctypes.c_int
    for T in (1, 4, 37, 4096):
        for tn, K, td in ((32, 4, 128), (8, 3, 128), (16, 9, 160), (16, 3, 20)):
            for xs, cs in ((2, 2), (4, 4), (1, 4)):
                for rc in (1, 2, 8):
                    geo = bl.stream_geometry(T=T, tn=tn, K=K, td=td, x_itemsize=xs,
                                             c_itemsize=cs, r_chunk=rc)
                    assert bl.smem_bytes("stream", T=T, n_r=64, tn=tn, K=K, td=td,
                                         x_itemsize=xs, c_itemsize=cs, r_chunk=rc) == geo["smem"]
                    bits = lib.bitlinear_stream_layout_maps(T, tn, (K + 7) // 8, K, td,
                                                            {4: 0, 2: 1, 1: 2}[xs], int(cs == 2),
                                                            rc)
                    assert {k: bool(bits & b) for k, b in bl._MAP_BITS} == geo["maps"]


def test_stream_map_cache_encodes_a_new_map_for_a_new_shape(dev):
    """M's and C's tensor maps are cached by every field of the encoding: a
    repeated call encodes none, and a tensor of another shape at the same
    address encodes new ones (and computes with them)."""
    lib = bl._build.load("bitlinear_stream")
    lib.bitlinear_stream_map_encodes.restype = ctypes.c_longlong
    g = torch.Generator(device=dev).manual_seed(18)
    n_r, n_c, tn, K, td = 8, 4, 32, 4, 128
    x, mp, C = _variant_operands(g, dev, (), 4, n_r, n_c, tn, K, td, torch.bfloat16,
                                 torch.bfloat16)
    bl.bitlinear(x, mp, C, mode="stream", r_chunk=2)
    torch.cuda.synchronize()
    first = lib.bitlinear_stream_map_encodes()
    y = bl.bitlinear(x, mp, C, mode="stream", r_chunk=2)
    torch.cuda.synchronize()
    assert lib.bitlinear_stream_map_encodes() == first           # both maps from the cache
    _assert_variant(y, ref.bitlinear_ref(x, mp, C), torch.bfloat16, torch.bfloat16)
    # the same buffers viewed as (4, 8, ...): same addresses, other dims
    mp2, C2 = mp.view(4, 2 * n_c, tn, 1), C.view(4, 2 * n_c, K, td)
    x2 = x[:, :4 * tn].contiguous()
    assert mp2.data_ptr() == mp.data_ptr() and C2.data_ptr() == C.data_ptr()
    y2 = bl.bitlinear(x2, mp2, C2, mode="stream", r_chunk=2)
    torch.cuda.synchronize()
    assert lib.bitlinear_stream_map_encodes() == first + 2       # a new C and a new M map
    _assert_variant(y2, ref.bitlinear_ref(x2, mp2, C2), torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("T", [1, 4, 16, 40])
def test_auto_runs_the_default_schedule(dev, T):
    """mode="auto" launches what autotune.heuristic resolves (one rule:
    decode up to SMALL_T rows, else the grid), in the caller's bit algebra;
    with a budget only the grid's block fits, the grid."""
    from repro_torch.kernels import autotune

    g = torch.Generator(device=dev).manual_seed(10)
    n_r, n_c, tn, K, td = 48, 4, 32, 4, 128
    for grouped, fn, lead in ((False, bl.bitlinear, ()), (True, bl.bitlinear_grouped, (3,))):
        x, mp, C = _variant_operands(g, dev, lead, T, n_r, n_c, tn, K, td, torch.bfloat16,
                                     torch.bfloat16)
        want = autotune.heuristic("bitlinear_grouped" if grouped else "bitlinear", n_r=n_r,
                                  n_c=n_c, tn=tn, kb=1, K=K, td=td, T=T, x_itemsize=2,
                                  c_itemsize=2, interpret=False)
        assert want.mode == ("decode" if T <= bl.SMALL_T else "grid")
        grid_only = bl.smem_bytes("grid", T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=2,
                                  c_itemsize=2)
        for budget, mode in ((None, want.mode), (grid_only, "grid")):
            before = dict(fn.by_schedule)
            y = fn(x, mp, C, math="unpack", smem_budget=budget)
            torch.cuda.synchronize()
            ran = {k for k, v in fn.by_schedule.items() if v != before[k]}
            assert ran == {f"{mode}/unpack"}
            plain = ref.bitlinear_grouped_ref if grouped else ref.bitlinear_ref
            _assert_variant(y, plain(x, mp, C), torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("T", [1, 2, 4])
@pytest.mark.parametrize("n_r,n_c,td", [(64, 64, 131), (24, 8, 419)])
def test_default_schedule_decodes_the_ssm_in_proj(dev, T, n_r, n_c, td):
    """zamba2-1.2b's in_proj (64 x 64 tiles of 32 x 131) and mamba2-130m's
    (24 x 8 of 32 x 419) at decode T resolve to decode, whose block (C staged
    raw, bl.decode_layout) fits the card in every activation dtype at f32 C,
    and the auto launch runs it."""
    budget = bl.device_smem_budget(dev)
    for xs in (4, 2, 1):
        assert bl.decode_path_ok(T, n_r, 32, 4, td, xs, budget)
        assert bl.default_schedule(T=T, n_r=n_r, tn=32, K=4, td=td, x_itemsize=xs,
                                   budget=budget)["mode"] == "decode"
    g = torch.Generator(device=dev).manual_seed(16)
    x, mp, C = _variant_operands(g, dev, (), T, n_r, n_c, 32, 4, td, torch.bfloat16,
                                 torch.bfloat16)
    before = bl.bitlinear.by_schedule["decode/bitplane"]
    y = bl.bitlinear(x, mp, C, math="bitplane")
    torch.cuda.synchronize()
    assert bl.bitlinear.by_schedule["decode/bitplane"] == before + 1
    _assert_variant(y, ref.bitlinear_ref(x, mp, C, "bitplane"), torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-moe-1b-a400m"])
def test_engine_serves_from_a_tuned_table(dev, arch):
    """tune_artifact on the card, then an Engine from the manifest: every
    resolution comes from the table and no resolution names the plain
    version.  granite-moe tunes and resolves its layer x expert stacks
    through the grouped kernel."""
    from repro_torch.kernels import autotune

    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype="bfloat16")
    values, _ = split(init_model(cfg, seed=0, device=dev))
    policy = CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                               min_size=4096)
    cvals, art = execute_plan(plan_compression(values, policy), values, seed=0, device=dev)
    autotune.clear_schedules()
    table = autotune.tune_artifact(art, T_values=(2, 32), repeats=1, iters=2)
    assert table["entries"] and all(e["mode"] != "jnp" for e in table["entries"].values())
    kinds = {k.split("|")[1] for k in table["entries"]}
    assert kinds == ({"bitlinear", "bitlinear_grouped"} if cfg.num_experts else {"bitlinear"})
    autotune.clear_schedules()
    autotune.clear_log()
    try:
        eng = Engine(cfg, cvals, max_len=24, batch=2, eos_id=cfg.vocab_size, artifact=art)
        assert eng.kernel_schedules == len(table["entries"])
        eng.generate(torch.randint(0, cfg.vocab_size, (2, 16), device=dev), 4)
    finally:
        ops.disable_kernels()
        autotune.clear_schedules()
    log = autotune.last_resolutions()
    assert log and all(r["source"] == "cache" for r in log)
    assert {r["key"] for r in log} <= set(table["entries"])
    assert {r["key"].split("|")[1] for r in log} == kinds


# ---------------------------------------------------------------------------
# K5's bf16 body (tensor cores) and the grid's bf16 x bf16 body (tensor cores)
# ---------------------------------------------------------------------------

def _f32_score_attention(q, k, v, window):
    """Attention from f32 scores with K5's one rounding of p to bf16:
    (o, p @ |v|), both f32."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    kr = k.float().repeat_interleave(rep, dim=1)
    vr = v.float().repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1).to(v.dtype).float()
    return p @ vr, p @ vr.abs()


@pytest.mark.parametrize("win", [0, 48, 4096])
@pytest.mark.parametrize("S", [1, 63, 65, 1024])
@pytest.mark.parametrize("rep", [1, 8])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_bf16_tensor_core_body(dev, hd, rep, S, win):
    """bf16 K5 against the plain version within the Pallas kernel's 5e-2, and
    against f32 scores within its rounding bound 2^-8 (|o32| + 2 p@|v|)."""
    B, KV = 2, 2
    g = torch.Generator(device=dev).manual_seed(hd * 10_000 + rep * 1_000 + S + win)
    q = torch.randn(B, KV * rep, S, hd, generator=g, device=dev).bfloat16()
    k = torch.randn(B, KV, S, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, KV, S, hd, generator=g, device=dev).bfloat16()
    o = fa.flash_attention(q, k, v, win)
    torch.cuda.synchronize()
    r = ref.flash_attention_ref(q, k, v, win)
    torch.testing.assert_close(o.float(), r.float(), rtol=5e-2, atol=5e-2)
    o32, pv_abs = _f32_score_attention(q, k, v, win)
    bound = 2.0 ** -8 * (o32.abs() + 2.0 * pv_abs) + 2e-5
    assert bool(((o.float() - o32).abs() <= bound).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_and_writes_the_model_layout(dev, dtype):
    """The adapter hands K5 strided views of (B, S, H, hd) tensors and gets o
    in that layout: the same bits as the contiguous (B, H, S, hd) call."""
    B, S, KV, rep, hd = 2, 130, 2, 4, 64
    g = torch.Generator(device=dev).manual_seed(11)
    qh = torch.randn(B, S, KV, rep, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dtype)
    before = fa.flash_attention.launches
    o = ops.flash_attention_model_layout(qh, k, v, 0)
    q = qh.reshape(B, S, KV * rep, hd).transpose(1, 2).contiguous()
    want = fa.flash_attention(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 2
    assert o.shape == (B, S, KV, rep, hd)
    assert torch.equal(o, want.transpose(1, 2).reshape(B, S, KV, rep, hd))


# the policies' (tn, K, td): attention tensors, qwen's BBO attn/w[kv], granite's experts
POLICY_SHAPES = [(32, 4, 128), (8, 3, 128), (32, 8, 64)]
# the default policy's in_proj tiles of zamba2 (td 131) and mamba2-130m (td
# 419), the reduced configs' (td 37) and one n-tile of padding (td 17): on
# the tensor cores above T = 4, C's rows staged raw and shifted into place
ODD_TILES = [(32, 4, 131), (32, 4, 419), (32, 4, 37), (32, 4, 17)]


@pytest.mark.parametrize("T", [1, 15, 17, 64, 1280, 4096])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("tn,K,td", POLICY_SHAPES + ODD_TILES)
def test_grid_bf16_matches_plain_at_the_policy_shapes(dev, tn, K, td, math_, T):
    """bf16 x and C through the grid at the policies' tiles: on the tensor
    cores above T = 4 at every td, on the FMA body at T = 1 (the small-T
    fallback); n_c 3 leaves the block's fourth column tile idle."""
    n_r, n_c = 24, 3
    g = torch.Generator(device=dev).manual_seed(tn * 100 + K * 10 + T)
    x, mp, C = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, torch.bfloat16,
                                 torch.bfloat16)
    before = bl.bitlinear.by_schedule[f"grid/{math_}"]
    tc_before = bl.bitlinear.tensor_core_launches
    yk = bl.bitlinear(x, mp, C, mode="grid", math=math_)
    torch.cuda.synchronize()
    assert bl.bitlinear.by_schedule[f"grid/{math_}"] == before + 1
    assert bl.bitlinear.tensor_core_launches == tc_before + _on_tensor_cores(
        "grid", T, tn, K, td, torch.bfloat16, torch.bfloat16)
    _assert_variant(yk, ref.bitlinear_ref(x, mp, C, math_), torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("T", [1, 17, 1280])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("tn,K,td", POLICY_SHAPES + ODD_TILES)
def test_grouped_grid_bf16_matches_plain_at_the_policy_shapes(dev, tn, K, td, math_, T):
    E, n_r, n_c = 4, 8, 2
    g = torch.Generator(device=dev).manual_seed(tn * 100 + K * 10 + T + 7)
    x, mp, C = _variant_operands(g, dev, (E,), T, n_r, n_c, tn, K, td, torch.bfloat16,
                                 torch.bfloat16)
    tc_before = bl.bitlinear_grouped.tensor_core_launches
    yk = bl.bitlinear_grouped(x, mp, C, mode="grid", math=math_)
    torch.cuda.synchronize()
    assert bl.bitlinear_grouped.tensor_core_launches == tc_before + _on_tensor_cores(
        "grid", T, tn, K, td, torch.bfloat16, torch.bfloat16)
    _assert_variant(yk, ref.bitlinear_grouped_ref(x, mp, C, math_), torch.bfloat16,
                    torch.bfloat16)


@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("tn,K,td", POLICY_SHAPES + ODD_TILES)
def test_grid_ignores_nan_bytes_past_the_last_c_row(dev, tn, K, td, math_):
    """C padded from K to the mma's 4 or 8 rows (and a ragged last group of r
    tiles) must be zero-filled, not read: C sits at the start of a buffer
    whose bytes past it are NaN, and y must stay finite."""
    n_r, n_c, T = 3, 2, 33
    n = n_r * n_c * K * td
    buf = torch.full((n + 16 * td,), float("nan"), device=dev, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(12)
    x, mp, C0 = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, torch.bfloat16,
                                  torch.bfloat16)
    C = buf[:n].view(n_r, n_c, K, td)
    C.copy_(C0)
    yk = bl.bitlinear(x, mp, C, mode="grid", math=math_)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(yk).all())
    _assert_variant(yk, ref.bitlinear_ref(x, mp, C, math_), torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("T", [17, 64])
@pytest.mark.parametrize("math_", ["unpack", "bitplane"])
@pytest.mark.parametrize("tn,K,td", POLICY_SHAPES + ODD_TILES)
def test_grid_nan_c_tiles_stay_in_their_own_columns(dev, tn, K, td, math_, T):
    """At odd td the bytes past a C tile's rows are the next tile's, and a
    raw copy of a row's chunk reads some of them: every odd column tile's C
    is NaN here (and the bytes past C), and the even tiles' y columns must
    still be finite and right, the odd tiles' all NaN, in K3 and K4."""
    n_r, n_c, E = 5, 5, 2
    g = torch.Generator(device=dev).manual_seed(14)
    for lead, fn, plain in (((), bl.bitlinear, ref.bitlinear_ref),
                            ((E,), bl.bitlinear_grouped, ref.bitlinear_grouped_ref)):
        x, mp, C0 = _variant_operands(g, dev, lead, T, n_r, n_c, tn, K, td, torch.bfloat16,
                                      torch.bfloat16)
        buf = torch.full((C0.numel() + 16 * td,), float("nan"), device=dev,
                         dtype=torch.bfloat16)
        C = buf[:C0.numel()].view(C0.shape)
        C.copy_(C0)
        C[..., 1::2, :, :] = float("nan")
        tc_before = fn.tensor_core_launches
        yk = fn(x, mp, C, mode="grid", math=math_)
        torch.cuda.synchronize()
        assert fn.tensor_core_launches == tc_before + 1
        cols = torch.arange(n_c * td, device=dev) // td % 2 == 0
        assert bool(torch.isfinite(yk[..., cols]).all())
        assert bool(torch.isnan(yk[..., ~cols]).all())
        C0[..., 1::2, :, :] = 0
        _assert_variant(yk[..., cols].contiguous(), plain(x, mp, C0, math_)[..., cols].contiguous(),
                        torch.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("T", [17, 64])
@pytest.mark.parametrize("tn,K,td", POLICY_SHAPES + ODD_TILES)
def test_grid_writes_every_column_of_y_and_nothing_else(dev, tn, K, td, T):
    """y handed to the library as a view 4 bytes into a NaN-filled buffer
    (4-byte aligned, as the tensor-core body needs, not 16; at odd td and
    odd n_c every other row and column tile starts 2 bytes off a 4-byte
    boundary): every column of every tile, for E = 2 experts, holds what
    the wrapper's own launch gives, bit for bit, and no byte around y is
    written (a tile's padded columns are its neighbour's, or past y).  A y
    2 bytes into the buffer is refused, nothing launched."""
    E, n_r, n_c = 2, 4, 5
    g = torch.Generator(device=dev).manual_seed(15)
    x, mp, C = _variant_operands(g, dev, (E,), T, n_r, n_c, tn, K, td, torch.bfloat16,
                                 torch.bfloat16)
    want = bl.bitlinear_grouped(x, mp, C, mode="grid")
    n = E * T * n_c * td
    buf = torch.full((n + 64,), float("nan"), device=dev, dtype=torch.bfloat16)

    def launch(y):
        ran = ctypes.c_int(-1)
        err = bl._lib("grid")(x.data_ptr(), mp.data_ptr(), C.data_ptr(), y.data_ptr(), E, T,
                              n_r, n_c, tn, 1, K, td, 1, 1, 0, 64, 1,
                              bl.device_smem_budget(dev), bl.SMALL_T,
                              torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(ran))
        torch.cuda.synchronize()
        return err, ran.value

    y = buf[2:2 + n]
    assert launch(y) == (0, 1)
    assert torch.equal(y.view(E, T, n_c * td), want)
    assert bool(torch.isnan(buf[:2]).all()) and bool(torch.isnan(buf[2 + n:]).all())
    assert launch(buf[1:1 + n]) == (716, 0)     # cudaErrorMisalignedAddress


@pytest.mark.parametrize("tn,K,td", POLICY_SHAPES)
def test_grid_takes_unaligned_views_onto_the_tensor_cores(dev, tn, K, td):
    """x, M and C views that start 2 bytes into their buffers are cloned by
    the wrapper, so the call still runs the tensor-core body; the library
    itself refuses such pointers for that body."""
    n_r, n_c, T = 5, 3, 33
    g = torch.Generator(device=dev).manual_seed(13)
    x0, mp0, C0 = _variant_operands(g, dev, (), T, n_r, n_c, tn, K, td, torch.bfloat16,
                                    torch.bfloat16)

    def shifted(t):
        buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=dev)
        view = buf[16 // t.element_size() - 1:][:t.numel()].view(t.shape)
        view.copy_(t)
        return view

    x, mp, C = shifted(x0), shifted(mp0), shifted(C0)
    assert x.data_ptr() % 16 and mp.data_ptr() % 4 and C.data_ptr() % 16
    tc_before = bl.bitlinear.tensor_core_launches
    yk = bl.bitlinear(x, mp, C, mode="grid")
    torch.cuda.synchronize()
    assert bl.bitlinear.tensor_core_launches == tc_before + 1
    _assert_variant(yk, ref.bitlinear_ref(x0, mp0, C0), torch.bfloat16, torch.bfloat16)
    y = torch.empty(T, n_c * td, dtype=torch.bfloat16, device=dev)
    ran = ctypes.c_int(-1)
    err = bl._lib("grid")(x.data_ptr(), mp0.data_ptr(), C0.data_ptr(), y.data_ptr(), 1, T, n_r,
                          n_c, tn, 1, K, td, 1, 1, 0, 64, 1, bl.device_smem_budget(dev),
                          bl.SMALL_T, torch.cuda.current_stream(dev).cuda_stream,
                          ctypes.byref(ran))
    assert err == 716 and ran.value == 0     # cudaErrorMisalignedAddress, nothing launched


@pytest.mark.parametrize("method", ["greedy", "alternating"])
def test_pooled_solve_bytes_do_not_depend_on_the_chunk(dev, method, tmp_path):
    """A greedy/alternating pool of 24,576 tiles of 32 x 131 (one zamba2
    in_proj stack, bf16) gives the same bytes in chunks of at most 16,384
    (execute's ``EIGH_MAX_BATCH``), 8,004 (the stream chunk at 1 GiB) and
    1,000 tiles, and streamed at the default budget: batched eigh and the
    batched products give each tile the same bits whatever its batch."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.compression import TreeLeafSource, execute_streaming
    from repro_torch.compression.plan import tree_paths

    g = torch.Generator(device=dev).manual_seed(5)
    values = {"l": {"w": (0.02 * torch.randn((6, 2048, 8384), generator=g, device=dev))
                    .to(torch.bfloat16)}}
    plan = plan_compression(values, CompressionPolicy(method=method))
    (t,) = plan.tensors
    assert (t.tile_n, t.tile_d, t.num_tiles) == (32, 131, 24576)
    outs = {}
    for cap in (16384, 8004, 1000):
        cv, art = execute_plan(plan, values, device=dev, max_pool_tiles=cap)
        assert max(art.manifest["pools"][0]["chunk_sizes"]) <= cap
        outs[cap] = {k: checkpointer.to_numpy(v).tobytes()
                     for k, v in tree_paths(cv["l"]["w"])}
    art, stats = execute_streaming(TreeLeafSource(values), plan, str(tmp_path), device=dev)
    assert art.manifest["tensors"]["l/w"]["stream"]["chunk"] == 8004
    streamed = {}
    for k in ("m_packed", "C"):
        name = f"params/l/w/{k}"
        e = checkpointer.leaf_entries(str(tmp_path), 0)[name]
        streamed[k] = checkpointer.read_leaf_slice(
            str(tmp_path), 0, name, tuple(slice(0, s) for s in e["shape"]), entry=e).tobytes()
    assert outs[8004] == outs[16384] and outs[1000] == outs[16384]
    assert streamed == outs[16384]


def test_flash_attention_refuses_under_autograd_on_the_card(dev):
    """K5 has no backward: on the card its output would carry no gradient,
    so the wrapper and the model-layout adapter raise while autograd records
    through q/k/v, and launch nothing; without grad they run."""
    g = torch.Generator(device=dev).manual_seed(3)
    qh = torch.randn(1, 64, 2, 2, 64, generator=g, device=dev).requires_grad_(True)
    k = torch.randn(1, 64, 2, 64, generator=g, device=dev)
    v = torch.randn(1, 64, 2, 64, generator=g, device=dev)
    before = fa.flash_attention.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_model_layout(qh, k, v, 0)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(qh.reshape(1, 64, 4, 64).transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2))
    assert fa.flash_attention.launches == before
    with torch.no_grad():
        o = ops.flash_attention_model_layout(qh, k, v, 0)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1 and o.grad_fn is None


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One AdamW step of reduced granite-moe (f32, 2 microbatches, remat)
    on the card and on the CPU from the same state and batch, with the
    kernel hooks registered (the step clears them): the loss and the
    gradient norm within 1e-5 relative (f32, other summation orders), and
    every parameter within 2 lr + 1e-6 of the CPU's: Adam's first step moves
    an element by lr times the sign of its gradient, so a near-zero
    gradient that the two devices round to opposite signs is the largest
    difference one step can make; the mean difference within 1e-3 lr."""
    from repro_torch.compression.plan import tree_paths
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import TrainState, init_train_state, make_train_step

    cfg = reduced_for_smoke(get_config("granite-moe-1b-a400m"))
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), microbatches=2)
    lr = 1e-3
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(lr, 0, 4))
    cpu = init_train_state(0, cfg, pcfg, device="cpu")
    card = TrainState(cpu.step.to(dev), _to_dev(cpu.params, dev), _to_dev(cpu.opt, dev))
    shape = ShapeConfig("s", "train", 64, 4)
    batch = make_pipeline(cfg, shape, device="cpu").batch_at(0)
    ops.enable_kernels()
    try:
        card, mc = step_fn(card, {k: v.to(dev) for k, v in batch.items()})
    finally:
        ops.disable_kernels()
    cpu, mp = step_fn(cpu, batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(mc[key]) - float(mp[key])) <= 1e-5 * abs(float(mp[key])), key
    assert int(card.step) == int(cpu.step) == 1
    diffs = []
    for (p, a), (_, b) in zip(tree_paths(card.params), tree_paths(cpu.params)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, p
        diffs.append(d.flatten())
    assert float(torch.cat(diffs).mean()) <= 1e-3 * lr


def _to_dev(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_dev(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _one_rank_mesh(rank, world):
    """On a one-rank NCCL group: reduced granite-moe trained 2 steps on the
    (1, 1) mesh and unsharded, from the same seed and batches."""
    from repro_torch.compression.plan import tree_paths
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import init_train_state, make_train_step

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 1), ("data", "model"))
    cfg = reduced_for_smoke(get_config("granite-moe-1b-a400m"))
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), microbatches=2)
    shape = ShapeConfig("s", "train", 64, 4)
    out = {}
    for name, kw in (("mesh", {"mesh": mesh}), ("plain", {"device": "cuda"})):
        state = init_train_state(0, cfg, pcfg, **kw)
        step_fn = make_train_step(cfg, pcfg, warmup_cosine(1e-3, 1, 4))
        pipe = make_pipeline(cfg, shape, kw.get("mesh"), device=kw.get("device"))
        metrics = []
        for i in range(2):
            state, m = step_fn(state, pipe.batch_at(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = (metrics, {p: shd.full_value(x).cpu() for p, x in tree_paths(state)},
                     shd.is_dtensor(state.step))
    return out


def test_one_rank_nccl_mesh_gives_the_unsharded_result(dev, tmp_path):
    """The sharded train step on the card's (1, 1) mesh (every collective
    skipped) gives the unsharded step's losses, grad norms and state bit
    for bit."""
    from repro_torch.distributed.local_ranks import run_ranks

    (got,) = run_ranks(_one_rank_mesh, 1, str(tmp_path), backend="nccl")
    (m_metrics, m_state, m_sharded), (p_metrics, p_state, p_sharded) = got["mesh"], got["plain"]
    assert m_sharded and not p_sharded
    assert m_metrics == p_metrics
    assert sorted(m_state) == sorted(p_state)
    for p, x in p_state.items():
        assert torch.equal(m_state[p], x), p


def test_launcher_refuses_two_ranks_on_one_gpu(dev, tmp_path):
    """``torch.distributed.run --nproc-per-node 2`` on a host with one GPU
    is refused by name before any process group forms."""
    import os
    import subprocess
    import sys

    if torch.cuda.device_count() != 1:
        pytest.skip("needs a host with exactly one GPU")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", "--arch", "granite-moe-1b-a400m", "--reduced",
         "--mesh", "1x2", "--steps", "1", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert r.returncode != 0
    assert "--mesh 1x2: 2 ranks on this host but only 1 GPU(s)" in r.stderr


# kernels/ops.py's direct entry points: each launches its kernel on CUDA
# tensors and agrees with its plain version (annealers bit for bit on dyadic
# problems; K3/K4 in bf16 within 2e-2 of max|y|; K5 as the K5 checks)
@pytest.mark.parametrize("name", ["bitlinear", "bitlinear_grouped", "flash_attention",
                                  "sa_sweep", "sa_sweep_many", "sq_sweep_many",
                                  "sqa_sweep_many"])
def test_entry_point_launches_and_matches_plain(dev, name):
    g = torch.Generator(device=dev).manual_seed(27)
    rng = np.random.default_rng(27)
    if name in ("bitlinear", "bitlinear_grouped"):
        lead = (3,) if name == "bitlinear_grouped" else ()
        mp = torch.randint(0, 16, (*lead, 4, 2, 32, 1), generator=g, device=dev,
                           dtype=torch.int32).to(torch.uint8)
        C = (0.05 * torch.randn((*lead, 4, 2, 4, 128), generator=g, device=dev)).bfloat16()
        x = torch.randn((*lead, 5, 128), generator=g, device=dev).bfloat16()
        fn, plain = ((ops.bitlinear, ref.bitlinear_ref) if not lead
                     else (ops.bitlinear_grouped, ref.bitlinear_grouped_ref))
        before = (bl.bitlinear if not lead else bl.bitlinear_grouped).launches
        y, yp = fn(x, mp, C), plain(x, mp, C, "unpack")
        assert (bl.bitlinear if not lead else bl.bitlinear_grouped).launches == before + 1
        assert float((y.float() - yp.float()).abs().max()) <= 2e-2 * float(yp.float().abs().max())
        return
    if name == "flash_attention":
        q = torch.randn((2, 8, 96, 64), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((2, 2, 96, 64), generator=g, device=dev).bfloat16() for _ in "kv")
        before = fa.flash_attention.launches
        o, r = ops.flash_attention(q, k, v, 32), ref.flash_attention_ref(q, k, v, 32)
        assert fa.flash_attention.launches == before + 1
        assert bool(((o.float() - r.float()).abs() <= 5e-2 + 5e-2 * r.float().abs()).all())
        return
    P, C_, S, n = 4, 3, 6, 24
    h, B = _dyadic_problems(rng, P, n)
    x0 = np.where(rng.random((P, C_, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C_, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(8.0, 0.05, S, dtype=np.float32), (P, S)).copy()
    h, B, x0, u, temps = (torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps))
    if name == "sqa_sweep_many":
        T = 4
        X0 = torch.where(torch.rand((P, C_, T, n), generator=g, device=dev) < 0.5, -1.0, 1.0)
        uq = torch.rand((P, C_, S, T, n), generator=g, device=dev)
        jp = torch.linspace(0.1, 2.0, S, device=dev)
        before = sqa.sqa_sweep_many.launches
        got = ops.sqa_sweep_many(h, B, X0, uq, jp, 0.05)
        assert sqa.sqa_sweep_many.launches == before + 1
        want = ref.sqa_sweep_many_ref(h, B, X0, uq, jp, 0.05)
    else:
        before = sa.sa_sweep_many.launches
        if name == "sa_sweep":
            got = ops.sa_sweep(h[0], B[0], x0[0], u[0], temps[0])
            want = tuple(t[0] for t in ref.sa_sweep_many_ref(h[:1], B[:1], x0[:1], u[:1],
                                                             temps[:1]))
        elif name == "sa_sweep_many":
            got, want = (ops.sa_sweep_many(h, B, x0, u, temps),
                         ref.sa_sweep_many_ref(h, B, x0, u, temps))
        else:
            got = ops.sq_sweep_many(h, B, x0, u, 0.1)
            want = ref.sa_sweep_many_ref(h, B, x0, u, torch.full_like(temps, 0.1))
        assert sa.sa_sweep_many.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# the zoo's prefill shapes (chip_smoke.py phase 14a): command-r-plus's GQA
# group of 12 (96 q heads over 8 kv heads of 128), musicgen-medium's MHA 24 x
# 64 and internvl2-2b's GQA 16/8 x 128, at a shorter S
@pytest.mark.parametrize("B,H,KV,S,hd", [(1, 96, 8, 256, 128), (2, 96, 8, 65, 128),
                                         (2, 24, 24, 256, 64), (1, 16, 8, 129, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_zoo_shapes(dev, B, H, KV, S, hd, dtype):
    g = torch.Generator(device=dev).manual_seed(H * 1_000 + S)
    q = torch.randn(B, H, S, hd, generator=g, device=dev).to(dtype)
    k = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
    v = torch.randn(B, KV, S, hd, generator=g, device=dev).to(dtype)
    before = fa.flash_attention.launches
    o = fa.flash_attention(q, k, v, 0)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    r = ref.flash_attention_ref(q, k, v, 0)
    tol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(o.float(), r.float(), rtol=tol, atol=tol)
    if dtype == torch.bfloat16:
        # the tensor-core body against f32 scores, within its rounding bound
        o32, pv_abs = _f32_score_attention(q, k, v, 0)
        bound = 2.0 ** -8 * (o32.abs() + 2.0 * pv_abs) + 2e-5
        assert bool(((o.float() - o32).abs() <= bound).all())
    # each q head reads its own kv head: head h of group g = h // (H // KV)
    rep = H // KV
    for h in (0, rep - 1, rep, H - 1):
        one = ref.flash_attention_ref(q[:, h:h + 1], k[:, h // rep:h // rep + 1],
                                      v[:, h // rep:h // rep + 1], 0)
        torch.testing.assert_close(o[:, h:h + 1].float(), one.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("C,S,n", [(10, 64, 24), (8, 6, 238)])
def test_sa_sweep_single_problem_is_row_zero_of_the_batch(dev, C, S, n):
    """The single-problem wrapper launches K1 on one problem: bit for bit
    what ``sa_sweep_many`` gives that problem as row 0 of a batch."""
    rng = np.random.default_rng(C * n)
    h, B = _dyadic_problems(rng, 3, n)
    x0 = np.where(rng.random((3, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((3, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(8.0, 0.05, S, dtype=np.float32), (3, S)).copy()
    args = [torch.from_numpy(a).to(dev) for a in (h, B, x0, u, temps)]
    before = sa.sa_sweep_many.launches
    x1, e1 = sa.sa_sweep(*(a[0] for a in args))
    torch.cuda.synchronize()
    assert sa.sa_sweep_many.launches == before + 1
    xm, em = sa.sa_sweep_many(*args)
    assert x1.shape == (C, n) and e1.shape == (C,)
    assert torch.equal(x1, xm[0]) and torch.equal(e1, em[0])
    xr, er = ref.sa_sweep_ref(*(a[0] for a in args))
    assert torch.equal(x1, xr) and torch.equal(e1, er)
