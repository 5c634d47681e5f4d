"""``kernels/ops.py``'s direct entry points against ``repro.kernels.ops``'s on
the same numpy inputs (CPU: each takes its kernel's plain version; JAX's
run their Pallas kernels in interpret mode).  The annealers bit-identical on
dyadic problems and pre-drawn uniforms; bitlinear and flash attention
within the tolerances of tests/test_torch_bitlinear.py and
tests/test_torch_flash_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import decomposition as tdec
from repro_torch.core import ising as tising
from repro_torch.kernels import bitlinear as tbl
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.kernels import sa_sweep as tsa
from repro_torch.kernels import sqa_sweep as tsqa

torch.set_num_threads(1)

TOL = {"float32": 1e-5, "bfloat16": 5e-2}           # tests/test_torch_bitlinear.py
ATTN_TOL = {"float32": 2e-5, "bfloat16": 5e-2}      # tests/test_torch_flash_attention.py


def _dyadic(rng, P, n):
    h = rng.integers(-256, 257, (P, n)) / 64.0
    B = np.triu(rng.integers(-256, 257, (P, n, n)) / 64.0, 1)
    return h.astype(np.float32), (B + np.swapaxes(B, 1, 2)).astype(np.float32)


def _pair(a, dtype):
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))


def _close(t, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), rtol=tol, atol=tol)


def _packed(rng, lead, nr, nc, tn, K):
    M = np.where(rng.random(lead + (nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    return tdec.pack_bits(torch.from_numpy(M)).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["auto", "grid", "decode"])
def test_bitlinear_matches_jax(mode, dtype):
    rng = np.random.default_rng(1)
    T, nr, nc, tn, K, td = 5, 2, 3, 16, 4, 32
    mp = _packed(rng, (), nr, nc, tn, K)
    (xj, xt) = _pair(rng.standard_normal((T, nr * tn)), dtype)
    (Cj, Ct) = _pair(rng.standard_normal((nr, nc, K, td)) * 0.2, dtype)
    yj = jops.bitlinear(xj, jnp.asarray(mp), Cj, block_t=8, interpret=True, mode=mode)
    yt = ops.bitlinear(xt, torch.from_numpy(mp), Ct, block_t=8, mode=mode)
    _close(yt, yj, TOL[dtype])
    assert tbl.bitlinear.launches == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bitlinear_grouped_matches_jax(dtype):
    rng = np.random.default_rng(2)
    E, T, nr, nc, tn, K, td = 3, 4, 2, 2, 16, 9, 32
    mp = _packed(rng, (E,), nr, nc, tn, K)
    (xj, xt) = _pair(rng.standard_normal((E, T, nr * tn)), dtype)
    (Cj, Ct) = _pair(rng.standard_normal((E, nr, nc, K, td)) * 0.2, dtype)
    yj = jops.bitlinear_grouped(xj, jnp.asarray(mp), Cj, block_t=8, interpret=True)
    _close(ops.bitlinear_grouped(xt, torch.from_numpy(mp), Ct, block_t=8), yj, TOL[dtype])
    assert tbl.bitlinear_grouped.launches == 0


def test_vmem_budget_is_the_shared_memory_budget(monkeypatch):
    """``vmem_budget`` reaches the kernels as their ``smem_budget``, the
    budget of ``default_schedule`` and of the launch."""
    seen = []
    for name in ("_bitlinear", "_bitlinear_grouped"):
        monkeypatch.setattr(ops, name, lambda *a, **kw: seen.append(kw["smem_budget"]))
    ops.bitlinear(None, None, None, vmem_budget=1 << 16)
    ops.bitlinear_grouped(None, None, None, vmem_budget=1 << 15)
    assert seen == [1 << 16, 1 << 15]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("win", [0, 24])
def test_flash_attention_matches_jax(win, dtype):
    rng = np.random.default_rng(4)
    B, H, KV, S, hd = 2, 4, 2, 64, 32
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng.standard_normal(s), dtype) for s in
                                    ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    oj = jops.flash_attention(qj, kj, vj, window=win, interpret=True, block_q=32, block_k=32)
    _close(ops.flash_attention(qt, kt, vt, window=win), oj, ATTN_TOL[dtype])
    assert tfa.flash_attention.launches == 0


def _anneal_inputs(seed, P, C, S, n):
    rng = np.random.default_rng(seed)
    h, B = _dyadic(rng, P, n)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(6.0, 0.05, S, dtype=np.float32), (P, S)).copy()
    return h, B, x0, u, temps


def _same(t, j):
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sa_sweep_many_identical_to_jax():
    args = _anneal_inputs(5, 3, 2, 5, 12)
    _same(ops.sa_sweep_many(*map(torch.from_numpy, args)),
          jops.sa_sweep_many(*map(jnp.asarray, args), interpret=True))
    assert tsa.sa_sweep_many.launches == 0


def test_sa_sweep_one_problem_identical_to_jax():
    h, B, x0, u, temps = (a[0] for a in _anneal_inputs(6, 2, 3, 4, 10))
    _same(ops.sa_sweep(*map(torch.from_numpy, (h, B, x0, u, temps))),
          jops.sa_sweep(*map(jnp.asarray, (h, B, x0, u, temps)), interpret=True))


def test_sq_sweep_many_identical_to_jax():
    h, B, x0, u, _ = _anneal_inputs(7, 3, 4, 5, 12)
    _same(ops.sq_sweep_many(*map(torch.from_numpy, (h, B, x0, u)), temperature=0.1),
          jops.sq_sweep_many(*map(jnp.asarray, (h, B, x0, u)), temperature=0.1,
                             interpret=True))


def test_sqa_sweep_many_identical_to_jax():
    rng = np.random.default_rng(8)
    P, C, T, S, n = 2, 3, 4, 5, 10
    h, B = _dyadic(rng, P, n)
    X0 = np.where(rng.random((P, C, T, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, T, n), dtype=np.float32)
    jp = tising.sqa_jperps(S, T, 0.05, 3.0, torch.device("cpu")).numpy().astype(np.float32)
    _same(ops.sqa_sweep_many(*map(torch.from_numpy, (h, B, X0, u, jp)), temperature=0.05),
          jops.sqa_sweep_many(*map(jnp.asarray, (h, B, X0, u, jp)), temperature=0.05,
                              interpret=True))
    assert tsqa.sqa_sweep_many.launches == 0


def test_entry_points_cast_to_float32():
    """As the reference's entry points cast their inputs to float32."""
    args = _anneal_inputs(9, 2, 2, 3, 8)
    f64 = [torch.from_numpy(a).double() for a in args]
    _same(ops.sa_sweep_many(*f64), ops.sa_sweep_many(*map(torch.from_numpy, args)))
