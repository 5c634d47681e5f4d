"""The port's compressed layer (bitlinear plain version, fused hook and its
gradient) against the JAX package's kernel, oracle and custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantized as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import decomposition as tdec
from repro_torch.core import quantized as tq
from repro_torch.kernels import bitlinear as tbl
from repro_torch.kernels import ops as tops

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_port_hooks():
    yield
    tops.disable_kernels()


def _weights(seed, nr, nc, tn, K, td):
    rng = np.random.default_rng(seed)
    M = np.where(rng.random((nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    mp = tdec.pack_bits(torch.from_numpy(M)).numpy()
    C = (rng.standard_normal((nr, nc, K, td)) * 0.2).astype(np.float32)
    return mp, C


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("T,nr,nc,tn,K,td", [
    (1, 2, 3, 8, 3, 32),       # decode, paper-scale tile (tn=8, K=3)
    (13, 2, 2, 16, 4, 64),     # ragged T
    (20, 3, 2, 16, 9, 32),     # K > 8: two packed bytes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bitlinear_matches_jax_kernel_and_ref(T, nr, nc, tn, K, td, dtype):
    mp, C = _weights(T * K, nr, nc, tn, K, td)
    x = np.random.default_rng(T).standard_normal((T, nr * tn)).astype(np.float32)
    jd, td_ = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    # inputs rounded once to the working dtype, identical on both sides
    xj, Cj = _to_jax(x, jd), _to_jax(C, jd)
    xt = _to_torch(np.asarray(xj, np.float32), td_)
    Ct = _to_torch(np.asarray(Cj, np.float32), td_)
    yt = tbl.bitlinear(xt, torch.from_numpy(mp), Ct)
    assert yt.dtype == td_ and tuple(yt.shape) == (T, nc * td)
    yt = yt.float().numpy()
    refs = [jref.bitlinear_ref(xj, jnp.asarray(mp), Cj)] + [
        jops.bitlinear(xj, jnp.asarray(mp), Cj, block_t=8, interpret=True, mode=m)
        for m in ("grid", "decode")
    ]
    for yj in refs:
        yj = np.asarray(yj, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(yt - yj).max() <= 2e-2 * np.abs(yj).max()
    assert tbl.bitlinear.launches == 0


def test_apply_compressed_einsum_and_decompress_match_jax():
    mp, C = _weights(3, 2, 2, 16, 4, 32)
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(np.float32)
    wj = {"m_packed": jnp.asarray(mp), "C": jnp.asarray(C)}
    wt = {"m_packed": torch.from_numpy(mp), "C": torch.from_numpy(C)}
    np.testing.assert_allclose(
        tq.apply_compressed(torch.from_numpy(x), wt).numpy(),
        np.asarray(jq.apply_compressed_einsum(jnp.asarray(x), wj)), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(tq.decompress(wt).numpy(), np.asarray(jq.decompress(wj)),
                               rtol=1e-6, atol=1e-6)
    assert tq.compressed_num_bytes(wt) == jq.compressed_num_bytes(wj)
    assert tq.dense_num_bytes(wt) == jq.dense_num_bytes(wj)


def test_fused_gradient_matches_jax_custom_vjp():
    mp, C = _weights(7, 3, 2, 8, 3, 16)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 24)).astype(np.float32)
    g = rng.standard_normal((2, 4, 32)).astype(np.float32)

    jops.enable_kernels(interpret=True)
    try:
        def loss(xx, cc):
            y = jq.apply_compressed(xx, {"m_packed": jnp.asarray(mp), "C": cc})
            return jnp.sum(y * jnp.asarray(g))

        dxj, dCj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(C))
    finally:
        jops.disable_kernels()

    tops.enable_kernels()
    assert tq.has_fused_bitlinear()
    xt = torch.from_numpy(x).requires_grad_()
    Ct = torch.from_numpy(C).requires_grad_()
    y = tq.apply_compressed(xt, {"m_packed": torch.from_numpy(mp), "C": Ct})
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Ct.grad.numpy(), np.asarray(dCj), rtol=1e-4, atol=1e-5)


def test_bitlinear_rejects_what_is_not_ported():
    mp, C = _weights(0, 1, 1, 8, 3, 16)
    with pytest.raises(NotImplementedError, match="int8"):
        tbl.bitlinear(torch.zeros(2, 8, dtype=torch.int8), torch.from_numpy(mp),
                      torch.from_numpy(C))
    with pytest.raises(ValueError, match="inconsistent"):
        tbl.bitlinear(torch.zeros(2, 9), torch.from_numpy(mp), torch.from_numpy(C))
    # the grouped kernel K4 refuses the same, and an expert-count mismatch
    grouped = {"m_packed": torch.zeros(2, 1, 1, 8, 1, dtype=torch.uint8),
               "C": torch.zeros(2, 1, 1, 3, 16)}
    with pytest.raises(NotImplementedError, match="int8"):
        tbl.bitlinear_grouped(torch.zeros(2, 1, 8, dtype=torch.int8), grouped["m_packed"],
                              grouped["C"])
    with pytest.raises(ValueError, match="inconsistent"):
        tbl.bitlinear_grouped(torch.zeros(3, 1, 8), grouped["m_packed"], grouped["C"])
    with pytest.raises(ValueError, match="grouped apply"):
        tq.apply_compressed(torch.zeros(3, 1, 8), grouped)
