"""The port's decomposition core against the JAX package's, same inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import decomposition as jdec
from repro_torch.core import decomposition as tdec

torch.set_num_threads(1)


def _tiles(seed, T, N, D):
    return np.random.default_rng(seed).standard_normal((T, N, D)).astype(np.float32)


def _signs(seed, shape):
    return np.where(np.random.default_rng(seed).random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("N,K", [(8, 3), (5, 8), (16, 9), (7, 17)])
def test_pack_unpack_identical_bytes(N, K):
    M = _signs(N * K, (N, K))
    pj = np.asarray(jdec.pack_bits(jnp.asarray(M)))
    pt = tdec.pack_bits(torch.from_numpy(M)).numpy()
    assert pt.dtype == np.uint8 and pt.tobytes() == pj.tobytes()
    np.testing.assert_array_equal(tdec.unpack_bits(torch.from_numpy(pt), K).numpy(), M)
    np.testing.assert_array_equal(
        tdec.unpack_bits(torch.from_numpy(pt), K).numpy(),
        np.asarray(jdec.unpack_bits(jnp.asarray(pj), K)),
    )


def test_sign_enumeration_identical():
    for K in (1, 3, 5):
        np.testing.assert_array_equal(
            tdec.sign_enumeration(K).numpy(), np.asarray(jdec.sign_enumeration(K))
        )


def test_least_squares_and_objective_match():
    W = _tiles(0, 6, 16, 24)
    M = _signs(1, (6, 16, 4))
    M[0, :, 3] = M[0, :, 0]          # dependent columns: pseudo-inverse path
    Wt, Mt = torch.from_numpy(W), torch.from_numpy(M)
    C_t = tdec.least_squares_C(Mt, Wt).numpy()
    obj_t = tdec.objective(Mt, Wt).numpy()
    objx_t = tdec.objective_from_x(Mt.reshape(6, -1), Wt, 4).numpy()
    for i in range(6):
        Wj, Mj = jnp.asarray(W[i]), jnp.asarray(M[i])
        np.testing.assert_allclose(C_t[i], np.asarray(jdec.least_squares_C(Mj, Wj)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(obj_t[i], float(jdec.objective(Mj, Wj)), rtol=1e-5)
        np.testing.assert_allclose(
            objx_t[i], float(jdec.objective_from_x(Mj.reshape(-1), Wj, 4)), rtol=1e-5
        )


def _jax_restart_signs(key, K, restarts, N):
    """The restart signs repro's greedy draws inside (decomposition.py:143)."""
    return np.stack([
        np.asarray(jnp.sign(jax.random.normal(
            jax.random.fold_in(jax.random.fold_in(key, k), 17), (restarts, N)
        )))
        for k in range(K)
    ])


@pytest.mark.parametrize("N,D,K", [(8, 32, 3), (16, 24, 4)])
def test_greedy_with_injected_restarts_identical(N, D, K):
    W = _tiles(N + K, 4, N, D)
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    signs = np.stack([_jax_restart_signs(k, K, 4, N) for k in keys])
    res = tdec.greedy_decompose_from(torch.from_numpy(W), K, torch.from_numpy(signs))
    for i in range(4):
        ref = jdec.greedy_decompose(jnp.asarray(W[i]), K, keys[i])
        np.testing.assert_array_equal(res.M[i].numpy(), np.asarray(ref.M))
        np.testing.assert_allclose(res.C[i].numpy(), np.asarray(ref.C), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(res.cost_refit[i]), float(ref.cost_refit), rtol=1e-5)


@pytest.mark.parametrize("N,D,K", [(8, 32, 3), (16, 64, 4)])
def test_alternating_from_M0_identical(N, D, K):
    W = _tiles(7 * K, 5, N, D)
    M0 = _signs(K, (5, N, K))
    M, C, obj = tdec.alternating_decompose(torch.from_numpy(W), K, M0=torch.from_numpy(M0))
    for i in range(5):
        Mj, Cj, oj = jdec.alternating_decompose(jnp.asarray(W[i]), K, M0=jnp.asarray(M0[i]))
        np.testing.assert_array_equal(M[i].numpy(), np.asarray(Mj))
        np.testing.assert_allclose(C[i].numpy(), np.asarray(Cj), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(obj[i]), float(oj), rtol=1e-5)


def test_greedy_outer_form_draws_from_generator():
    W = torch.from_numpy(_tiles(2, 3, 8, 16))
    a = tdec.greedy_decompose(W, 3, torch.Generator().manual_seed(5))
    b = tdec.greedy_decompose(W, 3, torch.Generator().manual_seed(5))
    assert torch.equal(a.M, b.M)
    assert set(torch.unique(a.M).tolist()) <= {-1.0, 1.0}
    # refit never worse than the greedy C
    assert bool((a.cost_refit <= a.cost * (1 + 1e-5)).all())


@pytest.mark.parametrize("method", ["greedy", "alternating"])
@pytest.mark.parametrize("warm", [False, True])
def test_compress_tile_batch_with_jax_draws_identical(method, warm):
    from repro.core import compress as jcomp
    from repro_torch.core import compress as tcomp

    T, tn, td, K = 6, 16, 32, 4
    tiles = _tiles(11, T, tn, td)
    keys = jax.random.split(jax.random.PRNGKey(5), T)
    signs = np.stack([_jax_restart_signs(k, K, 4, tn) for k in keys])
    M0 = _signs(12, (T, tn, K)) if warm else None
    Mj, Cj, ej = jcomp.compress_tile_batch(
        jnp.asarray(tiles), keys, jax.random.PRNGKey(0), K, method,
        M0=None if M0 is None else jnp.asarray(M0),
    )
    Mt, Ct, et = tcomp.compress_tile_batch(
        torch.from_numpy(tiles), torch.from_numpy(signs), K, method,
        M0=None if M0 is None else torch.from_numpy(M0),
    )
    np.testing.assert_array_equal(Mt.numpy(), np.asarray(Mj))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), rtol=1e-5)


def test_int8_tile_scales_and_codes_equal_the_jitted_reference():
    """``quantize_tile_batch`` is jitted in JAX, where XLA turns
    ``amax / 127`` into ``amax * f32(1/127)``: the port's scales and codes
    equal it bit for bit, and a true division differs on this batch."""
    from repro.core import compress as jcomp
    from repro_torch.core import compress as tcomp

    tiles = (0.02 * np.random.default_rng(0).standard_normal((2000, 32, 128))).astype(np.float32)
    qj, sj, ej = (np.asarray(a) for a in jcomp.quantize_tile_batch(jnp.asarray(tiles)))
    qt, st, et = (a.numpy() for a in tcomp.quantize_tile_batch(torch.from_numpy(tiles)))
    assert qt.dtype == qj.dtype == np.int8 and st.dtype == sj.dtype == np.float32
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_allclose(et, ej, rtol=1e-5)
    divided = torch.from_numpy(tiles).abs().amax(dim=(1, 2), keepdim=True) / 127.0
    assert int((divided.numpy() != sj).sum()) > 0


def test_compress_matrix_and_int8_quantize_match_jax():
    from repro.configs.base import CompressionConfig as JCfg
    from repro.core import compress as jcomp
    from repro_torch.configs.base import CompressionConfig as TCfg
    from repro_torch.core import compress as tcomp

    W = np.random.default_rng(8).standard_normal((64, 96)).astype(np.float32)
    kw = dict(tile_n=16, tile_d=32, rank_ratio=0.25, min_size=1024)
    wj, ej = jcomp.compress_matrix(jnp.asarray(W), JCfg(**kw), jax.random.PRNGKey(0))
    wt, et = tcomp.compress_matrix(torch.from_numpy(W), TCfg(**kw), seed=0)
    assert wt["m_packed"].shape == wj["m_packed"].shape and wt["C"].shape == wj["C"].shape
    assert abs(et - ej) <= 0.05 * ej
    tiles = tcomp.tile_matrix(torch.from_numpy(W), 16, 32)
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jcomp.tile_matrix(jnp.asarray(W), 16, 32)))
    qt, st, rt = tcomp.quantize_tile_batch(tiles)
    qj, sj, rj = jcomp.quantize_tile_batch(jnp.asarray(tiles.numpy()))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5)
    for dim, want, cap in ((100, 32, None), (151936, 128, None), (5120, 8, 16), (1018, 32, None)):
        assert tcomp.pick_tile(dim, want, cap) == jcomp.pick_tile(dim, want, cap)
