"""Annealing, surrogate and BBO of the port against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcomp
from repro.core import ising as jising
from repro.core import surrogate as jsur
from repro.kernels import ref as jref
from repro.kernels.sa_sweep import sa_sweep_many as j_sa_sweep_many
from repro_torch.core import compress as tcomp
from repro_torch.core import decomposition as tdec
from repro_torch.core import ising as tising
from repro_torch.core import surrogate as tsur
from repro_torch.kernels import sa_sweep as tsa

torch.set_num_threads(1)


def _dyadic_problems(rng, P, n):
    """h, B on the grid k/64, |.| <= 4: fields and energies are exact sums
    in float32, so summation order cannot change a bit."""
    h = rng.integers(-256, 257, (P, n)) / 64.0
    B = np.triu(rng.integers(-256, 257, (P, n, n)) / 64.0, 1)
    return h.astype(np.float32), (B + np.swapaxes(B, 1, 2)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("P,C,S,n", [(4, 3, 6, 8), (3, 2, 4, 24)])
def test_plain_sa_identical_to_jax_ref_and_pallas(P, C, S, n):
    rng = np.random.default_rng(P * n)
    h, B = _dyadic_problems(rng, P, n)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, n), dtype=np.float32)
    temps = np.broadcast_to(np.geomspace(6.0, 0.05, S, dtype=np.float32), (P, S)).copy()
    xt, et = tsa.sa_sweep_many(*_t(h, B, x0, u, temps))      # CPU -> plain version
    xr, er = jref.sa_sweep_many_ref(*map(jnp.asarray, (h, B, x0, u, temps)))
    xp, ep = j_sa_sweep_many(*map(jnp.asarray, (h, B, x0, u, temps)), interpret=True)
    for xj, ej in ((xr, er), (xp, ep)):
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    # the wrapper took the plain version: no kernel launch on the CPU
    assert tsa.sa_sweep_many.launches == 0


def test_plain_sq_identical_to_jax_ref():
    rng = np.random.default_rng(5)
    P, C, S, n = 3, 4, 5, 12
    h, B = _dyadic_problems(rng, P, n)
    x0 = np.where(rng.random((P, C, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, n), dtype=np.float32)
    xt, et = tsa.sq_sweep_many(*_t(h, B, x0, u), temperature=0.1)
    xr, er = jref.sq_sweep_many_ref(*map(jnp.asarray, (h, B, x0, u)), temperature=0.1)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xr))
    np.testing.assert_array_equal(et.numpy(), np.asarray(er))


def _jax_solve_draws(key, P, R, S, n):
    """The x0 and uniforms repro's _solve_keys draws (ising.py:171-177)."""
    x0s, us = [], []
    for k in jax.random.split(key, P):
        ka, kb = jax.random.split(k)
        x0s.append(np.asarray(jax.random.rademacher(ka, (R, n), dtype=jnp.float32)))
        us.append(np.asarray(jax.random.uniform(kb, (R, S, n), dtype=jnp.float32)))
    return np.stack(x0s), np.stack(us)


@pytest.mark.parametrize("name", ["sq", "sa"])
@pytest.mark.parametrize("warm", [False, True])
def test_solve_many_from_jax_draws_identical(name, warm):
    rng = np.random.default_rng(11)
    P, R, S, n = 5, 3, 6, 16
    h, B = _dyadic_problems(rng, P, n)
    key = jax.random.PRNGKey(2)
    init = np.where(rng.random((P, n)) < 0.5, -1.0, 1.0).astype(np.float32) if warm else None
    xj, ej = jising.solve_many(
        name, key, jising.IsingProblem(jnp.asarray(h), jnp.asarray(B)),
        num_sweeps=S, num_reads=R, backend="jnp",
        init_state=None if init is None else jnp.asarray(init),
    )
    x0, u = _jax_solve_draws(key, P, R, S, n)
    xt, et = tising.solve_many_from(
        name, tising.IsingProblem(*_t(h, B)), *_t(x0, u),
        init_state=None if init is None else torch.from_numpy(init),
    )
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_solve_many_sqa_not_ported_and_backend_checked():
    prob = tising.IsingProblem(torch.zeros(1, 4), torch.zeros(1, 4, 4))
    with pytest.raises(NotImplementedError, match="K2"):
        tising.solve_many("qa", prob, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        tising.resolve_backend("cuda", torch.device("cpu"))
    assert tising.resolve_backend("auto", torch.device("cpu")) == "torch"


def test_sample_nbocs_with_injected_normal():
    rng = np.random.default_rng(4)
    n, m = 6, 9
    X = np.where(rng.random((m, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    sj = jsur.init_stats(n)
    st = tsur.init_stats(n)
    for i in range(m):
        sj = jsur.update_stats(sj, jnp.asarray(X[i]), jnp.asarray(y[i]))
        st = tsur.update_stats(st, torch.from_numpy(X[i]), torch.tensor(y[i]))
    np.testing.assert_allclose(st.G.numpy(), np.asarray(sj.G), rtol=1e-6)
    key = jax.random.PRNGKey(9)
    alpha_j = jsur.sample_nbocs(key, sj, 0.1)
    z = jax.random.normal(key, (sj.G.shape[0],), jnp.float32)   # surrogate.py:101
    alpha_t = tsur.sample_nbocs_from(st, torch.from_numpy(np.array(z)), 0.1)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-4, atol=1e-5)


def test_bbo_tiles_never_worse_than_alternating_and_close_to_jax():
    rng = np.random.default_rng(0)
    T, tn, td, K, iters = 32, 8, 16, 2, 12
    tiles = rng.standard_normal((T, tn, td)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(1), T)
    Mj, _, ej = jcomp.compress_tile_batch(
        jnp.asarray(tiles), keys, jax.random.PRNGKey(2), K, "bbo",
        bbo_iters=iters, backend="jnp",
    )
    signs = tdec.draw_restart_signs((T,), K, 4, tn, torch.Generator().manual_seed(1))
    tt = torch.from_numpy(tiles)
    M_alt, _, e_alt = tcomp.compress_tile_batch(tt, signs, K, "alternating")
    M_bbo, _, e_bbo = tcomp.compress_tile_batch(
        tt, signs, K, "bbo", generator=torch.Generator().manual_seed(2), bbo_iters=iters,
    )
    assert bool((e_bbo <= e_alt + 1e-7).all())
    obj_t = tdec.objective(M_bbo, tt).mean().item()
    obj_j = float(jnp.mean(jax.vmap(lambda M, W: jcomp.dec.objective(M, W))(
        Mj, jnp.asarray(tiles))))
    assert abs(obj_t - obj_j) <= 0.02 * obj_j


def test_outer_forms_draw_from_generators():
    from repro_torch.core import decomposition as tdec2

    rng = np.random.default_rng(6)
    W = torch.from_numpy(rng.standard_normal((3, 8, 16)).astype(np.float32))
    M, C, obj = tdec2.alternating_decompose(W, 3, generator=torch.Generator().manual_seed(0))
    M2, _, _ = tdec2.alternating_decompose(W, 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(M, M2) and set(torch.unique(M).tolist()) <= {-1.0, 1.0}
    assert bool((obj < (W * W).sum((1, 2))).all())
    stats = tsur.update_stats(tsur.init_stats(4, (2,)), torch.ones(2, 4), torch.tensor([1.0, 2.0]))
    a = tsur.sample_nbocs(stats, torch.Generator().manual_seed(1))
    b = tsur.sample_nbocs(stats, torch.Generator().manual_seed(1))
    assert a.shape == (2, 11) and torch.equal(a, b) and bool(torch.isfinite(a).all())
    prob = tising.IsingProblem(*_t(*_dyadic_problems(rng, 2, 6)))
    x, e = tising.solve_many("sa", prob, generator=torch.Generator().manual_seed(2),
                             num_sweeps=4, num_reads=3)
    assert x.shape == (2, 6) and e.shape == (2,)


def test_random_search_never_worse_than_its_initial_design():
    from repro_torch.core import bbo as tbbo

    rng = np.random.default_rng(9)
    tiles = torch.from_numpy(rng.standard_normal((4, 4, 8)).astype(np.float32))
    cfg = tbbo.BBOConfig(n=8, N=4, K=2, algo="rs", iters=6, init_points=5)
    res = tbbo.run_bbo_many(cfg, lambda xs: tdec.objective_from_x(xs, tiles, 2), 4,
                            torch.Generator().manual_seed(3))
    init_best = res.y[:, :5].min(1).values
    assert bool((res.best_y <= init_best).all()) and res.traj.shape == (4, 6)
    assert int(res.count[0]) == 11
    np.testing.assert_allclose(
        res.best_y.numpy(), tdec.objective_from_x(res.best_x, tiles, 2).numpy(), rtol=1e-6)
