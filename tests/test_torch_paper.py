"""The paper's BBO experiment path of the port against the JAX package's: the
SQA solver and K2's plain version, the remaining surrogates, symmetry,
instances, brute force and run_bbo / run_bbo_batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bbo as jbbo
from repro.core import bruteforce as jbf
from repro.core import decomposition as jdec
from repro.core import instances as jinst
from repro.core import ising as jising
from repro.core import surrogate as jsur
from repro.core import symmetry as jsym
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import state_to_torch
from repro_torch.core import bbo as tbbo
from repro_torch.core import bruteforce as tbf
from repro_torch.core import decomposition as tdec
from repro_torch.core import instances as tinst
from repro_torch.core import ising as tising
from repro_torch.core import surrogate as tsur
from repro_torch.core import symmetry as tsym
from repro_torch.kernels import sqa_sweep as tsqa

torch.set_num_threads(1)


def _dyadic_problems(rng, P, n):
    """h, B on the grid k/64, |.| <= 4: fields and energies are exact sums
    in float32, so summation order cannot change a bit."""
    h = rng.integers(-256, 257, (P, n)) / 64.0
    B = np.triu(rng.integers(-256, 257, (P, n, n)) / 64.0, 1)
    return h.astype(np.float32), (B + np.swapaxes(B, 1, 2)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _np(state):
    return type(state)(*[np.asarray(a) for a in state])


@pytest.mark.parametrize("P,C,T,S,n", [(3, 2, 4, 8, 8), (2, 3, 8, 12, 24),
                                       (2, 2, 1, 3, 40), (2, 2, 2, 3, 40), (1, 2, 3, 3, 40)])
def test_plain_sqa_identical_to_jax_ref_and_pallas(P, C, T, S, n):
    rng = np.random.default_rng(P * n + T)
    h, B = _dyadic_problems(rng, P, n)
    X0 = np.where(rng.random((P, C, T, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, T, n), dtype=np.float32)
    jp = np.geomspace(2.0, 1e-3, S).astype(np.float32)
    Xt, Et = tsqa.sqa_sweep_many(*_t(h, B, X0, u, jp), temperature=0.05)   # CPU: plain
    args = map(jnp.asarray, (h, B, X0, u, jp))
    Xr, Er = jref.sqa_sweep_many_ref(*args, temperature=0.05)
    Xp, Ep = jops.sqa_sweep_many(*map(jnp.asarray, (h, B, X0, u, jp)), temperature=0.05,
                                 interpret=True)
    for Xj, Ej in ((Xr, Er), (Xp, Ep)):
        np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
        # as tests/test_kernels.py holds the Pallas kernel to its oracle
        np.testing.assert_allclose(Et.numpy(), np.asarray(Ej), rtol=1e-4, atol=1e-4)
    assert not np.array_equal(Xt.numpy(), X0)          # the chains moved
    assert tsqa.sqa_sweep_many.launches == 0           # no kernel on the CPU


def test_sqa_kernel_wrapper_refuses_what_the_kernel_cannot_take():
    assert tsqa.max_spins(10, 8) >= 24 and tsqa.max_spins(1, 3) >= 40
    assert tsqa.max_spins(8, 64) < tsqa.max_spins(8, 8) < tsqa.max_spins(1, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        tsqa.sqa_sweep_many(*(torch.zeros(s, device="meta") for s in
                              ((1, 4), (1, 4, 4), (1, 1, 2, 4), (1, 1, 3, 2, 4), (3,))))


def _jax_sqa_draws(key, P, R, S, T, n):
    """The X0 and uniforms repro's _solve_keys draws for SQA (ising.py:206-211)."""
    X0s, us = [], []
    for k in jax.random.split(key, P):
        ka, kb = jax.random.split(k)
        X0s.append(np.asarray(jax.random.rademacher(ka, (R, T, n), dtype=jnp.float32)))
        us.append(np.asarray(jax.random.uniform(kb, (R, S, T, n), dtype=jnp.float32)))
    return np.stack(X0s), np.stack(us)


@pytest.mark.parametrize("warm", [False, True])
def test_solve_many_qa_from_jax_draws_identical(warm):
    rng = np.random.default_rng(12)
    P, R, S, T, n = 4, 3, 6, 4, 12
    h, B = _dyadic_problems(rng, P, n)
    key = jax.random.PRNGKey(5)
    init = np.where(rng.random((P, n)) < 0.5, -1.0, 1.0).astype(np.float32) if warm else None
    xj, ej = jising.solve_many(
        "qa", key, jising.IsingProblem(jnp.asarray(h), jnp.asarray(B)),
        num_sweeps=S, num_reads=R, n_trotter=T, backend="jnp",
        init_state=None if init is None else jnp.asarray(init),
    )
    X0, u = _jax_sqa_draws(key, P, R, S, T, n)
    xt, et = tising.solve_many_from(
        "qa", tising.IsingProblem(*_t(h, B)), *_t(X0, u),
        init_state=None if init is None else torch.from_numpy(init),
    )
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))


def test_sqa_couplings_match_jax_formula():
    S, T, t, g0 = 12, 8, 0.05, 3.0
    r = jnp.linspace(0.0, 1.0, S)
    PT = T * t
    want = -0.5 * PT * jnp.log(jnp.tanh(jnp.maximum(g0 * (1e-2 / g0) ** r / PT, 1e-7)))
    # log(tanh) near 1 loses relative precision: XLA's and libm's tanh differ by an ulp
    np.testing.assert_allclose(tising.sqa_jperps(S, T, t, g0).numpy(), np.asarray(want),
                               rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("name", ["sa", "sq", "qa", "sqa"])
def test_single_problem_wrappers_equal_solve_many_from_on_their_draws(name):
    rng = np.random.default_rng(3)
    h, B = (torch.from_numpy(a[0]) for a in _dyadic_problems(rng, 1, 10))
    kw = {"num_sweeps": 5, "num_reads": 3}
    if name in ("qa", "sqa"):
        kw["n_trotter"] = 3
    x, e = tising.solve(name, torch.Generator().manual_seed(7), h, B, **kw)
    canon = {"qa": "sqa"}.get(name, name)
    x0, u = tising.draw_initial(1, 3, 5, 10, torch.Generator().manual_seed(7),
                                3 if canon == "sqa" else None)
    xm, em = tising.solve_many_from(name, tising.IsingProblem(h[None], B[None]), x0, u)
    assert torch.equal(x, xm[0]) and torch.equal(e, em[0])
    assert x.shape == (10,) and e.shape == ()
    assert torch.equal(tising.ising_energy(x, h, B), e)
    if canon == "sqa":
        xs, es = tising.solve_sqa(torch.Generator().manual_seed(7), h, B, **kw)
        assert torch.equal(xs, x) and torch.equal(es, e)


def test_random_problems_and_energy_match_jax_forms():
    prob = tising.random_problems(torch.Generator().manual_seed(1), 3, 6)
    h, B = prob
    assert h.shape == (3, 6) and torch.equal(B, B.transpose(1, 2))
    assert torch.equal(torch.diagonal(B, dim1=1, dim2=2), torch.zeros(3, 6))
    x = torch.where(torch.rand(3, 6, generator=torch.Generator().manual_seed(2)) < 0.5, -1.0, 1.0)
    want = jax.vmap(jising.ising_energy)(*map(jnp.asarray, (x.numpy(), h.numpy(), B.numpy())))
    np.testing.assert_allclose(tising.ising_energy(x, h, B).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _stats(n, m, seed):
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((m, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    y = rng.standard_normal(m).astype(np.float32)
    sj = jsur.init_stats(n)
    for i in range(m):
        sj = jsur.update_stats(sj, jnp.asarray(X[i]), jnp.asarray(y[i]))
    return X, y, sj, state_to_torch(_np(sj), "cpu")


def test_sample_gbocs_with_injected_draws():
    _, _, sj, st = _stats(6, 14, 4)
    p = sj.G.shape[0]
    key = jax.random.PRNGKey(5)
    alpha_j = jsur.sample_gbocs(key, sj, b0=0.001)
    k1, k2 = jax.random.split(key)                                  # surrogate.py:145-146
    g = jax.random.gamma(k1, 1.0 + sj.count / 2.0)
    z = jax.random.normal(k2, (p,), jnp.float32)
    assert float(tsur.gbocs_shape(st.count)) == float(1.0 + sj.count / 2.0)
    alpha_t = tsur.sample_gbocs_from(st, *_t(g, z), b0=0.001)
    # f32 Cholesky solves in two libraries: agreement to a few ulps of |alpha|
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-4, atol=1e-5)


def test_sample_vbocs_two_gibbs_steps_with_injected_draws():
    _, _, sj, st = _stats(6, 14, 8)
    p = sj.G.shape[0]
    key = jax.random.PRNGKey(6)
    hs = jsur.init_horseshoe(6)
    alpha_j, hs_j = jsur.sample_vbocs(key, sj, hs, 2)
    draws = []
    for kk in jax.random.split(key, 2):                             # surrogate.py:195-196
        ks = jax.random.split(kk, 6)
        draws.append(tsur.GibbsDraws(*_t(
            jax.random.normal(ks[0], (p,), jnp.float32),
            jax.random.gamma(ks[1], jnp.ones((p,))),
            jax.random.gamma(ks[2], jnp.ones((p,))),
            jax.random.gamma(ks[3], jnp.asarray((p + 1.0) / 2.0, jnp.float32)),
            jax.random.gamma(ks[4], jnp.ones(())),
            jax.random.gamma(ks[5], jnp.asarray((sj.count + p) / 2.0, jnp.float32)),
        )))
    alpha_t, hs_t = tsur.sample_vbocs_from(st, state_to_torch(_np(hs), "cpu"), draws)
    assert type(hs_t) is tsur.HorseshoeState
    # two Gibbs sweeps of f32 Cholesky solves; the inverse-gamma scales
    # (nu reaches ~500) amplify ulp differences, so relative 1e-4
    for f in tsur.HorseshoeState._fields:
        np.testing.assert_allclose(getattr(hs_t, f).numpy(), np.asarray(getattr(hs_j, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=1e-4, atol=1e-5)


def test_train_fm_and_fm_to_ising_match_jax():
    X, y, _, _ = _stats(6, 14, 9)
    mask = np.ones(14, np.float32)
    mask[-4:] = 0.0
    fm = jsur.init_fm(jax.random.PRNGKey(2), 6, 3)
    fj = jsur.train_fm(fm, *map(jnp.asarray, (X, y, mask)), jax.random.PRNGKey(1), 10)
    ft = tsur.train_fm(state_to_torch(_np(fm), "cpu"), *_t(X, y, mask), steps=10)
    # ten f32 Adam steps on autograd vs jax.grad gradients
    for f in tsur.FMState._fields:
        np.testing.assert_allclose(getattr(ft, f).numpy(), np.asarray(getattr(fj, f)),
                                   rtol=1e-4, atol=1e-6, err_msg=f)
    for a, b in zip(tsur.fm_to_ising(ft), jsur.fm_to_ising(fj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    Vn = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (6, 3), jnp.float32))
    np.testing.assert_array_equal(tsur.init_fm_from(*_t(Vn)).V.numpy(),
                                  np.asarray(fm.V))


def test_fm_trained_on_inf_padded_rows_is_nan_as_in_jax():
    """The BBO loop pads its dataset with y = inf; the mask multiplies, so
    0 * inf poisons the FM in both packages (ROADMAP Queue 3)."""
    X, y, _, _ = _stats(4, 6, 1)
    y[3:] = np.inf
    mask = np.array([1, 1, 1, 0, 0, 0], np.float32)
    fm = jsur.init_fm(jax.random.PRNGKey(0), 4, 2)
    fj = jsur.train_fm(fm, *map(jnp.asarray, (X, y, mask)), jax.random.PRNGKey(1), 3)
    ft = tsur.train_fm(state_to_torch(_np(fm), "cpu"), *_t(X, y, mask), steps=3)
    assert np.isnan(np.asarray(fj.w)).all() and torch.isnan(ft.w).all()


def test_standard_gamma_moments():
    g = torch.Generator().manual_seed(0)
    for a in (1.0, 3.5, 40.0):
        s = tsur.standard_gamma(torch.full((100_000,), a), g)
        assert bool((s > 0).all())
        assert abs(float(s.mean()) - a) < 0.02 * a
        assert abs(float(s.var()) - a) < 0.05 * a
    a = tsur.standard_gamma(torch.full((5,), 2.0), torch.Generator().manual_seed(3))
    b = tsur.standard_gamma(torch.full((5,), 2.0), torch.Generator().manual_seed(3))
    assert torch.equal(a, b)


@pytest.mark.parametrize("N,K", [(4, 2), (3, 3)])
def test_orbit_flat_and_keys_identical_to_jax(N, K):
    rng = np.random.default_rng(N * K)
    x = np.where(rng.random(N * K) < 0.5, -1.0, 1.0).astype(np.float32)
    want = np.asarray(jsym.orbit_flat(jnp.asarray(x), N, K))
    got = tsym.orbit_flat(torch.from_numpy(x), N, K)
    np.testing.assert_array_equal(got.numpy(), want)
    batch = tsym.orbit_flat(torch.from_numpy(np.stack([x, -x])), N, K)
    np.testing.assert_array_equal(batch[0].numpy(), want)
    assert batch.shape == (2, tsym.orbit_size(K), N * K)
    Ms = want.reshape(-1, N, K)
    assert tsym.canonical_key(Ms[0]) == jsym.canonical_key(Ms[0])
    assert len(tsym.dedupe_exact(Ms)) == len(jsym.dedupe_exact(Ms)) == 1


def test_instances_from_jax_factors_and_device_guard():
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))                # instances.py:38-39
    A = np.asarray(jax.random.normal(k1, (8, 8), jnp.float32))
    B = np.asarray(jax.random.normal(k2, (8, 100), jnp.float32))
    W = tinst.shrunk_vgg_instance_from(*_t(A, B))
    np.testing.assert_allclose(W.numpy(), np.asarray(jinst.shrunk_vgg_instance(3)),
                               rtol=1e-6, atol=1e-6)
    Z = np.asarray(jax.random.normal(jax.random.PRNGKey(3 ^ 0x5EED), (8, 100), jnp.float32))
    np.testing.assert_allclose(tinst.random_instance_from(*_t(Z)).numpy(),
                               np.asarray(jinst.random_instance(3)), rtol=1e-6, atol=1e-6)
    Ws = tinst.paper_instances(2, device="cpu")
    assert len(Ws) == 2 and Ws[0].shape == (8, 100)
    assert abs(float(torch.linalg.vector_norm(Ws[1])) - 1.0) < 1e-6
    assert torch.equal(Ws[0], tinst.shrunk_vgg_instance(0, device="cpu"))


def test_brute_force_matches_jax_with_small_chunks():
    W = np.asarray(jinst.shrunk_vgg_instance(1, N=4, D=12))
    rj = jbf.brute_force(W, 2, chunk=32)
    rt = tbf.brute_force(*_t(W), 2, chunk=32)
    # a cost is ||W||^2 - (projection), both near 1: LAPACK's and XLA's
    # eigh differ by a few ulps of 1 (6e-8 each), so absolute 1e-6
    np.testing.assert_allclose(rt.best_cost, rj.best_cost, rtol=0, atol=1e-6)
    np.testing.assert_allclose(rt.second_cost, rj.second_cost, rtol=0, atol=1e-6)
    key = lambda S: sorted(map(tuple, S.reshape(len(S), -1).tolist()))  # noqa: E731
    assert key(tbf.exact_solutions(rt)) == key(jbf.exact_solutions(rj))
    assert len(tbf.exact_solutions(rt)) == tsym.orbit_size(2)
    whole = tbf.brute_force(*_t(W), 2, chunk=256)
    assert whole.best_cost == rt.best_cost and whole.second_cost == rt.second_cost


def test_objective_helpers_match_jax():
    rng = np.random.default_rng(2)
    W = rng.standard_normal((4, 12)).astype(np.float32)
    X = np.where(rng.random((5, 8)) < 0.5, -1.0, 1.0).astype(np.float32)
    f = tdec.make_objective(torch.from_numpy(W), 2)
    fj = jdec.make_objective(jnp.asarray(W), 2)
    np.testing.assert_allclose(f(torch.from_numpy(X)).numpy(),
                               np.asarray(jax.vmap(fj)(jnp.asarray(X))), rtol=1e-5)
    M = X[0].reshape(4, 2)
    exact = 0.3
    np.testing.assert_allclose(
        float(tdec.residual_error(torch.from_numpy(M), torch.from_numpy(W), exact)),
        float(jdec.residual_error(jnp.asarray(M), jnp.asarray(W), exact)), rtol=1e-5)


def _jax_rs_draws(key, runs, ip, iters, n):
    """X0, candidates and dedupe flips of repro's run_bbo for algo="rs"
    (bbo.py: run_bbo, _propose, _dedupe), one run per key."""

    def run(k):
        k_init, k_loop = jax.random.split(k)

        def it(ki):
            k1, k2 = jax.random.split(ki)
            _, k_solve = jax.random.split(k1)
            return (jax.random.rademacher(k_solve, (n,), dtype=jnp.float32),
                    jax.random.randint(k2, (), 0, n))

        xs, flips = jax.vmap(it)(jax.random.split(k_loop, iters))
        return jax.random.rademacher(k_init, (ip, n), dtype=jnp.float32), xs, flips

    return [np.asarray(a) for a in jax.jit(jax.vmap(run))(jax.random.split(key, runs))]


def test_random_search_with_jax_draws_proposes_what_jax_proposes():
    W = jinst.shrunk_vgg_instance(2, N=4, D=12)
    runs, ip, iters, n = 3, 8, 40, 8
    cfg = dict(n=n, N=4, K=2, algo="rs", iters=iters, init_points=ip)
    key = jax.random.PRNGKey(4)
    rj = jbbo.run_bbo_batch(key, jbbo.BBOConfig(**cfg), jdec.make_objective(W, 2), runs)
    X0, xs, flips = _jax_rs_draws(key, runs, ip, iters, n)
    draws = [tbbo.IterDraws(flip=torch.from_numpy(flips[:, i].astype(np.int64)),
                            x_rand=torch.from_numpy(np.array(xs[:, i]))) for i in range(iters)]
    f = tdec.make_objective(torch.from_numpy(np.array(W)), 2)
    rt = tbbo.run_bbo_many_from(tbbo.BBOConfig(**cfg), f, *_t(X0), draws)
    assert (xs == np.asarray(rj.proposed)).mean() < 1.0        # some duplicates were flipped
    np.testing.assert_array_equal(rt.proposed.numpy(), np.asarray(rj.proposed))
    np.testing.assert_array_equal(rt.X.numpy(), np.asarray(rj.X))
    np.testing.assert_allclose(rt.best_y.numpy(), np.asarray(rj.best_y), rtol=1e-5)
    np.testing.assert_allclose(rt.traj.numpy(), np.asarray(rj.traj), rtol=1e-5)


def test_run_bbo_batch_nbocs_qa_close_to_jax():
    """Quality, not bits: the two packages draw with different generators.
    A run's best cost takes a few discrete values here (the optimum or a
    near miss), so a mean over runs has a standard error of a few percent;
    the means must agree within three standard errors of their difference."""
    W = jinst.shrunk_vgg_instance(0, N=4, D=12)
    runs = 64
    cfg = dict(n=8, N=4, K=2, algo="nbocs", solver="qa", iters=16, num_sweeps=8)
    rj = jbbo.run_bbo_batch(jax.random.PRNGKey(0), jbbo.BBOConfig(backend="jnp", **cfg),
                            jdec.make_objective(W, 2), runs)
    f = tdec.make_objective(torch.from_numpy(np.array(W)), 2)
    rt = tbbo.run_bbo_batch(tbbo.BBOConfig(**cfg), f, runs, torch.Generator().manual_seed(0))
    yj, yt = np.asarray(rj.best_y, np.float64), rt.best_y.double().numpy()
    se = np.sqrt(yj.var(ddof=1) / runs + yt.var(ddof=1) / runs)
    assert abs(yt.mean() - yj.mean()) <= 3 * se
    best = min(yj.min(), yt.min())
    assert (yt <= best * (1 + 1e-5)).mean() >= 0.5 and (yj <= best * (1 + 1e-5)).mean() >= 0.5
    assert rt.traj.shape == (runs, 16) and bool((rt.traj[:, 1:] <= rt.traj[:, :-1]).all())
    np.testing.assert_allclose(f(rt.best_x).numpy(), rt.best_y.numpy(), rtol=1e-6)


@pytest.mark.parametrize("algo,opts", [
    ("rs", {}), ("nbocs", {"solver": "sq"}), ("gbocs", {}), ("vbocs", {"gibbs_steps": 2}),
    ("fmqa", {"fm_rank": 3, "fm_steps": 3}), ("nbocs", {"augment": True}),
])
def test_run_bbo_every_algorithm(algo, opts):
    W = tinst.shrunk_vgg_instance(0, N=4, D=12, device="cpu")
    f = tdec.make_objective(W, 2)
    cfg = tbbo.BBOConfig(n=8, N=4, K=2, algo=algo, iters=6, num_sweeps=4, num_reads=2, **opts)
    res = tbbo.run_bbo(cfg, f, torch.Generator().manual_seed(1))
    assert res.best_x.shape == (8,) and res.traj.shape == (6,) and res.proposed.shape == (6, 8)
    assert int(res.count) == 8 + 6 * cfg.points_per_iter == cfg.max_points
    assert float(res.best_y) == float(res.y[: int(res.count)].min())
    np.testing.assert_allclose(float(f(res.best_x)), float(res.best_y), rtol=1e-6)
    if opts.get("augment"):
        orbit = tsym.orbit_flat(res.proposed[0], 4, 2)
        np.testing.assert_array_equal(res.X[8:8 + len(orbit)].numpy(), orbit.numpy())
    with pytest.raises(ValueError, match="unknown algo"):
        tbbo.BBOConfig(n=8, N=4, K=2, algo="bocs")


def test_state_to_torch_carries_named_states():
    sj = jsur.init_stats(5)
    st = state_to_torch(_np(sj), "cpu")
    assert type(st) is tsur.SuffStats and st.G.shape == (16, 16)
    fm = state_to_torch(_np(jsur.init_fm(jax.random.PRNGKey(0), 5, 2)), "cpu")
    assert type(fm) is tsur.FMState and fm.V.dtype == torch.float32
    with pytest.raises(TypeError, match="no port state"):
        state_to_torch(jdec.GreedyResult(*[np.zeros(1)] * 4), "cpu")
