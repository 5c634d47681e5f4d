"""The port's budget autotuner and task-metric eval against the JAX
package's, on the same inputs and draws (CPU)."""

import contextlib
import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.compression import execute as jexec
from repro.compression.autotune import allocate as jalloc
from repro.compression.autotune import calibrate as jcal
from repro.compression.autotune import probe as jprobe
from repro.compression.autotune import refine as jrefine
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.eval import allocate_lp as jlp
from repro.eval import harness as jharness
from repro.eval import metric_table as jmt
from repro.models import init_model as j_init_model
from repro.models import layers as jlayers
from repro.models.params import split as j_split
from repro_torch import bridge
from repro_torch import compression as tc
from repro_torch.compression import plan as tplan
from repro_torch.compression.autotune import allocate as talloc
from repro_torch.compression.autotune import calibrate as tcal
from repro_torch.compression.autotune import probe as tprobe
from repro_torch.compression.autotune import refine as trefine
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.eval import allocate_lp as tlp
from repro_torch.eval import harness as tharness
from repro_torch.eval import metric_table as tmt
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

_POLICY = dict(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5, min_size=4096)
_KFR = (0.25, 0.5)


def _carry(jvalues):
    return bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jvalues)}, "cpu")


@contextlib.contextmanager
def _jax_jitted_forward():
    """JAX's calibration runs ``jax.grad`` of its forward eagerly; a jitted
    forward gives the same weights (within 1e-5) several times faster."""
    import repro.models as jmodels

    eager = jmodels.forward
    jmodels.forward = jax.jit(eager, static_argnums=(2,))
    try:
        yield
    finally:
        jmodels.forward = eager


@pytest.fixture(scope="module")
def qwen():
    """The JAX package's autotune fixture: reduced qwen3 with attention's
    output projection scaled by 4, in f32, on both sides."""
    jcfg = j_reduced(j_get_config("qwen3-32b"))
    jvalues, _ = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))
    wo = jvalues["groups"]["0"]["attn"]["wo"]["w"]
    jvalues["groups"]["0"]["attn"]["wo"]["w"] = wo * 4.0
    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    return jcfg, jvalues, cfg, _carry(jvalues)


def _plans(jvalues, values, **kw):
    jp = jc.plan_compression(jvalues, jc.CompressionPolicy(**{**_POLICY, **kw}))
    tp = tc.plan_compression(values, tc.CompressionPolicy(**{**_POLICY, **kw}))
    assert tp.to_json() == jp.to_json()
    return jp, tp


# ---------------------------------------------------------------------------
# allocators on synthetic curves
# ---------------------------------------------------------------------------

def _synth(seed, n_tensors=5, n_points=6):
    """The same random curves as JAX's and the port's ProbeResults."""
    rng = random.Random(seed)
    jp, tp = [], []
    for i in range(n_tensors):
        k = rng.randint(1, n_points)
        sizes = sorted(rng.sample(range(8, 400), k))
        top = rng.uniform(5.0, 120.0)
        dists = sorted((rng.uniform(0.0, top) for _ in range(k)), reverse=True)
        for mod, out in ((jprobe, jp), (tprobe, tp)):
            pts = tuple(mod.RDPoint(8, 16, j + 1, b, d) for j, (b, d) in enumerate(zip(sizes, dists)))
            out.append(mod.ProbeResult(f"t{i}", sizes[-1] + 64, 1.0, pts))
    return jp, tp


def _alloc_dict(a):
    d = a.to_dict()
    del d["solve_s"]
    return d


def _caps(probes, capped: bool):
    """Two overlapping group caps a little above their members' cheapest
    bytes (none unless ``capped``)."""
    if not capped:
        return ()
    mins = [p.min_bytes for p in probes]
    return ((r"t[01]", sum(mins[:2]) + 120), (r"t[0-3]", sum(mins[:4]) + 300))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("capped", [False, True], ids=["global", "caps"])
def test_hull_and_greedy_identical_to_jax(seed, capped):
    jp, tp = _synth(seed)
    groups = _caps(tp, capped)
    for a, b in zip(jp, tp):
        assert [dataclasses.astuple(p) for p in talloc.lower_hull(b.points)] == \
            [dataclasses.astuple(p) for p in jalloc.lower_hull(a.points)]
        assert [dataclasses.astuple(p) for p in talloc._pareto(b.points)] == \
            [dataclasses.astuple(p) for p in jalloc._pareto(a.points)]
    paths = [p.path for p in tp]
    assert talloc.resolve_groups(groups, paths) == jalloc.resolve_groups(groups, paths)
    lo = sum(p.min_bytes for p in tp)
    hi = sum(max(q.bytes for q in p.points) for p in tp)
    for frac in (0.0, 0.3, 0.7, 1.0):
        budget = int(lo + frac * (hi - lo))
        try:
            ja = jalloc.allocate_budget(jp, budget, group_budgets=groups)
        except jalloc.BudgetInfeasibleError as e:
            with pytest.raises(talloc.BudgetInfeasibleError) as te:
                talloc.allocate_budget(tp, budget, group_budgets=groups, device="cpu")
            assert (str(te.value), te.value.min_bytes) == (str(e), e.min_bytes)
            continue
        ta = talloc.allocate_budget(tp, budget, group_budgets=groups, device="cpu")
        assert _alloc_dict(ta) == _alloc_dict(ja)
        got = tlp.solve_mckp(tp, budget, group_budgets=groups)
        want = jlp.solve_mckp(jp, budget, group_budgets=groups)
        assert {k: dataclasses.astuple(v) for k, v in got[0].items()} == \
            {k: dataclasses.astuple(v) for k, v in want[0].items()}
        assert got[1] == want[1]


def test_infeasible_budget_raises_as_jax():
    jp, tp = _synth(7)
    budget = sum(p.min_bytes for p in tp) - 1
    for engine in ("greedy", "qubo"):
        with pytest.raises(jalloc.BudgetInfeasibleError) as je:
            jalloc.allocate_budget(jp, budget, engine=engine)
        with pytest.raises(talloc.BudgetInfeasibleError) as te:
            talloc.allocate_budget(tp, budget, engine=engine, device="cpu")
        assert str(te.value) == str(je.value)
        assert te.value.min_bytes == je.value.min_bytes == budget + 1


def _jax_solve_draws(key, P, R, S, n):
    """The x0 and uniforms repro's _solve_keys draws for SA (ising.py:171-177)."""
    x0s, us = [], []
    for k in jax.random.split(key, P):
        ka, kb = jax.random.split(k)
        x0s.append(np.asarray(jax.random.rademacher(ka, (R, n), dtype=jnp.float32)))
        us.append(np.asarray(jax.random.uniform(kb, (R, S, n), dtype=jnp.float32)))
    return torch.from_numpy(np.stack(x0s)), torch.from_numpy(np.stack(us))


@pytest.mark.parametrize("capped", [False, True], ids=["global", "caps"])
def test_qubo_encoding_and_anneal_identical_to_jax(capped):
    from repro.core import ising as jising
    from repro_torch.core import ising as tising

    jp, tp = _synth(3, n_tensors=5, n_points=5)
    groups = _caps(tp, capped)
    budget = sum(p.min_bytes for p in tp) + 500
    jh = {p.path: jalloc.lower_hull(p.points) for p in jp}
    th = {p.path: talloc.lower_hull(p.points) for p in tp}
    jg = jalloc.resolve_groups(groups, list(jh))
    tg = talloc.resolve_groups(groups, list(th))
    base = talloc._check_feasible(th, budget, tg)
    hj, Bj, vj = jalloc._qubo_ising(jh, budget, base, jg)
    ht, Bt, vt = talloc._qubo_ising(th, budget, base, tg, "cpu")
    assert vt == vj
    assert ht.dtype == Bt.dtype == torch.float32
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(Bt.numpy(), np.asarray(Bj))

    key, S, R = jax.random.PRNGKey(3), 24, 4
    xj, _ = jising.solve_many("sa", key, jising.IsingProblem(hj, Bj), num_sweeps=S,
                              num_reads=R, backend="jnp")
    x0, u = _jax_solve_draws(key, *ht.shape[:1], R, S, ht.shape[1])
    xt, _ = tising.solve_many_from("sa", tising.IsingProblem(ht, Bt), x0, u)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))

    ja = jalloc.allocate_budget(jp, budget, engine="qubo", key=key, backend="jnp",
                                num_sweeps=S, num_reads=R, group_budgets=groups)
    ta = talloc.allocate_budget_from(
        tp, budget, lambda P, R_, S_, n: _jax_solve_draws(key, P, R_, S_, n), engine="qubo",
        device="cpu", num_sweeps=S, num_reads=R, group_budgets=groups)
    assert _alloc_dict(ta) == _alloc_dict(ja)
    assert ta.num_spins == ht.shape[1] and ta.total_bytes <= budget


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def test_candidate_settings_identical_to_jax(qwen):
    _, jvalues, _, values = qwen
    jp, tp = _plans(jvalues, values)
    for jt, tt in zip(jp.tensors, tp.tensors):
        for kw in ({}, {"tile_d_choices": 2, "include_int8": True},
                   {"k_fractions": _KFR, "include_int8": True}):
            got = [dataclasses.asdict(c) for c in tprobe.candidate_settings(tt, **kw)]
            want = [dataclasses.asdict(c) for c in jprobe.candidate_settings(jt, **kw)]
            assert got == want


def test_default_k_grid_reaches_28_at_tile_n_32_as_in_jax():
    """The reference's default K fractions at tile_n 32 give K up to 28,
    whose 2^K sign patterns alternating cannot enumerate; the port copies
    the grid (callers pass ``k_fractions`` at such tiles)."""
    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    values = {"w": torch.zeros(cfg.d_model * 4, 256)}
    jvalues = {"w": jnp.zeros((cfg.d_model * 4, 256))}
    kw = dict(tile_n=32, tile_d=128, min_size=1024, targets=(r"^w$",))
    jt = jc.plan_compression(jvalues, jc.CompressionPolicy(**kw)).tensors[0]
    tt = tc.plan_compression(values, tc.CompressionPolicy(**kw)).tensors[0]
    ks = [c.K for c in tprobe.candidate_settings(tt)]
    assert ks == [c.K for c in jprobe.candidate_settings(jt)] == [4, 8, 12, 16, 20, 24, 28]
    assert tprobe.DEFAULT_K_FRACTIONS == jprobe.DEFAULT_K_FRACTIONS


def _jax_restart_signs(key, K, restarts, N):
    """The restart signs repro's greedy draws inside (decomposition.py:143)."""
    return jnp.stack([
        jnp.sign(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, k), 17),
                                   (restarts, N)))
        for k in range(K)
    ])


def _jax_draws(jplan, key, max_tiles):
    """``probe_tensors_from``'s sample and signs: the JAX probe's tile
    subsample and each tile's restart signs from its per-tile key."""
    jt = {t.path: t for t in jplan.tensors}

    def jct(t, ct):
        j = jt[t.path]
        if ct.method == "int8":
            return jprobe._candidate_plan_int8(j, ct.tile_n, ct.tile_d)
        return jprobe._candidate_plan(j, ct.tile_n, ct.tile_d, ct.K)

    def sample(t, ct):
        idx = jprobe._probe_indices(key, jt[t.path], jct(t, ct), max_tiles)
        return None if idx is None else torch.from_numpy(np.array(idx))

    def signs(t, ct):
        keys = jexec._tensor_keys(key, jct(t, ct))
        s = jax.vmap(lambda k: _jax_restart_signs(k, ct.K, 4, ct.tile_n))(keys)
        return torch.from_numpy(np.array(s))

    return sample, signs


@pytest.mark.parametrize("method", ["greedy", "alternating"])
def test_probe_on_jax_draws_matches_jax(qwen, method):
    _, jvalues, _, values = qwen
    jp, tp = _plans(jvalues, values, method=method)
    key = jax.random.PRNGKey(0)
    jprobes, jtrials = jprobe.probe_tensors(jvalues, jp, key=key, max_probe_tiles=8,
                                            k_fractions=_KFR, include_int8=True,
                                            keep_trials=True)
    sample, signs = _jax_draws(jp, key, 8)
    tprobes, ttrials = tprobe.probe_tensors_from(values, tp, sample=sample, signs=signs,
                                                 device="cpu", k_fractions=_KFR,
                                                 include_int8=True, keep_trials=True)
    assert [p.path for p in tprobes] == [p.path for p in jprobes]
    for a, b in zip(tprobes, jprobes):
        assert (a.orig_bytes, a.weight) == (b.orig_bytes, b.weight)
        for pa, pb in zip(a.points, b.points, strict=True):
            assert (pa.tile_n, pa.tile_d, pa.K, pa.bytes, pa.method) == \
                (pb.tile_n, pb.tile_d, pb.K, pb.bytes, pb.method)
            assert pa.distortion == pytest.approx(pb.distortion, rel=1e-5)
    assert sorted(ttrials) == sorted(jtrials)
    for k, tr in ttrials.items():
        jtr = jtrials[k]
        assert tr.num_tiles == jtr.num_tiles
        assert (tr.indices is None) == (jtr.indices is None)
        if tr.indices is not None:
            np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jtr.indices))
        if k[-1] == "int8":
            # q is identical (tests/test_torch_compression.py); XLA divides
            # max|W| by 127 as a product with the reciprocal: scales within an ulp
            np.testing.assert_allclose(tr.recon.numpy(), np.asarray(jtr.recon), rtol=2.5e-7)
        else:
            np.testing.assert_allclose(tr.recon.numpy(), np.asarray(jtr.recon),
                                       rtol=1e-4, atol=1e-5)


def _measured(artifact):
    """{path: sum of squared tile residuals} as execute measured them
    against the stored factors (the manifest's ``tile_resid``)."""
    return {p: sum(v * v for v in e["tile_resid"]) for p, e in artifact.manifest["tensors"].items()}


@pytest.mark.parametrize("method", ["greedy", "alternating"])
def test_probe_of_every_tile_is_what_execute_measures(qwen, method):
    _, _, _, values = qwen
    plan = tc.plan_compression(values, tc.CompressionPolicy(**{**_POLICY, "method": method}))
    probes = tprobe.probe_tensors(values, plan, seed=3, device="cpu", max_probe_tiles=None,
                                  k_fractions=(0.5,))
    _, artifact = tc.execute_plan(plan, values, seed=3, device="cpu")
    measured = _measured(artifact)
    for pr, t in zip(probes, plan.tensors):
        pt = next(p for p in pr.points if p.K == t.K)
        assert pt.bytes == artifact.manifest["tensors"][pr.path]["new_bytes"]
        assert pt.distortion == pytest.approx(measured[pr.path], rel=1e-4)


def test_probe_subsample_is_drawn_by_geometry_not_k(qwen):
    _, _, _, values = qwen
    plan = tc.plan_compression(values, tc.CompressionPolicy(**_POLICY))
    t = plan.tensors[0]
    cts = tprobe.candidate_settings(t, _KFR)
    a, b = (tprobe.probe_indices(0, t, ct, 4, "cpu") for ct in cts)
    assert torch.equal(a, b) and len(a) == 4 and bool((a[1:] > a[:-1]).all())
    assert not torch.equal(a, tprobe.probe_indices(1, t, cts[0], 4, "cpu"))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-32b", "zamba2-1.2b"])
def test_calibration_weights_on_jax_tokens_match(arch):
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    from repro_torch.models.params import split
    from repro_torch.models import init_model

    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), dtype="float32")
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype="float32")
    if arch == "zamba2-1.2b":     # one SSD block and one with the shared block
        short = dict(num_layers=2, block_pattern=("ssm", "ssm_attn"))
        jcfg = dataclasses.replace(jcfg, **short)
        cfg = dataclasses.replace(cfg, **short)
    jvalues, _ = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))
    values = _carry(jvalues)
    tok = jcal.calibration_inputs(jcfg, batch=2, seq_len=16, key=jax.random.PRNGKey(4))
    with _jax_jitted_forward():
        want = jcal.calibration_weights(jvalues, jcfg, inputs=tok)
    inputs = {"tokens": torch.from_numpy(np.array(tok["tokens"])).long()}
    before = [p.detach().clone() for _, p in tplan.tree_paths(values)]
    got = tcal.calibration_weights(values, cfg, inputs=inputs)
    assert sorted(got) == sorted(want)
    for p in want:
        assert got[p] == pytest.approx(want[p], rel=1e-4, abs=1e-9), p
    # the caller's tensors untouched, no gradient attached
    for b, (_, p) in zip(before, tplan.tree_paths(values)):
        assert torch.equal(b, p) and not p.requires_grad and p.grad is None
    # the kernel hooks are cleared while gradients are taken, then restored
    ops.enable_kernels()
    try:
        again = tcal.calibration_weights(values, cfg, inputs=inputs)
        assert attention._FLASH_IMPL is not None
    finally:
        ops.disable_kernels()
    assert again == got


def test_calibration_draws_per_batch_seed():
    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    a = tcal.calibration_inputs(cfg, seed=5, device="cpu")["tokens"]
    b = tcal.calibration_inputs(cfg, seed=5, device="cpu")["tokens"]
    assert torch.equal(a, b) and a.shape == (4, 32)
    assert int(a.max()) < cfg.vocab_size
    with pytest.raises(ValueError, match="num_batches"):
        tcal.calibration_weights({}, cfg, num_batches=0, device="cpu")


# ---------------------------------------------------------------------------
# refined plans
# ---------------------------------------------------------------------------

def _to_port_probes(jprobes):
    return [tprobe.ProbeResult(p.path, p.orig_bytes, p.weight,
                               tuple(tprobe.RDPoint(**dataclasses.asdict(q)) for q in p.points))
            for p in jprobes]


def _to_port_alloc(ja):
    return talloc.Allocation(
        choices={k: tprobe.RDPoint(**dataclasses.asdict(v)) for k, v in ja.choices.items()},
        budget_bytes=ja.budget_bytes, total_bytes=ja.total_bytes,
        total_distortion=ja.total_distortion, engine=ja.engine, solve_s=ja.solve_s)


@pytest.fixture(scope="module")
def jax_tuned(qwen, tmp_path_factory):
    """JAX's autotuner at 0.7 x the uniform bytes (greedy, uncalibrated),
    its plan executed and saved with its checkpoint."""
    from repro.checkpoint import checkpointer as jckpt

    jcfg, jvalues, cfg, values = qwen
    budget = int(0.7 * jc.plan_compression(jvalues, jc.CompressionPolicy(**_POLICY))
                 .total_bytes())
    jres = jrefine.autotune_plan(jvalues, jc.CompressionPolicy(**_POLICY), budget,
                                 key=jax.random.PRNGKey(0), max_probe_tiles=8,
                                 k_fractions=_KFR, tile_d_choices=2, int8_baseline=True)
    jcv, jart = jc.execute_plan(jres.plan, jvalues, key=jax.random.PRNGKey(0))
    d = str(tmp_path_factory.mktemp("jax_tuned"))
    jckpt.save(d, 0, {"params": jcv})
    jart.save(d)
    return budget, jres, d


@pytest.mark.parametrize("engine", ["greedy", "qubo"])
def test_refined_plan_byte_identical_to_jax(qwen, jax_tuned, engine):
    """For JAX's allocation (greedy uncalibrated; qubo calibrated) the port
    refines to the same plan JSON, metadata block and rules."""
    jcfg, jvalues, cfg, values = qwen
    budget, jres, _ = jax_tuned
    if engine == "qubo":
        with _jax_jitted_forward():
            jres = jrefine.autotune_plan(
                jvalues, jc.CompressionPolicy(**_POLICY), budget, key=jax.random.PRNGKey(0),
                engine=engine, cfg=jcfg, calibration=True, max_probe_tiles=8,
                k_fractions=_KFR, backend="jnp", num_sweeps=16, num_reads=2)
    tp = tc.plan_compression(values, tc.CompressionPolicy(**_POLICY))
    res = trefine._refine(
        values, tc.CompressionPolicy(**_POLICY), tp, budget, _to_port_alloc(jres.allocation),
        _to_port_probes(jres.probes), jres.weights, seed=0, device="cpu", engine=engine,
        objective="frobenius", table=None, run_lp=False, lp_tolerance=0.05, calib_batches=1,
        include_int8=engine == "greedy", max_probe_tiles=8,
        tile_d_choices=2 if engine == "greedy" else 1)
    assert res.plan.to_json() == jres.plan.to_json()
    assert res.plan.autotune == jres.plan.autotune
    assert ("calibration" in res.plan.autotune) == (engine == "qubo")
    assert [dataclasses.asdict(r) for r in res.policy.rules] == \
        [dataclasses.asdict(r) for r in jres.policy.rules]


def test_autotune_plan_runs_both_engines_and_objectives(qwen):
    _, _, cfg, values = qwen
    policy = tc.CompressionPolicy(**_POLICY)
    budget = int(0.75 * tc.plan_compression(values, policy).total_bytes())
    for engine, objective in (("qubo", "frobenius"), ("greedy", "eval_loss")):
        plan = tc.plan_compression(values, policy, budget_bytes=budget, seed=0, device="cpu",
                                   engine=engine, objective=objective, cfg=cfg,
                                   calibration=True, max_probe_tiles=8, k_fractions=_KFR,
                                   num_sweeps=16, num_reads=2)
        a = plan.autotune
        assert a["engine"] == engine and a["objective"] == objective
        assert a["predicted_bytes"] <= budget and a["calibration"]["key"] == [0, 0]
        assert ("cross_check" in a) == (engine == "qubo")
        assert ("eval" in a) == ("lp_check" in a) == (objective == "eval_loss")
        if objective == "eval_loss":
            assert a["lp_check"]["status"] == "optimal" and a["lp_check"]["within_tolerance"]
    with pytest.raises(TypeError, match="only apply with budget_bytes"):
        tc.plan_compression(values, policy, engine="qubo")
    with pytest.raises(ValueError, match="unknown objective"):
        trefine.autotune_plan(values, policy, budget, device="cpu", objective="bleu")
    with pytest.raises(ValueError, match="calibration needs cfg"):
        trefine.autotune_plan(values, policy, budget, device="cpu", calibration=True)


# ---------------------------------------------------------------------------
# eval: losses, harness, metric table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("softcap,z_loss", [(0.0, 0.0), (30.0, 1e-4)])
def test_cross_entropy_losses_match_jax(softcap, z_loss):
    rng = np.random.default_rng(0)
    B, T, d, V = 2, 37, 16, 50
    h = rng.standard_normal((B, T, d)).astype(np.float32)
    W = rng.standard_normal((d, V)).astype(np.float32)
    labels = rng.integers(0, V, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) < 0.8).astype(np.float32)
    want = float(jlayers.chunked_softmax_cross_entropy(
        jnp.asarray(h), jnp.asarray(W), jnp.asarray(labels), jnp.asarray(mask), z_loss,
        softcap, chunk=16))
    got = float(tlayers.chunked_softmax_cross_entropy(
        torch.from_numpy(h), torch.from_numpy(W), torch.from_numpy(labels),
        torch.from_numpy(mask), z_loss, softcap, chunk=16))
    dense = float(tlayers.softmax_cross_entropy(
        torch.from_numpy(h @ W), torch.from_numpy(labels), torch.from_numpy(mask), z_loss,
        softcap))
    jdense = float(jlayers.softmax_cross_entropy(
        jnp.asarray(h @ W), jnp.asarray(labels), jnp.asarray(mask), z_loss, softcap))
    assert got == pytest.approx(want, rel=1e-5)
    assert dense == pytest.approx(jdense, rel=1e-5)
    assert got == pytest.approx(dense, rel=1e-5)


def _harnesses(jcfg, cfg):
    jh = jharness.EvalHarness(jcfg, num_batches=2, batch=2, seq_len=16, seed=0)
    th = tharness.EvalHarness(cfg, num_batches=2, batch=2, seq_len=16, seed=0, device="cpu")
    th.batches = [{"tokens": torch.from_numpy(np.array(b["tokens"])).long()}
                  for b in jh.batches]
    return jh, th


def test_harness_matches_jax_and_caches_the_baseline(qwen):
    jcfg, jvalues, cfg, values = qwen
    jh, th = _harnesses(jcfg, cfg)
    tharness.clear_baseline_cache()
    want, got = jh.baseline(jvalues), th.baseline(values)
    assert got.loss == pytest.approx(want.loss, rel=1e-5)
    np.testing.assert_allclose(got.pos_energy, want.pos_energy, rtol=1e-4)
    assert th.to_dict() == jh.to_dict()
    assert len(tharness._BASELINE_CACHE) == 1
    assert th.baseline(values) is got
    # a spliced tree scores against the cached reference
    leaf = dict(tplan.tree_paths(values))["groups/0/attn/wo/w"]
    spliced = tmt.splice_values(values, "groups/0/attn/wo/w", leaf * 0.5)
    jleaf = dict(j_tree_paths(jvalues))["groups/0/attn/wo/w"]
    jspliced = jmt.splice_values(jvalues, "groups/0/attn/wo/w", jleaf * 0.5)
    assert th.evaluate(spliced).loss == pytest.approx(jh.evaluate(jspliced).loss, rel=1e-5)
    with pytest.raises(RuntimeError, match="no reference set"):
        tharness.EvalHarness(cfg, num_batches=1, device="cpu").evaluate(values)


def test_splice_and_restore_are_bit_exact(qwen):
    _, _, _, values = qwen
    plan = tc.plan_compression(values, tc.CompressionPolicy(**_POLICY))
    t = plan.tensors[0]
    leaf = dict(tplan.tree_paths(values))[t.path]
    from repro_torch.compression.execute import _tensor_tiles

    tiles = _tensor_tiles(leaf, t, "cpu")
    trial = tprobe.TrialSplice(indices=torch.tensor([1, 3]), recon=torch.zeros(2, t.tile_n,
                                                                               t.tile_d),
                               resid2=0.0, num_tiles=t.num_tiles)
    new = tmt.spliced_leaf(leaf, t, trial)
    got = _tensor_tiles(new, t, "cpu")
    assert bool((got[[1, 3]] == 0).all())
    keep = [i for i in range(t.num_tiles) if i not in (1, 3)]
    assert torch.equal(got[keep], tiles[keep])
    spliced = tmt.splice_values(values, t.path, new)
    restored = tmt.splice_values(spliced, t.path, leaf)
    for (pa, a), (pb, b) in zip(tplan.tree_paths(values), tplan.tree_paths(restored)):
        assert pa == pb and a is b
    with pytest.raises(KeyError):
        tmt.splice_values(values, "no/such/leaf", leaf)


def test_metric_table_and_lp_match_jax_on_the_same_probes(qwen, monkeypatch):
    jcfg, jvalues, cfg, values = qwen
    jp, tp = _plans(jvalues, values)
    key = jax.random.PRNGKey(0)
    jh, th = _harnesses(jcfg, cfg)
    budget = int(0.6 * tp.total_bytes())
    with _jax_jitted_forward():
        weights = jcal.calibration_weights(
            jvalues, jcfg, eligible=tuple(t.path for t in jp.tensors))
    want = jmt.build_metric_table(jvalues, jp, jh, budget, key=key, weights=weights,
                                  max_probe_tiles=8, k_fractions=_KFR, include_int8=True)
    sample, signs = _jax_draws(jp, key, 8)

    def probe_on_jax_draws(values_, plan_, **kw):
        kw.pop("seed"), kw.pop("max_probe_tiles")
        return tprobe.probe_tensors_from(values_, plan_, sample=sample, signs=signs, **kw)

    monkeypatch.setattr(tmt, "probe_tensors", probe_on_jax_draws)
    got = tmt.build_metric_table(values, tp, th, budget, device="cpu", weights=weights,
                                 max_probe_tiles=8, k_fractions=_KFR, include_int8=True)
    assert got.exact_paths == want.exact_paths
    assert got.surrogate_skip_rate == want.surrogate_skip_rate
    assert got.harness_info == want.harness_info
    assert got.baseline.loss == pytest.approx(want.baseline.loss, rel=1e-5)
    assert got.alpha == pytest.approx(want.alpha, rel=1e-4)
    assert sorted(got.entries) == sorted(want.entries)
    for path, rows in want.entries.items():
        for a, b in zip(got.entries[path], rows, strict=True):
            assert {k: a[k] for k in ("tile_n", "tile_d", "K", "method", "bytes", "exact",
                                      "sample_fraction")} == \
                {k: b[k] for k in ("tile_n", "tile_d", "K", "method", "bytes", "exact",
                                   "sample_fraction")}
            assert a["resid2"] == pytest.approx(b["resid2"], rel=1e-5)
            # a delta is a difference of two f32 losses, over the sample fraction
            tol = 4 * 2.0 ** -23 * want.baseline.loss / b["sample_fraction"]
            assert a["delta"] == pytest.approx(b["delta"], rel=1e-3, abs=tol)
    assert set(got.to_dict()) == set(want.to_dict())
    # the exact allocator on the table's curves
    jprobes, tprobes = want.probes(), _to_port_probes(want.probes())
    lp_t, info_t = tlp.solve_mckp(tprobes, budget)
    lp_j, info_j = jlp.solve_mckp(jprobes, budget)
    assert info_t == info_j
    assert {k: dataclasses.astuple(v) for k, v in lp_t.items()} == \
        {k: dataclasses.astuple(v) for k, v in lp_j.items()}
    ja = jalloc.allocate_budget(jprobes, budget)
    assert tlp.cross_check_lp(tprobes, budget, _to_port_alloc(ja)) == \
        jlp.cross_check_lp(jprobes, budget, ja)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def test_autotuned_artifact_fits_beats_uniform_serves_and_cross_loads(qwen, jax_tuned,
                                                                        tmp_path):
    from repro.checkpoint import checkpointer as jckpt
    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch.compress import compress_model
    from repro_torch.serving import Engine

    jcfg, jvalues, cfg, values = qwen
    policy = tc.CompressionPolicy(**_POLICY)
    uniform = tc.plan_compression(values, policy)
    budget = uniform.total_bytes()                      # at equal bytes
    d = str(tmp_path / "auto")
    _, art = compress_model(cfg, policy, d, device="cpu", values=values, verbose=False,
                                budget_bytes=budget, engine="greedy", max_probe_tiles=None,
                                k_fractions=_KFR)
    result = compress_model.last_autotune
    assert art.total_bytes() <= budget and result.allocation.total_bytes <= budget
    assert art.manifest["autotune"] == result.plan.autotune
    _, uart = tc.execute_plan(uniform, values, device="cpu")
    d_auto = sum(_measured(art).values())
    assert d_auto < sum(_measured(uart).values())
    # probing every tile makes the prediction exact
    assert d_auto == pytest.approx(result.allocation.total_distortion, rel=1e-4)
    for path, e in art.manifest["tensors"].items():
        pt = result.allocation.choices[path]
        assert (e["tile_n"], e["tile_d"], e["K"]) == (pt.tile_n, pt.tile_d, pt.K)

    # the port's autotuned checkpoint serves fused and einsum alike
    prompts = torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(7), (2, 8), 0, cfg.vocab_size))).long()

    def serve(directory):
        a = tc.CompressionArtifact.load(directory)
        restored = checkpointer.restore(directory, 0, {"params": a.restore_template(values)},
                                        device="cpu")["params"]
        fused = Engine(cfg, restored, max_len=24, batch=2, artifact=a)
        einsum = Engine(cfg, restored, max_len=24, batch=2, artifact=a,
                        use_fused_bitlinear=False)
        assert fused.fused_bitlinear
        auto = a.manifest["autotune"]
        assert fused.compression["autotune"] == {
            "budget_bytes": auto["budget_bytes"], "engine": auto["engine"],
            "predicted_distortion": auto["predicted_distortion"],
            "calibrated": auto["calibrated"], "objective": auto["objective"]}
        out = fused.generate(prompts, 8)
        assert torch.equal(out, einsum.generate(prompts, 8)) and out.shape == (2, 16)
        return a

    a = serve(d)
    assert a.manifest["autotune"]["budget_bytes"] == budget
    # ... restores in JAX, and JAX's autotuned checkpoint serves in the port
    jart = jc.CompressionArtifact.load(d)
    jrest = jckpt.restore(d, 0, {"params": jart.restore_template(jvalues)})["params"]
    assert jart.validate_params(jrest) == []
    assert jart.manifest["autotune"] == art.manifest["autotune"]
    jbudget, jres, jd = jax_tuned
    ja = serve(jd)
    assert ja.manifest["autotune"] == jres.plan.autotune
    assert ja.total_bytes() <= jbudget


def test_compress_cli_budget_flag_checks(capsys):
    from repro_torch.launch.compress import main

    for argv, msg in (
        (["--engine", "qubo"], "only apply with --budget-mb"),
        (["--budget-mb", "1", "--calib-batch", "2"], "require --calibrate"),
        (["--budget-mb", "1", "--eval-seq", "8"], "require --objective eval-loss"),
        (["--budget-mb", "1", "--calibrate", "--calib-batches", "2", "--calib-seq", "8"],
         "mutually exclusive"),
    ):
        with pytest.raises(SystemExit) as e:
            main(["--arch", "qwen3-32b", "--reduced", *argv])
        assert e.value.code == 2
        assert msg in capsys.readouterr().err
