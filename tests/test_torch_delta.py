"""The port's delta recompression and artifact lineage against the JAX
package's, on the same numpy inputs (CPU): a parent written by JAX's
``execute_plan`` loads in the port, both packages agree on its fingerprint,
its drift masks and ratios, its lineage block, the cases that force a cold
start, and, with JAX's restart draws injected, the re-solved tiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.checkpoint import checkpointer as jckpt
from repro.compression import delta as jdelta
from repro.compression import execute as jexec
from repro.compression.artifact import CompressionArtifact as JArtifact
from repro.compression.plan import tree_paths as j_tree_paths
from repro_torch import bridge
from repro_torch import compression as tc
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.compression import delta as tdelta
from repro_torch.compression.artifact import CompressionArtifact as TArtifact
from repro_torch.compression.plan import tree_paths

torch.set_num_threads(1)

_POLICY = dict(tile_n=8, tile_d=32, rank_ratio=0.5, min_size=1)


def _np_tree(seed=0, rows=32, cols=64):
    rng = np.random.default_rng(seed)
    return {"blk/w": rng.standard_normal((rows, cols)).astype(np.float32),
            "mlp/w": rng.standard_normal((rows, 2 * cols)).astype(np.float32)}


def _jax(flat):
    out: dict = {}
    for path, a in flat.items():
        head, last = path.split("/")
        out.setdefault(head, {})[last] = jnp.asarray(a)
    return out


def _drifted(flat, band=slice(0, 8), seed=3):
    """``mlp/w`` with Gaussian noise of its own std on one band of rows."""
    out = dict(flat)
    W = flat["mlp/w"].copy()
    noise = np.random.default_rng(seed).standard_normal((band.stop - band.start, W.shape[1]))
    W[band] += (noise * W.std()).astype(np.float32)
    out["mlp/w"] = W
    return out


def _compress_jax(flat, method="alternating"):
    values = _jax(flat)
    plan = jc.plan_compression(values, jc.CompressionPolicy(method=method, **_POLICY))
    cv, art = jc.execute_plan(plan, values, key=jax.random.PRNGKey(0))
    return values, cv, art


def _compress_port(flat, method="alternating", seed=0):
    values = bridge.to_torch(flat, "cpu")
    plan = tc.plan_compression(values, tc.CompressionPolicy(method=method, **_POLICY))
    cv, art = tc.execute_plan(plan, values, seed=seed, device="cpu")
    return values, cv, art


def _to_port(jcv, jart, tmp_path):
    """JAX's compressed params and manifest, through JAX's checkpointer,
    restored by the port."""
    jckpt.save(str(tmp_path), 0, {"params": jcv})
    jart.save(str(tmp_path))
    art = TArtifact.load(str(tmp_path))
    template = art.restore_template(bridge.to_torch(_flat_np(_dense_of(jcv)), "cpu"))
    prev = tckpt.restore(str(tmp_path), 0, {"params": template}, device="cpu")["params"]
    return art, prev


def _dense_of(jcv):
    """A dense tree of the shapes a compressed JAX tree was made from."""
    out = {}
    for head, node in jcv.items():
        w = node["w"]
        r, c, tn, _ = w["m_packed"].shape
        td = w["C"].shape[-1]
        out[head] = {"w": jnp.zeros((r * tn, c * td), jnp.float32)}
    return out


def _flat_np(tree):
    return {p: np.asarray(v) for p, v in j_tree_paths(tree)}


def _jax_restart_signs(key, K, restarts, N):
    """The restart signs repro's greedy draws inside (decomposition.py:143)."""
    return jnp.stack([
        jnp.sign(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, k), 17),
                                   (restarts, N)))
        for k in range(K)
    ])


def _jax_signs(key):
    """``delta_recompress_from``'s ``signs``: every tile's restart signs from
    the per-tile keys JAX's delta hands it (``execute._tensor_keys``)."""
    def signs(t):
        keys = jexec._tensor_keys(key, t)
        return torch.from_numpy(np.array(
            jax.vmap(lambda k: _jax_restart_signs(k, t.K, 4, t.tile_n))(keys)))
    return signs


def _dist(manifest):
    return sum(float(np.sum(np.asarray(e["tile_resid"], np.float64) ** 2))
               for e in manifest["tensors"].values())


@pytest.fixture(scope="module")
def jax_parent():
    flat = _np_tree()
    values, cv, art = _compress_jax(flat)
    return flat, values, cv, art


def test_jax_artifact_and_checkpoint_load_in_port(jax_parent, tmp_path):
    flat, _, jcv, jart = jax_parent
    art, prev = _to_port(jcv, jart, tmp_path)
    assert art.validate_params(prev) == []
    for path, leaf in tree_paths(prev):
        assert leaf.numpy().tobytes() == np.asarray(_flat_np(jcv)[path]).tobytes(), path
    assert art.report == jart.report
    assert art.solver_batches() == jart.solver_batches()
    assert art.summary() == jart.summary()


@pytest.mark.parametrize("side", ["jax_manifest", "port_manifest"])
def test_both_packages_give_the_same_fingerprint(jax_parent, side):
    flat, _, _, jart = jax_parent
    manifest = jart.manifest if side == "jax_manifest" else _compress_port(flat)[2].manifest
    assert TArtifact(manifest).fingerprint() == JArtifact(manifest).fingerprint()
    # and the fingerprint is of the content: any change moves it
    changed = {**manifest, "solver_backend": "other"}
    assert TArtifact(changed).fingerprint() != TArtifact(manifest).fingerprint()


def test_from_plan_manifest_equals_jax(jax_parent):
    flat, jvalues, _, _ = jax_parent
    tvalues = bridge.to_torch(flat, "cpu")
    for method in ("alternating", "int8"):
        jp = jc.plan_compression(jvalues, jc.CompressionPolicy(method=method, **_POLICY))
        tp = tc.plan_compression(tvalues, tc.CompressionPolicy(method=method, **_POLICY))
        assert TArtifact.from_plan(tp).manifest == JArtifact.from_plan(jp).manifest


@pytest.mark.parametrize("threshold", [1.25, 0.5])
def test_plan_delta_masks_and_ratios_match_jax(jax_parent, tmp_path, threshold):
    flat, _, jcv, jart = jax_parent
    art, prev = _to_port(jcv, jart, tmp_path)
    drifted = _drifted(flat)
    jplan = jdelta.plan_delta(jart, jcv, _jax(drifted), threshold)
    tplan = tdelta.plan_delta(art, prev, bridge.to_torch(drifted, "cpu"), threshold,
                              device="cpu")
    assert tplan.parent_fingerprint == jplan.parent_fingerprint
    assert [d.path for d in tplan.drifts] == [d.path for d in jplan.drifts]
    for td_, jd in zip(tplan.drifts, jplan.drifts):
        assert td_.recorded and jd.recorded
        np.testing.assert_allclose(td_.ratio, jd.ratio, rtol=1e-6)
        np.testing.assert_array_equal(tplan.masks[td_.path], jplan.masks[jd.path])
    assert tplan.tiles_resolved == jplan.tiles_resolved
    assert tplan.summary() == jplan.summary()
    if threshold > 1:
        assert 0 < tplan.tiles_resolved < tplan.tiles_total


@pytest.mark.parametrize("method", ["greedy", "alternating"])
def test_delta_on_jax_draws_matches_jax(tmp_path, method):
    """With JAX's restart draws injected, a delta re-solves the same tiles
    to the same bits of M and C within 1e-5, and writes the same lineage."""
    flat = _np_tree()
    _, jcv, jart = _compress_jax(flat, method)
    art, prev = _to_port(jcv, jart, tmp_path)
    drifted = _drifted(flat)
    key = jax.random.PRNGKey(0)
    jcv2, jart2 = jc.delta_recompress(jart, jcv, _jax(drifted), key=key)
    tcv2, tart2 = tdelta.delta_recompress_from(
        art, prev, bridge.to_torch(drifted, "cpu"), signs=_jax_signs(key), device="cpu",
        backend=jart.manifest["solver_backend"],
    )
    jd, td_ = jart2.delta, tart2.delta
    assert 0 < td_["tiles_resolved"] < td_["tiles_total"]
    for k in ("parent_fingerprint", "generation", "threshold", "tiles_total",
              "tiles_resolved", "tiles_reused", "fraction_resolved", "tensors_touched"):
        assert td_[k] == jd[k], k
    assert td_["per_tensor"].keys() == jd["per_tensor"].keys()
    for path, e in td_["per_tensor"].items():
        assert (e["num_tiles"], e["resolved"]) == (jd["per_tensor"][path]["num_tiles"],
                                                   jd["per_tensor"][path]["resolved"])
        assert e["max_ratio"] == pytest.approx(jd["per_tensor"][path]["max_ratio"], rel=1e-6)
    jflat = _flat_np(jcv2)
    for path, leaf in tree_paths(tcv2):
        if path.endswith("m_packed"):
            assert leaf.numpy().tobytes() == jflat[path].tobytes(), path
        else:
            np.testing.assert_allclose(leaf.numpy(), jflat[path], rtol=1e-5, atol=1e-5)
    assert tart2.manifest["pools"] == jart2.manifest["pools"]
    for path, e in tart2.manifest["tensors"].items():
        je = jart2.manifest["tensors"][path]
        assert e["leaf_index"] == je["leaf_index"]
        np.testing.assert_allclose(e["tile_resid"], je["tile_resid"], rtol=1e-4, atol=1e-6)
    assert tart2.summary().splitlines()[:2] == jart2.summary().splitlines()[:2]


def _cold_start_case(case, flat, cv, art, pkg):
    """(artifact, prev, new) of one ``ColdStartRequired`` case of
    tests/test_delta.py, in the package ``pkg`` ("jax" or "port")."""
    if case == "predicted_only":
        if pkg == "jax":
            plan = jc.plan_compression(_jax(flat), jc.CompressionPolicy(**_POLICY))
            return JArtifact.from_plan(plan), cv, _jax(flat)
        values = bridge.to_torch(flat, "cpu")
        plan = tc.plan_compression(values, tc.CompressionPolicy(**_POLICY))
        return TArtifact.from_plan(plan), cv, values
    if case == "reshaped":
        new = {**flat, "mlp/w": np.zeros((16, 64), np.float32)}
        return art, cv, (_jax(new) if pkg == "jax" else bridge.to_torch(new, "cpu"))
    # dense where the manifest says compressed
    broken = dict(cv)
    broken["mlp"] = {"w": (_jax(flat) if pkg == "jax" else bridge.to_torch(flat, "cpu"))
                     ["mlp"]["w"]}
    return art, broken, (_jax(flat) if pkg == "jax" else bridge.to_torch(flat, "cpu"))


@pytest.mark.parametrize("case", ["predicted_only", "reshaped", "prev_fails_validation"])
def test_cold_start_required_in_both_packages(jax_parent, tmp_path, case):
    flat, _, jcv, jart = jax_parent
    art, prev = _to_port(jcv, jart, tmp_path)
    with pytest.raises(jdelta.ColdStartRequired):
        jc.delta_recompress(*_cold_start_case(case, flat, jcv, jart, "jax"))
    with pytest.raises(tdelta.ColdStartRequired):
        tc.delta_recompress(*_cold_start_case(case, flat, prev, art, "port"), device="cpu")


def test_int8_parent_requires_a_cold_start():
    flat = _np_tree()
    values, cv, art = _compress_port(flat, "int8")
    with pytest.raises(tdelta.ColdStartRequired, match="int8"):
        tc.delta_recompress(art, cv, values, device="cpu")


def test_unchanged_weights_reproduce_the_parent_byte_for_byte():
    flat = _np_tree()
    values, cv, art = _compress_port(flat)
    cv2, art2 = tc.delta_recompress(art, cv, values, device="cpu")
    d = art2.delta
    assert (d["tiles_resolved"], d["fraction_resolved"], d["tensors_touched"],
            d["generation"]) == (0, 0.0, 0, 1)
    assert d["parent_fingerprint"] == art.fingerprint()
    assert art2.manifest["tensors"] == art.manifest["tensors"]
    prev, new = dict(tree_paths(cv)), dict(tree_paths(cv2))
    assert prev.keys() == new.keys()
    for p in prev:
        assert torch.equal(prev[p], new[p]), p
    plan = tdelta.plan_delta(art, cv, values, device="cpu")
    for drift in plan.drifts:
        assert drift.recorded
        np.testing.assert_allclose(drift.ratio, 1.0, rtol=1e-4)
    # a second generation carries the count on
    _, art3 = tc.delta_recompress(art2, cv2, bridge.to_torch(_drifted(flat), "cpu"),
                                  device="cpu")
    assert art3.delta["generation"] == 2
    assert art3.delta["parent_fingerprint"] == art2.fingerprint()
    assert "delta gen 2 from" in art3.summary()


@pytest.mark.parametrize("method", ["alternating", "bbo"])
def test_drifted_delta_is_not_worse_than_cold(method):
    """Only the drifted band's tiles re-solve, every other tensor keeps the
    parent's bytes, and the total squared residual is no more than a cold
    ``execute_plan`` of the drifted weights'.  For BBO, every re-solved tile
    also ends no worse than the cold alternating start of its tile (its
    own draws), and the BBO launches start warm."""
    from repro_torch.core import ising

    flat = _np_tree()
    pol = dict(bbo_iters=4) if method == "bbo" else {}
    values = bridge.to_torch(flat, "cpu")
    plan = tc.plan_compression(values, tc.CompressionPolicy(method=method, **_POLICY, **pol))
    cv, art = tc.execute_plan(plan, values, seed=0, device="cpu")
    drifted = bridge.to_torch(_drifted(flat), "cpu")
    warm_calls = []
    solve = ising.solve_many_from

    def counting(*a, **k):
        warm_calls.append(k.get("init_state") is not None)
        return solve(*a, **k)

    ising.solve_many_from = counting
    try:
        cv2, art2 = tc.delta_recompress(art, cv, drifted, device="cpu")
    finally:
        ising.solve_many_from = solve
    d = art2.delta
    assert 0 < d["tiles_resolved"] < d["tiles_total"] and d["tensors_touched"] == 1
    assert art2.manifest["tensors"]["blk/w"] == art.manifest["tensors"]["blk/w"]
    assert torch.equal(cv2["blk"]["w"]["m_packed"], cv["blk"]["w"]["m_packed"])
    _, art_cold = tc.execute_plan(plan, drifted, seed=0, device="cpu")
    assert _dist(art2.manifest) <= _dist(art_cold.manifest) * (1 + 1e-6)
    if method == "bbo":
        pool = art2.manifest["pools"][0]
        assert warm_calls == [True] * pool["solver_calls"] and pool["warm_started"]
        from repro_torch.compression.execute import _tensor_signs, _tensor_tiles
        from repro_torch.core.compress import compress_tile_batch

        t = next(t for t in plan.tensors if t.path == "mlp/w")
        mask = np.nonzero(tdelta.plan_delta(art, cv, drifted, device="cpu").masks["mlp/w"])[0]
        tiles = _tensor_tiles(drifted["mlp"]["w"], t, "cpu")[mask]
        _, _, err_alt = compress_tile_batch(tiles, _tensor_signs(0, t, "cpu")[mask], t.K,
                                            "alternating")
        resid = np.asarray(art2.manifest["tensors"]["mlp/w"]["tile_resid"])[mask]
        norms = torch.linalg.vector_norm(tiles, dim=(-2, -1)).numpy()
        assert np.all(resid / norms <= err_alt.numpy() + 1e-5)
    else:
        assert warm_calls == []


def test_delta_against_a_streamed_parent_estimates_the_baseline(tmp_path):
    """A streamed manifest carries neither ``tile_resid`` nor ``leaf_index``:
    the drift baseline is estimated (as JAX estimates it, on JAX's streamed
    parent) and each tensor's leaf index comes from the new tree's order,
    which is what execute draws by."""
    from repro.compression import streaming as jstream

    flat = {**_np_tree(), "a_bias": np.ones((64,), np.float32)}
    jvalues = {**_jax({k: v for k, v in flat.items() if "/" in k}),
               "a_bias": jnp.ones((64,), jnp.float32)}
    jplan = jc.plan_compression(jvalues, jc.CompressionPolicy(**_POLICY))
    out = str(tmp_path / "streamed")
    jart, _ = jstream.execute_streaming(jstream.TreeLeafSource(jvalues), jplan, out,
                                        key=jax.random.PRNGKey(0))
    assert all("tile_resid" not in e and "leaf_index" not in e
               for e in jart.manifest["tensors"].values())
    tvalues = bridge.to_torch(flat, "cpu")
    art = TArtifact.load(out)
    prev = tckpt.restore(out, 0, {"params": art.restore_template(tvalues)},
                         device="cpu")["params"]
    jprev = jckpt.restore(out, 0, {"params": JArtifact(jart.manifest).restore_template(
        jvalues)})["params"]
    drifted = _drifted(flat)
    jdrift = {**_jax({k: v for k, v in drifted.items() if "/" in k}),
              "a_bias": jnp.ones((64,), jnp.float32)}
    threshold = 1.05   # the estimate's ratio cannot pass 1 / rel_err
    jp = jdelta.plan_delta(jart, jprev, jdrift, threshold)
    tp = tdelta.plan_delta(art, prev, bridge.to_torch(drifted, "cpu"), threshold,
                           device="cpu")
    for td_, jd in zip(tp.drifts, jp.drifts, strict=True):
        assert not td_.recorded and not jd.recorded
        np.testing.assert_allclose(td_.ratio, jd.ratio, rtol=1e-5)
        np.testing.assert_array_equal(tp.masks[td_.path], jp.masks[jd.path])
    assert "(estimated baseline)" in tp.summary()
    assert 0 < tp.tiles_resolved < tp.tiles_total
    _, art2 = tc.delta_recompress(art, prev, bridge.to_torch(drifted, "cpu"),
                                  threshold=threshold, device="cpu")
    order = {p: i for i, (p, _) in enumerate(tree_paths(bridge.to_torch(drifted, "cpu")))}
    touched = [p for p, e in art2.delta["per_tensor"].items() if e["resolved"]]
    assert touched == ["mlp/w"]
    assert art2.manifest["tensors"]["mlp/w"]["leaf_index"] == order["mlp/w"] == 2
    assert "tile_resid" not in art2.manifest["tensors"]["blk/w"]


def test_compress_params_wraps_plan_and_execute():
    """``compress_params`` is ``execute_plan`` of the config's one-rule
    policy; its report is the artifact's."""
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.core.compress import CompressionReport, compress_params
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    from repro_torch.configs.base import CompressionConfig

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    values, _ = split(init_model(cfg, seed=0, device="cpu"))
    ccfg = CompressionConfig(tile_n=16, tile_d=32, min_size=4096)
    new, report = compress_params(values, cfg, ccfg, seed=1, device="cpu")
    plan = tc.plan_compression(values, ccfg.to_policy())
    want, art = tc.execute_plan(plan, values, seed=1, device="cpu")
    assert isinstance(report, CompressionReport) and report == art.report
    assert report.compressed and report.total_ratio > 1
    for (p, a), (_, b) in zip(tree_paths(new), tree_paths(want), strict=True):
        assert torch.equal(a, b), p
