"""The port's compression pipeline against the JAX package's, on a reduced
qwen3-32b tree carried across: plan JSON, execute, artifacts both ways."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.checkpoint import checkpointer as jckpt
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.core import quantized as jq
from repro.models import init_model as j_init_model
from repro.models.params import split as j_split
from repro_torch import bridge
from repro_torch import compression as tc
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core import quantized as tq
from repro_torch.launch.compress import compress_model
from repro_torch.models import init_model
from repro_torch.models.params import split

torch.set_num_threads(1)

# tile_d=32 and min_size=1024 so the reduced widths (d_model 64) compress,
# as the repo's reduced smokes lower them
_POLICY = dict(method="alternating", tile_d=32, min_size=1024, bbo_iters=4)
_RULE = dict(pattern=r"attn/w[kv]", method="bbo", rank_ratio=0.375)


def _policies():
    return (
        jc.CompressionPolicy(**_POLICY, rules=(jc.CompressionRule(**_RULE),)),
        tc.CompressionPolicy(**_POLICY, rules=(tc.CompressionRule(**_RULE),)),
    )


def _jax_values(dtype="float32"):
    cfg = dataclasses.replace(j_reduced(j_get_config("qwen3-32b")), dtype=dtype)
    return j_split(j_init_model(jax.random.PRNGKey(0), cfg))[0]


def _carry(jvalues):
    return bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jvalues)}, "cpu")


@pytest.fixture(scope="module")
def jax_run():
    jvalues = _jax_values()
    jpolicy, _ = _policies()
    plan = jc.plan_compression(jvalues, jpolicy)
    jcv, jart = jc.execute_plan(plan, jvalues, key=jax.random.PRNGKey(0))
    return jvalues, plan, jcv, jart


def test_port_config_and_init_tree_match_repro():
    assert dataclasses.asdict(get_config("qwen3-32b")) == dataclasses.asdict(
        j_get_config("qwen3-32b"))
    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    tvalues, _ = split(init_model(cfg, seed=0, device="cpu"))
    jl = {p: (tuple(v.shape), str(v.dtype)) for p, v in j_tree_paths(_jax_values())}
    tl = {p: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
          for p, v in tc.tree_paths(tvalues)}
    assert list(tl) == list(jl) and tl == jl


def test_bridge_round_trip_bit_identical():
    jvalues = _jax_values("bfloat16")
    flat = {p: np.asarray(v) for p, v in j_tree_paths(jvalues)}
    back = bridge.to_numpy(bridge.to_torch(flat, "cpu"))
    assert list(back) == list(flat)
    for p in flat:
        assert back[p].dtype == flat[p].dtype and back[p].tobytes() == flat[p].tobytes()


def test_plan_json_byte_identical(jax_run):
    jvalues, jplan, _, _ = jax_run
    _, tpolicy = _policies()
    tplan = tc.plan_compression(_carry(jvalues), tpolicy)
    assert tplan.to_json() == jplan.to_json()
    assert tc.CompressionPlan.from_json(tplan.to_json()) == tplan


def test_execute_rel_err_within_5pct_and_artifacts_cross_load(jax_run, tmp_path):
    jvalues, _, _, jart = jax_run
    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    _, tpolicy = _policies()
    tvalues = _carry(jvalues)
    tcv, tart = compress_model(cfg, tpolicy, str(tmp_path), seed=0, device="cpu",
                               values=tvalues, verbose=False)
    jt, tt = jart.manifest["tensors"], tart.manifest["tensors"]
    assert list(jt) == list(tt)
    for path in jt:
        for k in ("K", "tile_n", "tile_d", "method", "new_bytes", "m_packed", "C"):
            assert jt[path][k] == tt[path][k], (path, k)
        assert abs(tt[path]["rel_err"] - jt[path]["rel_err"]) <= 0.05 * jt[path]["rel_err"]
    assert [p["chunks"] for p in tart.manifest["pools"]] == [
        p["chunks"] for p in jart.manifest["pools"]]
    assert tart.validate_params(tcv) == []

    # the port's artifact restores and serves in repro
    art = jc.CompressionArtifact.load(str(tmp_path))
    restored = jckpt.restore(str(tmp_path), 0, {"params": art.restore_template(jvalues)})
    jparams = restored["params"]
    assert art.validate_params(jparams) == []
    rng = np.random.default_rng(0)
    for path in tt:
        node_j, node_t = jparams, tcv
        for k in path.split("/"):
            node_j, node_t = node_j[k], node_t[k]
        wj = {k: v[0] for k, v in node_j.items()}           # layer slice 0
        wt = {k: v[0] for k, v in node_t.items()}
        d_in = wt["m_packed"].shape[0] * wt["m_packed"].shape[2]
        x = rng.standard_normal((3, d_in)).astype(np.float32)
        yj = jq.apply_compressed_einsum(jnp.asarray(x), wj)
        yt = tq.apply_compressed(torch.from_numpy(x), wt)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-4, atol=1e-4)


def test_repro_artifact_with_bf16_leaves_loads_and_serves_in_port(tmp_path):
    jvalues = _jax_values("bfloat16")
    jpolicy, _ = _policies()
    jpolicy = dataclasses.replace(jpolicy, rules=(), targets=(r"mlp/up/w$",))
    jcv, jart = jc.execute_plan(jc.plan_compression(jvalues, jpolicy), jvalues,
                                key=jax.random.PRNGKey(1))
    jckpt.save(str(tmp_path), 0, {"params": jcv})
    jart.save(str(tmp_path))

    art = tc.CompressionArtifact.load(str(tmp_path))
    template = art.restore_template(_carry(jvalues))
    params = tckpt.restore(str(tmp_path), 0, {"params": template}, device="cpu")["params"]
    assert art.validate_params(params) == []
    C = params["groups"]["0"]["mlp"]["up"]["w"]["C"]
    assert C.dtype == torch.bfloat16
    jC = np.asarray(jcv["groups"]["0"]["mlp"]["up"]["w"]["C"])
    assert C.view(torch.int16).numpy().tobytes() == jC.view(np.int16).tobytes()
    x = np.random.default_rng(3).standard_normal((2, 64)).astype(np.float32)
    wj = {k: v[0] for k, v in jcv["groups"]["0"]["mlp"]["up"]["w"].items()}
    wt = {k: v[0] for k, v in params["groups"]["0"]["mlp"]["up"]["w"].items()}
    yj = np.asarray(jq.apply_compressed_einsum(jnp.asarray(x, jnp.bfloat16), wj), np.float32)
    yt = tq.apply_compressed(torch.from_numpy(x).to(torch.bfloat16), wt).float().numpy()
    assert np.abs(yt - yj).max() <= 2e-2 * np.abs(yj).max()


def test_int8_pool_matches_jax_exactly():
    jvalues = _jax_values()
    kw = dict(method="int8", tile_d=32, min_size=1024, targets=(r"mlp/(up|down)/w$",))
    jcv, jart = jc.execute_plan(jc.plan_compression(jvalues, jc.CompressionPolicy(**kw)),
                                jvalues, key=jax.random.PRNGKey(0))
    tvalues = _carry(jvalues)
    tcv, tart = tc.execute_plan(tc.plan_compression(tvalues, tc.CompressionPolicy(**kw)),
                                tvalues, device="cpu")
    for path, e in jart.manifest["tensors"].items():
        te = tart.manifest["tensors"][path]
        assert (te["new_bytes"], te["q"], te["scale"]) == (e["new_bytes"], e["q"], e["scale"])
        np.testing.assert_allclose(te["rel_err"], e["rel_err"], rtol=1e-5)
        node_j, node_t = jcv, tcv
        for k in path.split("/"):
            node_j, node_t = node_j[k], node_t[k]
        np.testing.assert_array_equal(node_t["q"].numpy(), np.asarray(node_j["q"]))


# the launch CLI's reduced smoke policy: tile 16 x 32, min_size 4096 leave
# tensors dense for every reason the planner knows (embed, norms, small,
# indivisible)
_SKIP_POLICY = dict(method="greedy", tile_n=16, tile_d=32, min_size=4096)


@pytest.fixture(scope="module")
def skip_plans():
    jvalues = _jax_values()
    jplan = jc.plan_compression(jvalues, jc.CompressionPolicy(**_SKIP_POLICY))
    tplan = tc.plan_compression(_carry(jvalues), tc.CompressionPolicy(**_SKIP_POLICY))
    return jplan, tplan


def test_plan_summary_with_skips_matches_jax(skip_plans):
    jplan, tplan = skip_plans
    assert tplan.summary().splitlines() == jplan.summary().splitlines()
    assert tplan.summary().splitlines()[1] == (
        "  skips: excluded (embed) x1, excluded (norm) x4, below min_size x2, "
        "indivisible dims (64, 257) x1")
    assert tplan.skip_summary() == jplan.skip_summary()
    assert tplan.total_bytes() == jplan.total_bytes() == tplan.total_pred_bytes
    assert tplan.compression_ratio == jplan.compression_ratio


@pytest.mark.parametrize("block", [
    {"engine": "greedy", "budget_bytes": 3 << 20, "predicted_bytes": 2 << 20,
     "predicted_distortion": 0.0125, "calibrated": True},
    {"engine": "lagrange"},   # a partial block prints its defaults
])
def test_plan_summary_autotune_line_matches_jax(skip_plans, block):
    jplan, tplan = skip_plans
    jplan = dataclasses.replace(jplan, autotune=block)
    tplan = dataclasses.replace(tplan, autotune=block)
    assert tplan.summary() == jplan.summary()
    assert tplan.summary().splitlines()[2].startswith(f"  autotune[{block['engine']}]: budget ")


def test_plan_diff_and_rule_skips_match_jax(skip_plans):
    jplan, tplan = skip_plans
    assert tplan.diff(tplan) == jplan.diff(jplan) == []
    # drop one tensor, change another's K, add a rule skip: the same report
    def edit(plan):
        t = plan.tensors
        return dataclasses.replace(
            plan, tensors=(dataclasses.replace(t[0], K=t[0].K + 1),) + t[2:],
            skipped=plan.skipped + (("a/b", "rule 'a/.*' -> skip"), ("c/d", "rule 'c' -> skip")))
    jother, tother = edit(jplan), edit(tplan)
    assert tplan.diff(tother) == jplan.diff(jother)
    assert tother.diff(tplan) == jother.diff(jplan)
    assert [d[0] for d in tplan.diff(tother)] == ["~", "-"]
    assert tother.skip_summary() == jother.skip_summary()
    assert tother.skip_summary()["rule -> skip"] == 2
    assert tother.summary() == jother.summary()
