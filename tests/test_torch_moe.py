"""The port's MoE path (kernel K4's plain version, the grouped compressed
apply and its gradient, ``moe_block``, the forward, ``Engine.generate``,
plan/manifest/artifacts of expert stacks, and the chunking of greedy and
alternating pools) against the JAX package's, on the same numpy inputs;
float32 unless stated, reduced granite-moe-1b-a400m and
llama4-maverick-400b-a17b."""

import dataclasses
import functools

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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import forward as j_forward
from repro.models import init_model as j_init_model
from repro.models import moe as jmoe
from repro.models.params import split as j_split
from repro.serving.engine import Engine as JEngine
from repro_torch import bridge
from repro_torch import compression as tc
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.compression import execute as texec
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core import decomposition as tdec
from repro_torch.core import quantized as tq
from repro_torch.kernels import bitlinear as tbl
from repro_torch.kernels import ops as tops
from repro_torch.models import forward
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttransformer
from repro_torch.serving import Engine

torch.set_num_threads(1)

# stated tolerances: float32 on both sides, differing in summation order only
TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 2e-4          # as the dense forward test (tests/test_torch_models.py)
BF16_TOL = 2e-2           # of max|y|, as tests/test_torch_bitlinear.py
GRAD_TOL = 1e-4
B, P, STEPS = 3, 8, 8


@pytest.fixture(autouse=True)
def _no_hooks():
    yield
    tops.disable_kernels()
    jops.disable_kernels()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _carry(jtree):
    return bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jtree)}, "cpu")


def _grouped_weights(seed, E, nr, nc, tn, K, td):
    rng = np.random.default_rng(seed)
    M = np.where(rng.random((E, nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    mp = tdec.pack_bits(torch.from_numpy(M)).numpy()
    C = (rng.standard_normal((E, nr, nc, K, td)) * 0.2).astype(np.float32)
    return mp, C


# ---------------------------------------------------------------------------
# K4's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E", [1, 3])
@pytest.mark.parametrize("T", [1, 13, 20])
@pytest.mark.parametrize("K", [3, 4, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_grouped_bitlinear_matches_jax_kernel_and_ref(E, T, K, dtype):
    nr, nc, tn, td = 2, 2, 16, 32
    mp, C = _grouped_weights(E * 100 + T * 10 + K, E, nr, nc, tn, K, td)
    x = np.random.default_rng(T + K).standard_normal((E, T, nr * tn)).astype(np.float32)
    jd, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                        torch.bfloat16)
    # inputs rounded once to the working dtype, identical on both sides
    xj, Cj = jnp.asarray(x).astype(jd), jnp.asarray(C).astype(jd)
    xt = torch.from_numpy(np.asarray(xj, np.float32)).to(tdt)
    Ct = torch.from_numpy(np.asarray(Cj, np.float32)).to(tdt)
    yt = tbl.bitlinear_grouped(xt, torch.from_numpy(mp), Ct)
    assert yt.dtype == tdt and tuple(yt.shape) == (E, T, nc * td)
    yt = _np(yt)
    # the Pallas kernel picks its decode schedule at T = 1 and its grid
    # schedule at T = 13 and 20 (block_t 8)
    refs = [jref.bitlinear_grouped_ref(xj, jnp.asarray(mp), Cj),
            jops.bitlinear_grouped(xj, jnp.asarray(mp), Cj, block_t=8, interpret=True)]
    for yj in refs:
        yj = np.asarray(yj, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(yt - yj).max() <= BF16_TOL * np.abs(yj).max()
    assert tbl.bitlinear_grouped.launches == 0


def test_grouped_einsum_decompress_and_lead_dims_match_jax():
    """The (E, B, C, d) dispatch layout through the einsum form and the
    registered hook's adapter, and the per-expert decompress."""
    mp, C = _grouped_weights(7, 4, 2, 2, 16, 4, 16)
    x = np.random.default_rng(8).standard_normal((4, 3, 5, 32)).astype(np.float32)
    wj = {"m_packed": jnp.asarray(mp), "C": jnp.asarray(C)}
    wt = {"m_packed": torch.from_numpy(mp), "C": torch.from_numpy(C)}
    want = jq.apply_compressed_grouped_einsum(jnp.asarray(x), wj)
    _close(tq.apply_compressed(torch.from_numpy(x), wt), want)
    _close(tops.apply_compressed_grouped_fused(torch.from_numpy(x), wt), want)
    strided = torch.from_numpy(x).transpose(1, 2).contiguous().transpose(1, 2)
    _close(tops.apply_compressed_grouped_fused(strided, wt), want)
    _close(tq.decompress(wt), jq.decompress(wj), 1e-6)
    assert tq.compressed_num_bytes(wt) == jq.compressed_num_bytes(wj)
    assert tq.dense_num_bytes(wt) == jq.dense_num_bytes(wj)


@pytest.mark.parametrize("hook", [False, True])
def test_apply_compressed_grouped_and_gradient_match_jax_custom_vjp(hook):
    mp, C = _grouped_weights(3, 3, 2, 2, 8, 3, 16)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 2, 5, 16)).astype(np.float32)
    g = rng.standard_normal((3, 2, 5, 32)).astype(np.float32)

    jops.enable_kernels(interpret=True)
    assert jq.has_grouped_bitlinear()

    def loss(xx, cc):
        y = jq.apply_compressed(xx, {"m_packed": jnp.asarray(mp), "C": cc})
        return jnp.sum(y * jnp.asarray(g)), y

    (_, yj), (dxj, dCj) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(C))
    jops.disable_kernels()

    if hook:
        tops.enable_kernels()
        assert tq.has_grouped_bitlinear()
    xt = torch.from_numpy(x).requires_grad_()
    Ct = torch.from_numpy(C).requires_grad_()
    y = tq.apply_compressed(xt, {"m_packed": torch.from_numpy(mp), "C": Ct})
    (y * torch.from_numpy(g)).sum().backward()
    _close(y, yj, GRAD_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj), rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(Ct.grad.numpy(), np.asarray(dCj), rtol=GRAD_TOL, atol=GRAD_TOL)


def test_register_grouped_hook_refuses_none_and_clear_removes_it():
    with pytest.raises(ValueError, match="clear_bitlinear"):
        tq.register_bitlinear_grouped(None)
    tops.enable_kernels()
    assert tq.has_grouped_bitlinear() and tq.has_fused_bitlinear()
    tops.disable_kernels()
    assert not tq.has_grouped_bitlinear() and not tq.has_fused_bitlinear()


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), dtype="float32", **kw)
    tcfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype="float32", **kw)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_values(arch, seed):
    """JAX's float32 init of a reduced model (capacity_factor does not
    enter the weights)."""
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), dtype="float32")
    return j_split(j_init_model(jax.random.PRNGKey(seed), jcfg))[0]


def _moe_layer(arch, seed=0, **kw):
    """Layer 0's MoE parameters of a reduced model, both sides."""
    jcfg, tcfg = _cfgs(arch, **kw)
    jvals = _jax_values(arch, seed)
    idx = jcfg.block_pattern.index("attn_moe")
    jp = jax.tree.map(lambda a: a[0], jvals["groups"][f"{idx}"]["moe"])
    tp = ttransformer._index(_carry(jvals)["groups"][f"{idx}"]["moe"], 0)
    return jcfg, tcfg, jp, tp


# jitted: the same function, compiled once per shape instead of op by op
_j_moe_block = jax.jit(jmoe.moe_block, static_argnums=2)
_j_forward = jax.jit(j_forward, static_argnums=2)


def _check_moe(jcfg, tcfg, jp, tp, h, scaled=False):
    """out within TOL (of max|out| when ``scaled``: compressed expert stacks
    give outputs of ~50, where 1e-5 is below float32's resolution for a
    sum in another order) and aux within AUX_TOL."""
    jo, ja = _j_moe_block(jnp.asarray(h), jp, jcfg)
    to, ta = tmoe.moe_block(torch.from_numpy(h), tp, tcfg)
    tol = TOL * float(np.abs(np.asarray(jo)).max()) if scaled else TOL
    np.testing.assert_allclose(_np(to), _np(jo), rtol=TOL, atol=tol)
    assert abs(float(ta) - float(ja)) <= AUX_TOL
    return to


@pytest.mark.parametrize("cf", [None, 0.5])
@pytest.mark.parametrize("S", [8, 24])
def test_moe_block_matches_jax_granite(cf, S):
    """top-2 of 4 experts; cf 0.5 drops slots; S = 24 routes in blocks of 8."""
    kw = {} if cf is None else {"capacity_factor": cf}
    jcfg, tcfg, jp, tp = _moe_layer("granite-moe-1b-a400m", **kw)
    assert (tcfg.num_experts, tcfg.experts_per_token) == (4, 2)
    h = np.random.default_rng(S).standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    _check_moe(jcfg, tcfg, jp, tp, h)


def test_moe_block_matches_jax_in_bfloat16():
    """h and the expert stacks in bf16: dispatch and combine are cast to
    h's dtype before their einsums on both sides (the router stays f32);
    out within 2e-2 of max|out| (bf16 products summed in another order)."""
    jcfg, tcfg, jp, tp = _moe_layer("granite-moe-1b-a400m")
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in (jcfg, tcfg))
    jp = {k: v if k == "router" else v.astype(jnp.bfloat16) for k, v in jp.items()}
    tp = {k: v if k == "router" else v.to(torch.bfloat16) for k, v in tp.items()}
    h = np.random.default_rng(6).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    hj = jnp.asarray(h).astype(jnp.bfloat16)
    jo, ja = _j_moe_block(hj, jp, jcfg)
    to, ta = tmoe.moe_block(torch.from_numpy(np.asarray(hj, np.float32)).to(torch.bfloat16),
                            tp, tcfg)
    assert to.dtype == torch.bfloat16
    assert np.abs(_np(to) - _np(jo)).max() <= BF16_TOL * np.abs(_np(jo)).max()
    assert abs(float(ta) - float(ja)) <= AUX_TOL


def test_moe_block_matches_jax_llama4_shared_expert_top1():
    jcfg, tcfg, jp, tp = _moe_layer("llama4-maverick-400b-a17b", seed=1)
    assert tcfg.experts_per_token == 1 and "shared" in tp
    h = np.random.default_rng(5).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    _check_moe(jcfg, tcfg, jp, tp, h)


def test_moe_block_breaks_router_ties_as_lax_top_k():
    """Experts 1 and 2 get identical router columns, so every token's
    probabilities tie; a tight capacity makes the slot order (and so the
    drops) depend on which tied expert comes first."""
    jcfg, tcfg, jp, tp = _moe_layer("granite-moe-1b-a400m", capacity_factor=0.5)
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    h = np.random.default_rng(3).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    _check_moe(jcfg, tcfg, jp, tp, h)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"])
def test_init_tree_matches_jax_paths_shapes_dtypes(arch):
    from repro_torch.compression.plan import tree_paths
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    jcfg, tcfg = j_reduced(j_get_config(arch)), reduced_for_smoke(get_config(arch))
    jl = {p: (tuple(v.shape), str(v.dtype)) for p, v in
          j_tree_paths(j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0])}
    tl = {p: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for p, v in
          tree_paths(split(init_model(tcfg, seed=0, device="cpu"))[0])}
    assert list(tl) == list(jl) and tl == jl


def test_moe_capacity_truncates_as_jax():
    _, tcfg = _cfgs("granite-moe-1b-a400m")
    jcfg = j_reduced(j_get_config("granite-moe-1b-a400m"))
    for cf in (0.3, 0.5, 1.0, 1.25, 1.7, 2.0):
        for tokens in (1, 3, 7, 8, 24, 100, 1024):
            assert tmoe.moe_capacity(dataclasses.replace(tcfg, capacity_factor=cf), tokens) \
                == jmoe.moe_capacity(dataclasses.replace(jcfg, capacity_factor=cf), tokens)
    full = get_config("granite-moe-1b-a400m")
    assert tmoe.moe_capacity(full, 1024) == 320 and tmoe.moe_capacity(full, 1) == 1


def test_compressed_moe_block_with_and_without_k4_hook_matches_jax(granite):
    jcfg, tcfg = granite["jcfg"], granite["tcfg"]
    jp = jax.tree.map(lambda a: a[0], granite["jcv"]["groups"]["0"]["moe"])
    tp = ttransformer._index(granite["tcv"]["groups"]["0"]["moe"], 0)
    assert tq.is_grouped(tp["gate"]) and tp["gate"]["C"].ndim == 5
    h = np.random.default_rng(4).standard_normal((2, 8, tcfg.d_model)).astype(np.float32)
    plain = _check_moe(jcfg, tcfg, jp, tp, h, scaled=True)
    tops.enable_kernels()
    hooked = _check_moe(jcfg, tcfg, jp, tp, h, scaled=True)
    assert torch.equal(hooked, plain)       # K4's plain version is the einsum form in f32


# ---------------------------------------------------------------------------
# forward and Engine.generate
# ---------------------------------------------------------------------------

_POLICY = dict(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5, min_size=4096)


def _model(arch, seed):
    jcfg, tcfg = _cfgs(arch)
    jvals = _jax_values(arch, seed)
    plan = jc.plan_compression(jvals, jc.CompressionPolicy(**_POLICY))
    jcv, jart = jc.execute_plan(plan, jvals, key=jax.random.PRNGKey(0))
    return {"jcfg": jcfg, "tcfg": tcfg, "jvals": jvals, "tvals": _carry(jvals), "jcv": jcv,
            "tcv": _carry(jcv), "jart": jart, "plan": plan}


@pytest.fixture(scope="module")
def granite():
    return _model("granite-moe-1b-a400m", 0)


@pytest.fixture(scope="module")
def llama4():
    return _model("llama4-maverick-400b-a17b", 1)


def _tokens(cfg, b, s, seed=0):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("arch", ["granite", "llama4"])
@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_forward_logits_and_aux_match_jax(arch, compressed, hooks, request):
    m = request.getfixturevalue(arch)
    jv, tv = (m["jcv"], m["tcv"]) if compressed else (m["jvals"], m["tvals"])
    if compressed:
        assert any("/moe/" in p for p in m["jart"].manifest["tensors"])
    jt, tt = _tokens(m["tcfg"], 2, 8)
    jl, _, ja = _j_forward(jv, {"tokens": jt}, m["jcfg"])
    if hooks:
        tops.enable_kernels()        # K3, K4 and K5 adapters: their plain versions here
    tl, _, ta = forward(tv, {"tokens": tt}, m["tcfg"])
    _close(tl, jl, LOGIT_TOL)
    assert abs(float(ta) - float(ja)) <= AUX_TOL * m["tcfg"].num_layers


def _jax_tokens(m, compressed, fused, prompts):
    eng = JEngine(m["jcfg"], m["jcv"] if compressed else m["jvals"], max_len=P + STEPS,
                  batch=len(prompts), artifact=m["jart"] if compressed else None,
                  use_fused_bitlinear=fused)
    out = np.asarray(eng.generate(jnp.asarray(prompts, jnp.int32), STEPS))
    jops.disable_kernels()
    return out, eng


@pytest.mark.parametrize("compressed,fused", [(False, None), (True, None), (True, False)])
def test_generate_tokens_identical_to_jax_engine_granite(granite, compressed, fused,
                                                        monkeypatch):
    prompts = np.random.default_rng(0).integers(0, granite["tcfg"].vocab_size, (B, P))
    want, jeng = _jax_tokens(granite, compressed, fused, prompts)
    calls = []
    grouped = tops.apply_compressed_grouped_fused

    def counting(x, w):
        calls.append(tuple(x.shape))
        return grouped(x, w)

    # the adapter enable_kernels registers, which the Engine records
    monkeypatch.setattr(tops, "apply_compressed_grouped_fused", counting)
    eng = Engine(granite["tcfg"], granite["tcv"] if compressed else granite["tvals"],
                 max_len=P + STEPS, batch=B,
                 artifact=granite["jart"].manifest if compressed else None,
                 use_fused_bitlinear=fused)
    got = eng.generate(torch.from_numpy(prompts), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.fused_bitlinear == jeng.fused_bitlinear
    assert eng.compression == jeng.compression
    if compressed:
        assert eng.compression["grouped_tensors"] == 3
    # through the grouped hook: 3 stacks x layers x forwards, (E, B, C, d) each
    n_layers = granite["tcfg"].num_layers
    assert len(calls) == (3 * n_layers * STEPS if eng.fused_bitlinear else 0)
    assert all(len(s) == 4 for s in calls)


# ---------------------------------------------------------------------------
# plan, manifest and artifacts
# ---------------------------------------------------------------------------

def test_plan_json_byte_identical_and_manifest_group_dims(granite):
    tplan = tc.plan_compression(granite["tvals"], tc.CompressionPolicy(**_POLICY))
    assert tplan.to_json() == granite["plan"].to_json()
    _, tart = tc.execute_plan(tplan, granite["tvals"], seed=0, device="cpu")
    L, E = granite["tcfg"].num_layers, granite["tcfg"].num_experts
    experts = {p: e for p, e in tart.manifest["tensors"].items() if "/moe/" in p}
    assert {p.rsplit("/", 1)[1] for p in experts} == {"gate", "up", "down"}
    for p, e in experts.items():
        assert e["group_dims"] == [L, E] == granite["jart"].manifest["tensors"][p]["group_dims"]
        assert e["m_packed"] == granite["jart"].manifest["tensors"][p]["m_packed"]
        assert e["C"] == granite["jart"].manifest["tensors"][p]["C"]
    assert "groups/0/moe/router" in dict(tplan.skipped)


def test_artifacts_cross_load_both_ways(granite, tmp_path):
    from repro_torch.launch.compress import compress_model

    # the port's checkpoint restores and serves in repro
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tcv, tart = compress_model(granite["tcfg"], tc.CompressionPolicy(**_POLICY), tdir, seed=0,
                               device="cpu", values=granite["tvals"], verbose=False)
    art = jc.CompressionArtifact.load(tdir)
    jparams = jckpt.restore(tdir, 0, {"params": art.restore_template(granite["jvals"])})["params"]
    assert art.validate_params(jparams) == []
    toks = _tokens(granite["tcfg"], 2, 8, seed=6)
    jl, _, _ = _j_forward(jparams, {"tokens": toks[0]}, granite["jcfg"])
    tl, _, _ = forward(tcv, {"tokens": toks[1]}, granite["tcfg"])
    _close(tl, jl, LOGIT_TOL)
    # repro's checkpoint restores in the port through its manifest
    jckpt.save(jdir, 0, {"params": granite["jcv"]})
    granite["jart"].save(jdir)
    part = tc.CompressionArtifact.load(jdir)
    tmpl = part.restore_template(granite["tvals"])
    assert tuple(tmpl["groups"]["0"]["moe"]["gate"]["C"].shape)[:2] == (
        granite["tcfg"].num_layers, granite["tcfg"].num_experts)
    restored = tckpt.restore(jdir, 0, {"params": tmpl}, device="cpu")["params"]
    assert part.validate_params(restored) == []
    for path, leaf in bridge.to_numpy(restored).items():
        assert leaf.tobytes() == np.asarray(dict(j_tree_paths(granite["jcv"]))[path]).tobytes()


# ---------------------------------------------------------------------------
# greedy and alternating pools in chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["greedy", "alternating"])
def test_chunked_pool_gives_the_whole_pools_artifact(granite, method):
    policy = tc.CompressionPolicy(**dict(_POLICY, method=method))
    plan = tc.plan_compression(granite["tvals"], policy)
    whole, wart = tc.execute_plan(plan, granite["tvals"], seed=0, device="cpu",
                                  max_pool_tiles=None)
    cut, cart = tc.execute_plan(plan, granite["tvals"], seed=0, device="cpu",
                                max_pool_tiles=100)
    (wp,), (cp,) = wart.manifest["pools"], cart.manifest["pools"]
    assert wp["chunks"] == 1 and cp["chunks"] == -(-wp["num_tiles"] // 100) > 1
    assert wart.manifest["tensors"] == cart.manifest["tensors"]
    w, c = bridge.to_numpy(whole), bridge.to_numpy(cut)
    assert list(w) == list(c)
    for path in w:
        assert w[path].tobytes() == c[path].tobytes(), path


def test_auto_chunk_bounds_greedy_and_alternating_pools_on_cuda():
    """Decided from the device without running: the full-depth granite pool
    (313,344 tiles of 32x128, K = 4) is cut below cuSOLVER's batched-eigh
    limit on CUDA and left whole on the CPU; BBO and int8 are unchanged."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    total = 24 * (768 + 3 * 4096)
    assert total == 313344
    for method in ("greedy", "alternating"):
        chunk = texec.auto_chunk(total, method, 32, 4, 0, cuda)
        assert chunk <= texec.EIGH_MAX_BATCH and -(-total // chunk) == -(
            -total // texec.EIGH_MAX_BATCH)
        assert texec.auto_chunk(total, method, 32, 4, 0, cpu) == total
        assert texec.auto_chunk(100, method, 32, 4, 0, cuda) == 100
    assert texec.auto_chunk(total, "int8", 32, 4, 0, cuda) == total
    for dev in (cuda, cpu):
        assert texec.auto_chunk(total, "bbo", 8, 3, 32, dev) == texec.auto_pool_chunk(
            total, 8, 3, 32)
