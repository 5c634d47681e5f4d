"""The port's model forward (layers, attention in every cache mode, the
transformer) against the JAX package's on the same weights, carried across
with ``repro_torch.bridge``; float32, reduced configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.models import attention as jattn
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import layers as jlayers
from repro.models.params import split as j_split
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core import quantized as tq
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn
from repro_torch.models import forward, init_cache, init_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer
from repro_torch.models.params import split as t_split

torch.set_num_threads(1)

# stated tolerances: float32 on both sides, differing only in summation order
TOL = 1e-5
LOGIT_TOL = 2e-4      # as tests/test_serving_fused.py holds JAX's kernels on vs off


@pytest.fixture(autouse=True)
def _no_port_hooks():
    yield
    tops.disable_kernels()


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), dtype="float32", **kw)
    tcfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype="float32", **kw)
    return jcfg, tcfg


def _carry(jtree):
    return bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jtree)}, "cpu")


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def qwen():
    jcfg, tcfg = _cfgs("qwen3-32b")
    jvals = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0]
    return jcfg, tcfg, jvals, _carry(jvals)


@pytest.fixture(scope="module")
def qwen_compressed(qwen):
    jcfg, tcfg, jvals, _ = qwen
    policy = jc.CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                                  min_size=4096)
    jcv, jart = jc.execute_plan(jc.plan_compression(jvals, policy), jvals,
                                key=jax.random.PRNGKey(0))
    return jcv, _carry(jcv), jart


def _slice0(jtree, ttree):
    """Layer 0 of the stacked group tree on both sides."""
    return (jax.tree.map(lambda a: a[0], jtree),
            ttransformer._index(ttree, 0))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_head_rms_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    _close(tlayers.rms_norm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)}, 1e-6),
           jlayers.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-6))
    _close(tattn._head_rms(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           jattn._head_rms(jnp.asarray(x), jnp.asarray(scale), 1e-5))
    pos = np.array([3, 4, 5, 6, 7])
    _close(tattn._rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jattn._rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
    pos2 = np.array([[0, 1, 2, 3, 4], [9, 10, 11, 12, 13]])        # per-row positions
    _close(tattn._rope(torch.from_numpy(x), torch.from_numpy(pos2), 1e4),
           jattn._rope(jnp.asarray(x), jnp.asarray(pos2), 1e4))


def test_mlp_and_apply_dense_dense_and_compressed_match_jax(qwen, qwen_compressed):
    _, _, jvals, tvals = qwen
    jcv, tcv, _ = qwen_compressed
    x = np.random.default_rng(1).standard_normal((2, 3, 64)).astype(np.float32)
    for jtree, ttree in ((jvals, tvals), (jcv, tcv)):
        jl, tl = _slice0(jtree["groups"]["0"], ttree["groups"]["0"])
        _close(tlayers.mlp(torch.from_numpy(x), tl["mlp"]), jlayers.mlp(jnp.asarray(x), jl["mlp"]))
        _close(tlayers.apply_dense(torch.from_numpy(x), tl["attn"]["wq"]),
               jlayers.apply_dense(jnp.asarray(x), jl["attn"]["wq"]))
    assert "m_packed" in tcv["groups"]["0"]["mlp"]["up"]["w"]     # compressed leaves served
    tops.enable_kernels()      # the fused hook (the CPU plain version) gives the same
    jl, tl = _slice0(jcv["groups"]["0"], tcv["groups"]["0"])
    _close(tlayers.mlp(torch.from_numpy(x), tl["mlp"]), jlayers.mlp(jnp.asarray(x), jl["mlp"]))


def test_apply_dense_refuses_int8_weights():
    """int8 ``{q, scale}`` weights are served by dequant-einsum as in JAX's
    ``apply_dense``; a grouped int8 stack whose expert axis does not match
    x's is refused."""
    rng = np.random.default_rng(5)
    q = rng.integers(-127, 128, (2, 2, 4, 8)).astype(np.int8)
    scale = (rng.random((2, 2, 1, 1)) * 0.1).astype(np.float32)
    x = rng.standard_normal((3, 8)).astype(np.float32)
    _close(tlayers.apply_dense(torch.from_numpy(x), {"w": {"q": torch.from_numpy(q),
                                                          "scale": torch.from_numpy(scale)}}),
           jlayers.apply_dense(jnp.asarray(x), {"w": {"q": jnp.asarray(q),
                                                      "scale": jnp.asarray(scale)}}))
    grouped = {"q": torch.zeros(2, 1, 1, 4, 4, dtype=torch.int8),
               "scale": torch.ones(2, 1, 1, 1, 1)}
    with pytest.raises(ValueError, match="grouped intquant"):
        tq.apply_intquant(torch.zeros(3, 1, 4), grouped)


# ---------------------------------------------------------------------------
# attention modes
# ---------------------------------------------------------------------------

def _attn_params(qwen):
    jcfg, tcfg, jvals, tvals = qwen
    jl, tl = _slice0(jvals["groups"]["0"], tvals["groups"]["0"])
    return jcfg, tcfg, jl["attn"], tl["attn"]


def _h(seed, B, S, d=64):
    h = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)
    return jnp.asarray(h), torch.from_numpy(h)


def _caches(jcfg, tcfg, B, L):
    return (jattn.init_kv_cache(jcfg, B, L, jnp.float32),
            tattn.init_kv_cache(tcfg, B, L, torch.float32, "cpu"))


_j_attention = jax.jit(jattn.attention, static_argnames=("cfg", "q_chunk", "attend_cache"))


def _both(jcfg, tcfg, jp, tp, jh, th, jc_, tc_, tol=TOL, **kw):
    jo, jnc = _j_attention(jh, jp, jcfg, cache=jc_, **{
        k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in kw.items()})
    to, tnc = tattn.attention(th, tp, tcfg, cache=tc_, **kw)
    _close(to, jo, tol)
    if jnc is not None:
        _close(tnc["k"], jnc["k"], tol)
        _close(tnc["v"], jnc["v"], tol)
    return jnc, tnc


def test_attention_prefill_without_and_with_cache_then_decode(qwen):
    jcfg, tcfg, jp, tp = _attn_params(qwen)
    B, S, L = 3, 10, 16
    jh, th = _h(0, B, S)
    _both(jcfg, tcfg, jp, tp, jh, th, None, None, q_chunk=4)      # no cache, plain loop
    jc_, tc_ = _caches(jcfg, tcfg, B, L)
    jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh, th, jc_, tc_)       # prefill writes the cache
    for t in range(3):                                            # decode at a scalar pos
        jh1, th1 = _h(10 + t, B, 1)
        jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh1, th1, jc_, tc_, pos_offset=S + t)


def test_attention_decode_at_per_row_positions(qwen):
    jcfg, tcfg, jp, tp = _attn_params(qwen)
    B, S, L = 3, 8, 16
    jh, th = _h(1, B, S)
    jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh, th, *_caches(jcfg, tcfg, B, L))
    pos = torch.tensor([8, 5, 7])
    for t in range(2):
        jh1, th1 = _h(20 + t, B, 1)
        jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh1, th1, jc_, tc_, pos_offset=pos + t)


def test_attention_chunked_prefill_attends_to_the_cache(qwen):
    jcfg, tcfg, jp, tp = _attn_params(qwen)
    B, L = 2, 16
    jh, th = _h(2, B, 12)
    jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh[:, :5], th[:, :5], *_caches(jcfg, tcfg, B, L))
    jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh[:, 5:], th[:, 5:], jc_, tc_, pos_offset=5,
                     attend_cache=True)
    # the chunked prefill gives the one-shot prefill's cache
    jfull, _ = _both(jcfg, tcfg, jp, tp, jh, th, *_caches(jcfg, tcfg, B, L))
    _close(tc_["k"], jfull["k"])


def test_attention_ring_cache_of_a_sliding_window_layer(qwen):
    _, _, jvals, tvals = qwen
    jcfg, tcfg = _cfgs("qwen3-32b", sliding_window=8)
    jl, tl = _slice0(jvals["groups"]["0"], tvals["groups"]["0"])
    jp, tp = jl["attn"], tl["attn"]
    B = 2
    jh, th = _h(3, B, 12)
    # prefill longer than the window rolls the last 8 tokens into the ring
    jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh, th, *_caches(jcfg, tcfg, B, 8))
    for t in range(3):
        jh1, th1 = _h(30 + t, B, 1)
        jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh1, th1, jc_, tc_, pos_offset=12 + t)
    # a short prefill, then decode wrapping around the ring
    jh, th = _h(4, B, 5)
    jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh, th, *_caches(jcfg, tcfg, B, 8))
    for t in range(5):
        jh1, th1 = _h(40 + t, B, 1)
        jc_, tc_ = _both(jcfg, tcfg, jp, tp, jh1, th1, jc_, tc_, pos_offset=5 + t)
    # per-row decode positions on the ring
    jh1, th1 = _h(50, B, 1)
    _both(jcfg, tcfg, jp, tp, jh1, th1, jc_, tc_, pos_offset=torch.tensor([10, 9]))


# ---------------------------------------------------------------------------
# the transformer forward
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed=0):
    t = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))
    return jnp.asarray(t, jnp.int32), torch.from_numpy(t)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_forward_matches_jax_dense_and_compressed(qwen, qwen_compressed, compressed, hooks):
    jcfg, tcfg, jvals, tvals = qwen
    if compressed:
        jvals, tvals, _ = qwen_compressed
    jt, tt = _tokens(tcfg, 2, 8)
    jl, _, _ = j_forward(jvals, {"tokens": jt}, jcfg)
    if hooks:
        tops.enable_kernels()       # K5 and K3 adapters; their plain versions on the CPU
    tl, tc_, aux = forward(tvals, {"tokens": tt}, tcfg)
    assert tc_ is None and float(aux) == 0.0
    _close(tl, jl, LOGIT_TOL)
    jl, _, _ = j_forward(jvals, {"tokens": jt}, jcfg, last_only=True)
    tl, _, _ = forward(tvals, {"tokens": tt}, tcfg, last_only=True)
    _close(tl, jl, LOGIT_TOL)
    jh, _, _ = j_forward(jvals, {"tokens": jt}, jcfg, return_hidden=True)
    th, _, _ = forward(tvals, {"tokens": tt}, tcfg, return_hidden=True)
    _close(th, jh, LOGIT_TOL)


def test_forward_parallel_block_tied_embeddings_and_softcap():
    """command-r-plus: parallel attention + MLP and a tied head; with a
    logits softcap set on both sides."""
    jcfg, tcfg = _cfgs("command-r-plus-104b", logits_softcap=5.0)
    assert tcfg.parallel_block and tcfg.tie_embeddings
    jvals = j_split(j_init_model(jax.random.PRNGKey(1), jcfg))[0]
    tvals = _carry(jvals)
    assert "head" not in tvals
    jt, tt = _tokens(tcfg, 2, 8, seed=1)
    jl, _, _ = j_forward(jvals, {"tokens": jt}, jcfg)
    tl, _, _ = forward(tvals, {"tokens": tt}, tcfg)
    _close(tl, jl, LOGIT_TOL)
    assert float(tl.abs().max()) <= 5.0


@pytest.mark.parametrize("stacked", [True, False])
def test_cached_prefill_and_decode_match_jax_in_both_cache_forms(qwen, stacked):
    jcfg, tcfg, jvals, tvals = qwen
    B, P, L = 2, 6, 10
    jt, tt = _tokens(tcfg, B, P + 3, seed=2)
    jcache = j_init_cache(jcfg, B, L, stacked=stacked)
    tcache = init_cache(tcfg, B, L, stacked=stacked, device="cpu")
    assert isinstance(tcache["groups"], list) == (not stacked)
    jl, jcache, _ = j_forward(jvals, {"tokens": jt[:, :P]}, jcfg, cache=jcache,
                              unroll_groups=not stacked)
    tl, tcache, _ = forward(tvals, {"tokens": tt[:, :P]}, tcfg, cache=tcache)
    _close(tl, jl, LOGIT_TOL)
    for t in range(3):
        jl, jcache, _ = j_forward(jvals, {"tokens": jt[:, P + t:P + t + 1]}, jcfg,
                                  cache=jcache, pos_offset=P + t, unroll_groups=not stacked)
        tl, tcache, _ = forward(tvals, {"tokens": tt[:, P + t:P + t + 1]}, tcfg, cache=tcache,
                                pos_offset=P + t)
        _close(tl, jl, LOGIT_TOL)
    jleaves = dict(j_tree_paths(jcache))
    for path, leaf in bridge.to_numpy(tcache).items():
        np.testing.assert_allclose(leaf, np.asarray(jleaves[path]), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_both_cache_forms_give_the_same_logits(qwen):
    _, tcfg, _, tvals = qwen
    _, tt = _tokens(tcfg, 2, 7, seed=3)
    outs = []
    for stacked in (True, False):
        cache = init_cache(tcfg, 2, 8, stacked=stacked, device="cpu")
        l1, cache, _ = forward(tvals, {"tokens": tt[:, :6]}, tcfg, cache=cache)
        l2, cache, _ = forward(tvals, {"tokens": tt[:, 6:]}, tcfg, cache=cache, pos_offset=6)
        outs.append((l1, l2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# SSM and hybrid models: mamba2-130m, and zamba2-1.2b's SSM groups with the
# shared attention block (14 layers: two groups of six and a remainder of two)
# ---------------------------------------------------------------------------

HYBRIDS = {"zamba2-1.2b": {"num_layers": 14}, "mamba2-130m": {}}


@pytest.fixture(scope="module", params=sorted(HYBRIDS))
def hybrid(request):
    arch = request.param
    jcfg, tcfg = _cfgs(arch, **HYBRIDS[arch])
    jvals = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0]
    policy = jc.CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                                  min_size=4096)
    jcv, _ = jc.execute_plan(jc.plan_compression(jvals, policy), jvals,
                             key=jax.random.PRNGKey(0))
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "jvals": jvals, "tvals": _carry(jvals),
            "jcv": jcv, "tcv": _carry(jcv)}


def test_hybrid_parameter_tree_matches_jax(hybrid):
    """The port's own init has JAX's paths, shapes and dtypes, so the
    policies pick the same tensors in both packages.  Its size is JAX's
    tree's, which is ``cfg.param_count()`` less the final norm's second d
    and plus each SSM layer's conv bias (the analytic count leaves it out)."""
    tcfg = hybrid["tcfg"]
    own = bridge.to_numpy(t_split(init_model(tcfg, seed=0, device="cpu"))[0])
    want = dict(j_tree_paths(hybrid["jvals"]))
    assert {p: (v.shape, v.dtype) for p, v in own.items()} == {
        p: (np.asarray(v).shape, np.asarray(v).dtype) for p, v in want.items()}
    n_ssm = sum(k in ("ssm", "ssm_attn") for k in
                tcfg.block_pattern * tcfg.num_groups + tcfg.remainder_pattern)
    conv_dim = tcfg.d_inner + 2 * tcfg.ssm_ngroups * tcfg.ssm_state
    real = sum(v.size for v in own.values())
    assert real == sum(np.asarray(v).size for v in want.values())
    assert real == tcfg.param_count() - tcfg.d_model + n_ssm * conv_dim
    assert ("shared/attn/wq/w" in own) == tcfg.shared_attn


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("hooks", [False, True])
def test_hybrid_forward_matches_jax_dense_and_compressed(hybrid, compressed, hooks):
    jcfg, tcfg = hybrid["jcfg"], hybrid["tcfg"]
    jvals, tvals = ((hybrid["jcv"], hybrid["tcv"]) if compressed
                    else (hybrid["jvals"], hybrid["tvals"]))
    if compressed:      # in_proj (d_out 296 = 8 x 37) tiles at td = 37
        w = tvals["groups"]["0"]["ssm"]["in_proj"]["w"]
        assert w["C"].shape[-1] == 37
    jt, tt = _tokens(tcfg, 2, 40, seed=4)
    jl, _, _ = j_forward(jvals, {"tokens": jt}, jcfg)
    if hooks:
        tops.enable_kernels()
    tl, tc_, aux = forward(tvals, {"tokens": tt}, tcfg)
    assert tc_ is None and float(aux) == 0.0
    _close(tl, jl, LOGIT_TOL)
    jl, _, _ = j_forward(jvals, {"tokens": jt}, jcfg, last_only=True)
    tl, _, _ = forward(tvals, {"tokens": tt}, tcfg, last_only=True)
    _close(tl, jl, LOGIT_TOL)


@pytest.mark.parametrize("stacked", [True, False])
def test_hybrid_cached_prefill_and_decode_match_jax_in_both_cache_forms(hybrid, stacked):
    """A 40-token prefill (past zamba2's reduced window of 32: the shared
    block's cache is a 32-slot ring) into both cache forms, then decode
    steps.  The SSM state the prefill wrote in place must carry into every
    step, and the caches must end equal to JAX's."""
    jcfg, tcfg, jvals, tvals = (hybrid[k] for k in ("jcfg", "tcfg", "jcv", "tcv"))
    B, P, L = 2, 40, 46
    jt, tt = _tokens(tcfg, B, P + 4, seed=5)
    jcache = j_init_cache(jcfg, B, L, stacked=stacked)
    tcache = init_cache(tcfg, B, L, stacked=stacked, device="cpu")
    if tcfg.shared_attn:                 # the ssm_attn block's kv cache: a ring
        kv = tcache["groups"]["5"]["kv"] if stacked else tcache["groups"][0]["5"]["kv"]
        assert kv["k"].shape[-3] == tcfg.sliding_window == 32
    jl, jcache, _ = j_forward(jvals, {"tokens": jt[:, :P]}, jcfg, cache=jcache,
                              unroll_groups=not stacked)
    tl, tcache, _ = forward(tvals, {"tokens": tt[:, :P]}, tcfg, cache=tcache)
    _close(tl, jl, LOGIT_TOL)
    for t in range(4):
        jl, jcache, _ = j_forward(jvals, {"tokens": jt[:, P + t:P + t + 1]}, jcfg,
                                  cache=jcache, pos_offset=P + t, unroll_groups=not stacked)
        tl, tcache, _ = forward(tvals, {"tokens": tt[:, P + t:P + t + 1]}, tcfg, cache=tcache,
                                pos_offset=P + t)
        _close(tl, jl, LOGIT_TOL)
    jleaves = dict(j_tree_paths(jcache))
    tleaves = bridge.to_numpy(tcache)
    assert set(tleaves) == set(jleaves)
    for path, leaf in tleaves.items():
        np.testing.assert_allclose(leaf, np.asarray(jleaves[path]), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)


def test_hybrid_prefill_refuses_a_length_the_ssd_chunks_cannot_split(hybrid):
    """37 tokens at the reduced chunk of 16 (2 chunks of 18 = 36): JAX's
    reshape refuses it, and so does the port, by name."""
    jcfg, tcfg = hybrid["jcfg"], hybrid["tcfg"]
    jt, tt = _tokens(tcfg, 1, 37, seed=6)
    with pytest.raises(TypeError, match="reshape"):
        j_forward(hybrid["jvals"], {"tokens": jt}, jcfg)
    with pytest.raises(ValueError, match="nc = max"):
        forward(hybrid["tvals"], {"tokens": tt}, tcfg)
