"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the same numpy inputs and weights carried
across with ``repro_torch.bridge``; float32 unless stated, reduced widths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.models import ssm as jssm
from repro.models.params import split as j_split
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.models import ssm as tssm
from repro_torch.models.params import split

torch.set_num_threads(1)

# float32 on both sides, differing only in summation order
TOL = 1e-5
# bf16 on both sides, of max|out|: each side rounds each op to bf16 (XLA may
# also keep a fused intermediate in f32), a few units of 2^-8 through the
# block's casts, norm and two projections
BF16_TOL = 2e-2


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(_np(t), _np(j), rtol=tol, atol=tol)


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(j_reduced(j_get_config("zamba2-1.2b")), dtype=dtype)
    tcfg = dataclasses.replace(reduced_for_smoke(get_config("zamba2-1.2b")), dtype=dtype)
    return jcfg, tcfg


def _params(jcfg, jdtype):
    jp = j_split(jssm.init_ssm(jax.random.PRNGKey(3), jcfg, jdtype))[0]
    tp = bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jp)}, "cpu")
    return jp, tp


def _pair(a, dtype=np.float32):
    """The same numpy array as a jnp and a torch tensor."""
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# the causal conv and the SSD
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,with_state", [(10, False), (10, True), (1, True), (2, False),
                                          (2, True)])
def test_causal_conv_matches_jax(S, with_state):
    """With and without a carried window, and S < dconv - 1 (the new window
    then keeps part of the old one)."""
    rng = np.random.default_rng(S * 2 + with_state)
    B, ch, dconv = 2, 12, 4
    jx, tx = _pair(rng.standard_normal((B, S, ch)))
    jw, tw = _pair(rng.standard_normal((dconv, ch)) * 0.3)
    jb, tb = _pair(rng.standard_normal(ch) * 0.1)
    js_, ts_ = _pair(rng.standard_normal((B, dconv - 1, ch))) if with_state else (None, None)
    jy, jst = jssm._causal_conv(jx, jw, jb, js_)
    ty, tst = tssm._causal_conv(tx, tw, tb, ts_)
    _close(ty, jy)
    _close(tst, jst)
    assert tuple(tst.shape) == (B, dconv - 1, ch)


def _ssd_inputs(seed, B=2, S=48, nh=4, hp=8, ds=16, g=2, s0=True):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, nh, hp)) * 0.5
    dA = -np.abs(rng.standard_normal((B, S, nh))) * 0.3
    Bm = rng.standard_normal((B, S, g, ds)) * 0.3
    Cm = rng.standard_normal((B, S, g, ds)) * 0.3
    S0 = rng.standard_normal((B, nh, hp, ds)) * 0.2 if s0 else np.zeros((B, nh, hp, ds))
    return [_pair(a) for a in (u, dA, Bm, Cm, S0)]


def test_ssd_chunk_matches_jax():
    (ju, tu), (jdA, tdA), (jB, tB), (jC, tC), (jS, tS) = _ssd_inputs(0, S=16)
    jcum, tcum = jnp.cumsum(jdA, axis=1), torch.cumsum(tdA, dim=1)
    jy, jS1 = jssm._ssd_chunk(ju, jcum, jB, jC, jS, 2)
    ty, tS1 = tssm._ssd_chunk(tu, tcum, tB, tC, tS, 2)
    _close(ty, jy)
    _close(tS1, jS1)


@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 16), (16, 16), (7, 16)])
@pytest.mark.parametrize("unroll", [False, True])
def test_ssd_matches_jax_over_several_chunks_from_a_nonzero_state(S, chunk, unroll):
    (ju, tu), (jdA, tdA), (jB, tB), (jC, tC), (jS, tS) = _ssd_inputs(S + chunk, S=S)
    c = min(chunk, S)
    jy, jSf = jssm._ssd(ju, jdA, jB, jC, c, jS, unroll)
    ty, tSf = tssm._ssd(tu, tdA, tB, tC, c, tS)
    _close(ty, jy)
    _close(tSf, jSf)


def test_ssd_matches_the_naive_recurrence():
    """As tests/test_models.py::test_ssd_chunked_matches_naive_recurrence:
    the chunked SSD is the per-step recurrence, in float64 numpy."""
    B, S, nh, hp, ds, g = 2, 32, 4, 8, 16, 1
    (_, u), (_, dA), (_, Bm), (_, Cm), (_, S0) = _ssd_inputs(7, B, S, nh, hp, ds, g, s0=False)
    y_chunk, Sf = tssm._ssd(u, dA, Bm, Cm, 8, S0)
    a = np.exp(dA.numpy().astype(np.float64))
    state = np.zeros((B, nh, hp, ds), np.float64)
    un = u.numpy().astype(np.float64)
    Bn = np.repeat(Bm.numpy().astype(np.float64), nh // g, axis=2)
    Cn = np.repeat(Cm.numpy().astype(np.float64), nh // g, axis=2)
    ys = []
    for t in range(S):
        state = state * a[:, t][:, :, None, None] + np.einsum("bhn,bhp->bhpn", Bn[:, t],
                                                               un[:, t])
        ys.append(np.einsum("bhn,bhpn->bhp", Cn[:, t], state))
    np.testing.assert_allclose(y_chunk.numpy(), np.stack(ys, axis=1), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(Sf.numpy(), state, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("S", [37, 40])
def test_both_packages_refuse_the_lengths_the_chunk_rule_cannot_split(S):
    """nc = max(S // chunk, 1) chunks of L = S // nc steps: S = 40 at chunk 16
    is 2 x 20, S = 37 would be 2 x 18 = 36 and is refused by both (JAX by
    its reshape, the port by name)."""
    (ju, tu), (jdA, tdA), (jB, tB), (jC, tC), (jS, tS) = _ssd_inputs(S, S=S)
    if S == 40:
        jy, _ = jssm._ssd(ju, jdA, jB, jC, 16, jS, False)
        ty, _ = tssm._ssd(tu, tdA, tB, tC, 16, tS)
        _close(ty, jy)
        return
    with pytest.raises(TypeError, match="reshape"):
        jssm._ssd(ju, jdA, jB, jC, 16, jS, False)
    with pytest.raises(ValueError, match="nc = max"):
        tssm._ssd(tu, tdA, tB, tC, 16, tS)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------

def test_init_ssm_has_the_reference_tree():
    jcfg, tcfg = _cfgs()
    jp, _ = _params(jcfg, jnp.float32)
    own = tssm.init_ssm(torch.Generator().manual_seed(0), tcfg, torch.float32)
    want = {p: (np.asarray(v).shape, np.asarray(v).dtype) for p, v in j_tree_paths(jp)}
    got = {p: (v.shape, v.dtype) for p, v in bridge.to_numpy(split(own)[0]).items()}
    assert got == want
    cache = tssm.init_ssm_cache(tcfg, 3, torch.float32, "cpu")
    jcache = jssm.init_ssm_cache(jcfg, 3, jnp.float32)
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in
                                                             jcache.items()}
    assert cache["state"].dtype == torch.float32


def test_ssm_block_prefill_then_decode_matches_jax():
    """Prefill without a cache; prefill into a cache, then decode steps that
    carry the state the prefill wrote in place: outputs and caches."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg, jnp.float32)
    B, S = 2, 40
    rng = np.random.default_rng(11)
    jh, th = _pair(rng.standard_normal((B, S, tcfg.d_model)))
    jo, jnc = jssm.ssm_block(jh, jp, jcfg)
    to, tnc = tssm.ssm_block(th, tp, tcfg)
    assert jnc is None and tnc is None
    _close(to, jo)

    jcache = jssm.init_ssm_cache(jcfg, B, jnp.float32)
    tcache = tssm.init_ssm_cache(tcfg, B, torch.float32, "cpu")
    jo, jcache = jssm.ssm_block(jh, jp, jcfg, cache=jcache)
    to, tcache2 = tssm.ssm_block(th, tp, tcfg, cache=tcache)
    assert tcache2 is tcache            # written in place
    _close(to, jo)
    for k in ("conv", "state"):
        _close(tcache[k], jcache[k])
    for t in range(4):
        jh1, th1 = _pair(rng.standard_normal((B, 1, tcfg.d_model)))
        jo, jcache = jssm.ssm_block(jh1, jp, jcfg, cache=jcache)
        to, tcache = tssm.ssm_block(th1, tp, tcfg, cache=tcache)
        _close(to, jo)
        for k in ("conv", "state"):
            _close(tcache[k], jcache[k])
    # a chunk continuing from the carried state (S > 1 with a cache)
    jh2, th2 = _pair(rng.standard_normal((B, 5, tcfg.d_model)))
    jo, jcache = jssm.ssm_block(jh2, jp, jcfg, cache=jcache)
    to, tcache = tssm.ssm_block(th2, tp, tcfg, cache=tcache)
    _close(to, jo)
    _close(tcache["state"], jcache["state"])


def test_ssm_block_in_bf16_matches_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    jp, tp = _params(jcfg, jnp.bfloat16)
    assert tp["in_proj"]["w"].dtype == torch.bfloat16 and tp["A_log"].dtype == torch.float32
    rng = np.random.default_rng(12)
    h = rng.standard_normal((2, 32, tcfg.d_model)).astype(np.float32)
    jh, th = jnp.asarray(h, jnp.bfloat16), torch.from_numpy(h).bfloat16()
    jcache = jssm.init_ssm_cache(jcfg, 2, jnp.bfloat16)
    tcache = tssm.init_ssm_cache(tcfg, 2, torch.bfloat16, "cpu")
    jo, jcache = jssm.ssm_block(jh, jp, jcfg, cache=jcache)
    to, tcache = tssm.ssm_block(th, tp, tcfg, cache=tcache)
    assert to.dtype == torch.bfloat16 and tcache["state"].dtype == torch.float32
    scale = float(np.abs(_np(jo)).max())
    assert float(np.abs(_np(to) - _np(jo)).max()) <= BF16_TOL * scale
    jh1, th1 = jh[:, :1], th[:, :1]
    jo, _ = jssm.ssm_block(jh1, jp, jcfg, cache=jcache)
    to, _ = tssm.ssm_block(th1, tp, tcfg, cache=tcache)
    assert float(np.abs(_np(to) - _np(jo)).max()) <= BF16_TOL * float(np.abs(_np(jo)).max())
