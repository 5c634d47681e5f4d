"""The port's optimisers, schedules, int8 error feedback and compression
cycle against the JAX package's, on the same numpy inputs (CPU).

Tolerances: both packages compute the updates in float32 with the same
casts, but XLA may fuse a multiply-add where PyTorch rounds twice, so f32
results agree within a few units in the last place: 1e-6 relative to the
tensor's largest magnitude (and bf16 parameters within one bf16 unit, 2^-8
of it, where one f32 rounding can tip the cast).  int8 codes are equal."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro import optim as jopt
from repro.optim import grad_compress as jgc
from repro_torch import compression as tc
from repro_torch import optim as topt
from repro_torch.optim import grad_compress as tgc

torch.set_num_threads(1)

F32_TOL = 1e-6
BF16_TOL = 2.0 ** -8


def _tree(seed=0):
    """Leaves covering adafactor's factored (both trailing dims >= 128) and
    full branches, a stacked 3-D leaf, a vector and a bf16 matrix."""
    rng = np.random.default_rng(seed)
    return {
        "big": {"w": rng.standard_normal((128, 160)).astype(np.float32)},
        "stack": rng.standard_normal((3, 130, 128)).astype(np.float32),
        "thin": {"w": rng.standard_normal((128, 64)).astype(np.float32)},
        "vec": rng.standard_normal((40,)).astype(np.float32),
        "half": rng.standard_normal((16, 24)).astype(np.float32).astype(ml_dtypes.bfloat16),
    }


def _map(fn, tree):
    return {k: _map(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def _to_torch(tree):
    def one(a):
        a = np.asarray(a)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return _map(one, tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k in sorted(tree) for p, v in _flat(tree[k], f"{prefix}/{k}").items()}
    return {prefix: tree}


def _close(t, j, label):
    """A port tensor against a JAX array within the dtype's tolerance of
    the reference's largest magnitude."""
    jf = np.asarray(jnp.asarray(j, jnp.float32))
    tf = t.detach().to(torch.float32).numpy()
    assert tf.shape == jf.shape, label
    tol = (BF16_TOL if t.dtype == torch.bfloat16 else F32_TOL) * max(np.abs(jf).max(), 1e-30)
    err = np.abs(tf - jf).max() if jf.size else 0.0
    assert err <= tol, f"{label}: {err:.3g} > {tol:.3g}"


def _close_trees(t_tree, j_tree, label):
    ft, fj = _flat(t_tree), _flat(j_tree)
    assert ft.keys() == fj.keys(), label
    for p in ft:
        _close(ft[p], fj[p], f"{label}{p}")


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_steps_match_jax(name):
    """Three updates from the same params with the same gradients: params,
    every moment and the reported gradient norm agree.  Adafactor's tree
    holds factored and full second moments (the rule is checked)."""
    params = _tree(0)
    make_j, make_t = getattr(jopt, name), getattr(topt, name)
    j, t = make_j(), make_t()
    jp = _map(jnp.asarray, params)
    jstate = j.init(jp)
    tp = _to_torch(params)
    tstate = t.init(tp)
    if name == "adafactor":
        assert set(tstate["big"]["w"]) == {"vr", "vc"} and set(tstate["stack"]) == {"vr", "vc"}
        assert set(tstate["thin"]["w"]) == {"v"} and set(tstate["half"]) == {"v"}
    _close_trees(tstate, jstate, "init")
    for step in range(3):
        grads = _map(lambda a: (a.astype(np.float32) * 0.5 + step).astype(a.dtype),
                     _tree(10 + step))
        lr = jopt.warmup_cosine(1e-2, 1, 5)(jnp.asarray(step))
        jp, jstate, jn = j.update(_map(jnp.asarray, grads), jstate, jp, jnp.asarray(step), lr)
        tp, tstate, tn = t.update(_to_torch(grads), tstate, tp, torch.tensor(step),
                                  torch.tensor(np.asarray(lr)))
        _close_trees(tp, jp, f"{name} step {step} params")
        _close_trees(tstate, jstate, f"{name} step {step} state")
        _close(tn, jn, f"{name} step {step} grad norm")


def test_adamw_updates_in_place():
    """The port writes the new params and moments into the given tensors."""
    t = topt.adamw()
    p = _to_torch(_tree(1))
    s = t.init(p)
    ids = [id(x) for x in _flat(p).values()] + [id(x) for x in _flat(s).values()]
    before = _flat(p)["/vec"].clone()
    p2, s2, _ = t.update(_to_torch(_tree(2)), s, p, torch.tensor(0), torch.tensor(1e-2))
    assert [id(x) for x in _flat(p2).values()] + [id(x) for x in _flat(s2).values()] == ids
    assert not torch.equal(_flat(p)["/vec"], before)


def test_global_norm_and_clip_match_jax():
    g = _tree(3)
    _close(topt.global_norm(_to_torch(g)), jopt.global_norm(_map(jnp.asarray, g)), "norm")
    for max_norm in (1.0, 1e4):
        tc_, tn = topt.clip_by_global_norm(_to_torch(g), max_norm)
        jc_, jn = jopt.clip_by_global_norm(_map(jnp.asarray, g), max_norm)
        _close_trees(tc_, jc_, f"clip {max_norm} ")
        _close(tn, jn, "clip norm")


def test_schedules_match_jax():
    for peak, warmup, total in ((1e-3, 2, 6), (3e-4, 20, 100), (1.0, 0, 10)):
        js = jopt.warmup_cosine(peak, warmup, total)
        ts = topt.warmup_cosine(peak, warmup, total)
        for step in range(total + 3):
            got = ts(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.ndim == 0
            _close(got, js(jnp.asarray(step, jnp.int32)), f"warmup_cosine step {step}")
            _close(ts(step), js(jnp.asarray(step)), f"warmup_cosine int step {step}")
    got = topt.constant(2e-4)(torch.tensor(7))
    assert got.dtype == torch.float32 and float(got) == float(jopt.constant(2e-4)(jnp.asarray(7)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_int8_quantisation_equals_jax(seed):
    x = np.random.default_rng(seed).standard_normal((33, 17)).astype(np.float32) * (seed + 1)
    tq, ts = tgc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    assert np.array_equal(tgc.dequantize_int8(tq, ts).numpy(),
                          np.asarray(jgc.dequantize_int8(jq, js)))


def test_error_feedback_equals_jax():
    """Two rounds of error feedback: the int8 codes and scales equal JAX's,
    the residuals within f32 rounding."""
    grads = [_map(lambda a: a.astype(np.float32), _tree(s)) for s in (4, 5)]
    tres = tgc.ef_residual_zeros(_to_torch(grads[0]))
    jres = jgc.ef_residual_zeros(_map(jnp.asarray, grads[0]))
    for g in grads:
        tq, tres = tgc.ef_compress(_to_torch(g), tres)
        jq, jres = jgc.ef_compress(_map(jnp.asarray, g), jres)
        for p, (q, s) in _flat(tq).items():
            jqq, jss = _jq(jq, p)
            assert np.array_equal(q.numpy(), np.asarray(jqq)), p
            assert float(s) == float(jss), p
        _close_trees(tres, jres, "residual")


def _jq(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


# -- the compression cycle (mirrors tests/test_delta.py's cycle tests) -------

def _values(seed=0, rows=32, cols=64):
    rng = np.random.default_rng(seed)
    return {"blk": {"w": torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))},
            "mlp": {"w": torch.from_numpy(
                rng.standard_normal((rows, 2 * cols)).astype(np.float32))}}


def _policy():
    return tc.CompressionPolicy(method="alternating", tile_n=8, tile_d=32, rank_ratio=0.5,
                                min_size=1)


def test_compression_cycle_schedules_and_goes_delta():
    values = _values()
    cycle = tgc.CompressionCycle(_policy(), every=2, device="cpu")
    assert cycle.maybe_recompress(1, values) is None          # off-schedule
    _, art1 = cycle.maybe_recompress(2, values)
    assert art1.delta is None                                 # first firing: cold
    assert cycle.maybe_recompress(2, values)[1] is art1       # no refire
    drifted = {"blk": {"w": values["blk"]["w"] + 0.05}, "mlp": values["mlp"]}
    _, art2 = cycle.maybe_recompress(4, drifted)
    assert art2.delta is not None                             # second: delta
    assert art2.delta["parent_fingerprint"] == art1.fingerprint()
    assert art2.delta["generation"] == 1
    with pytest.raises(ValueError):
        tgc.CompressionCycle(_policy(), every=0, device="cpu")


def test_compression_cycle_order_and_manifest_match_jax():
    """The same schedule through both packages: cold at the first firing,
    then a delta naming it; the same tensors and tile geometry."""
    rng = np.random.default_rng(7)
    flat = {"blk": rng.standard_normal((32, 64)).astype(np.float32),
            "mlp": rng.standard_normal((32, 128)).astype(np.float32)}
    jv = {k: {"w": jnp.asarray(v)} for k, v in flat.items()}
    tv = {k: {"w": torch.from_numpy(v.copy())} for k, v in flat.items()}
    jcyc = jgc.CompressionCycle(jc.CompressionPolicy(method="alternating", tile_n=8, tile_d=32,
                                                     rank_ratio=0.5, min_size=1), every=3)
    tcyc = tgc.CompressionCycle(_policy(), every=3, device="cpu")
    fired = []
    for step in range(1, 7):
        j_out, t_out = jcyc.maybe_recompress(step, jv), tcyc.maybe_recompress(step, tv)
        assert (j_out is None) == (t_out is None)
        if t_out is None:
            continue
        fired.append(step)
        ja, ta = j_out[1], t_out[1]
        assert (ja.delta is None) == (ta.delta is None)
        keys = ("shape", "tile_n", "tile_d", "K", "method", "num_tiles")
        assert {p: {k: e[k] for k in keys} for p, e in ta.manifest["tensors"].items()} == \
            {p: {k: e[k] for k in keys} for p, e in ja.manifest["tensors"].items()}
    assert fired == [3, 6]
    assert tcyc.artifact.delta["generation"] == jcyc.artifact.delta["generation"] == 1


def test_compression_cycle_cold_fallback_on_anchor_loss():
    values = _values()
    cycle = tgc.CompressionCycle(_policy(), every=1, device="cpu")
    cycle.maybe_recompress(1, values)
    reshaped = {"blk": {"w": torch.randn(16, 96, generator=torch.Generator().manual_seed(9))}}
    _, art = cycle.maybe_recompress(2, reshaped)
    assert art.delta is None                                  # fell back to cold
    assert "blk/w" in art.manifest["tensors"]


def test_compression_cycle_keeps_its_pair_under_in_place_updates():
    """The port's optimisers update in place: the pair a firing keeps must
    not change when the trainer later writes into ``values``."""
    values = _values()
    values["bias"] = torch.zeros(4)                           # not compressed
    cycle = tgc.CompressionCycle(_policy(), every=1, device="cpu")
    cv, _ = cycle.maybe_recompress(1, values)
    kept = cv["bias"].clone()
    values["bias"].add_(1.0)
    values["blk"]["w"].mul_(2.0)
    assert torch.equal(cycle.compressed["bias"], kept)
