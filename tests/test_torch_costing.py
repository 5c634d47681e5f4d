"""The port's costing against the JAX package's, on the CPU at small size:
the attention costing twin on the same numpy inputs (f32, within 2e-4),
``forward(unroll=True)`` against ``forward(unroll=False)``, the dot FLOPs
the port's counter sees against the ``dot_general`` FLOPs of JAX's jaxpr of
the same program, and ``cost_cell``'s composition against a whole-step
trace of the same cell on a fake (2, 2) mesh (in a subprocess, so that no
test worker keeps a process group)."""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.models import attention as j_attn
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models import train_loss as j_train_loss
from repro.models.params import split as j_split
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.launch.costing import counting
from repro_torch.models import attention as attn
from repro_torch.models import forward, init_cache, init_model, train_loss
from repro_torch.models.params import split

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWIN_TOL = 2e-4

ARCHS = ("qwen3-32b", "granite-moe-1b-a400m", "mamba2-130m", "zamba2-1.2b")
B, S = 2, 32


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("window", [0, 40])
def test_twin_matches_jax(skip, window, monkeypatch):
    """``_chunked_attention_unrolled`` on the same numpy q, k, v as JAX's
    twin, every block pair or the causal triangle from the twin's bound."""
    rng = np.random.default_rng(0)
    Bq, Sq, KV, rep, hd, qc = 2, 96, 2, 3, 16, 32
    q = rng.standard_normal((Bq, Sq, KV, rep, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Sq, KV, hd)).astype(np.float32)
    monkeypatch.setattr(j_attn, "CAUSAL_SKIP_UNROLL", skip)
    monkeypatch.setattr(attn, "CAUSAL_SKIP_UNROLL", skip)
    want = np.asarray(j_attn._chunked_attention_unrolled(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window, qc))
    got = attn._chunked_attention_unrolled(torch.from_numpy(q), torch.from_numpy(k),
                                           torch.from_numpy(v), window, qc).numpy()
    np.testing.assert_allclose(got, want, rtol=TWIN_TOL, atol=TWIN_TOL)
    # and the production loop's result, which visits every pair
    prod = attn._chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), window, qc).numpy()
    np.testing.assert_allclose(got, prod, rtol=TWIN_TOL, atol=TWIN_TOL)


@pytest.mark.parametrize("arch", ["qwen3-32b", "mamba2-130m", "zamba2-1.2b"])
def test_unroll_twin_equals_production(arch):
    """The port's ``forward(unroll=True)`` equals ``forward(unroll=False)``
    (tests/test_models.py's check of the JAX twin)."""
    cfg = reduced_for_smoke(get_config(arch))
    params, _ = split(init_model(cfg, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(0))
    a = forward(params, {"tokens": tokens}, cfg)[0]
    b = forward(params, {"tokens": tokens}, cfg, unroll=True)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dot FLOPs: the port's counter against JAX's jaxpr
# ---------------------------------------------------------------------------

def _dot_flops(jaxpr) -> int:
    """Sum of ``dot_general`` FLOPs (2 x every multiply-add) in a jaxpr,
    recursing into sub-jaxprs (pjit, remat, custom_jvp/vjp) and multiplying
    ``scan`` bodies by their length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            lhs, rhs = (v.aval.shape for v in eqn.invars)
            free = [d for i, d in enumerate(rhs) if i not in rc and i not in rb]
            lfree = [d for i, d in enumerate(lhs) if i not in lc and i not in lb]
            if math.prod(lhs[i] for i in lc) == 1 or math.prod(free) * math.prod(lfree) == 1:
                continue        # an elementwise product or row-wise inner product
            total += 2 * math.prod(lhs) * math.prod(free)
            continue
        if eqn.primitive.name in ("while", "cond"):
            raise AssertionError(f"{eqn.primitive.name}: trip counts unknown to the walker")
        mult = eqn.params["length"] if eqn.primitive.name == "scan" else 1
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += mult * _dot_flops(inner)
    return total


def _jax_program(arch, kind, remat=True):
    cfg = dataclasses.replace(j_reduced(j_get_config(arch)), remat=remat)
    params = jax.eval_shape(lambda: j_split(j_init_model(jax.random.PRNGKey(0), cfg))[0])
    tokens = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        fn = jax.value_and_grad(lambda p, t: j_train_loss(p, {"tokens": t}, cfg, unroll=True)[0])
        return jax.make_jaxpr(fn)(params, tokens)
    if kind == "forward":
        return jax.make_jaxpr(lambda p, t: j_forward(p, {"tokens": t}, cfg, unroll=True))(
            params, tokens)
    cache = jax.eval_shape(lambda: j_init_cache(cfg, B, S + 1))
    if kind == "prefill":
        fn = lambda p, t, c: j_forward(p, {"tokens": t}, cfg, cache=c, pos_offset=0,  # noqa: E731
                                       last_only=True, unroll=True)
        return jax.make_jaxpr(fn)(params, tokens, cache)
    fn = lambda p, t, c: j_forward(p, {"tokens": t[:, :1]}, cfg, cache=c,  # noqa: E731
                                   pos_offset=S, unroll=True)
    return jax.make_jaxpr(fn)(params, tokens, cache)


def _port_dot_flops(arch, kind, remat=True):
    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), remat=remat)
    params, _ = split(init_model(cfg, device="cpu"))
    tokens = torch.zeros((B, S), dtype=torch.int32)
    leaves = []

    def live(tree):
        if isinstance(tree, dict):
            return {k: live(v) for k, v in tree.items()}
        leaves.append(tree.requires_grad_(tree.is_floating_point()))
        return tree

    if kind == "train":
        params = live(params)
        with counting() as c, torch.enable_grad():
            loss = train_loss(params, {"tokens": tokens}, cfg, unroll=True)[0]
            torch.autograd.grad(loss, [x for x in leaves if x.requires_grad], allow_unused=True)
        return c.dot_flops
    cache = init_cache(cfg, B, S + 1, device="cpu")
    with counting() as c, torch.no_grad():
        if kind == "prefill":
            forward(params, {"tokens": tokens}, cfg, cache=cache, pos_offset=0, last_only=True,
                    unroll=True)
        else:
            forward(params, {"tokens": tokens[:, :1]}, cfg, cache=cache, pos_offset=S,
                    unroll=True)
    return c.dot_flops


@pytest.fixture
def plain_remat(monkeypatch):
    """Every remat region run plainly on both sides: the port's
    ``layers.remat`` and JAX's ``jax.checkpoint`` as identities."""
    from repro_torch.models import layers

    monkeypatch.setattr(layers, "remat", lambda fn, *a: fn(*a))
    monkeypatch.setattr(jax, "checkpoint", lambda f, **kw: f)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_equal_jax(arch, kind, plain_remat):
    """The dot FLOPs the port's counter sees on the one-device unrolled
    program (the train gradient, a prefill into a cache, a decode step)
    equal the ``dot_general`` FLOPs of JAX's jaxpr of it.  Remat runs
    plainly on both sides: how each recomputes is
    :func:`test_remat_recomputes_at_least_what_jax_does`."""
    want = _dot_flops(_jax_program(arch, kind, remat=False).jaxpr)
    assert _port_dot_flops(arch, kind, remat=False) == want


@pytest.mark.parametrize("arch", ARCHS[:3])
def test_remat_recomputes_at_least_what_jax_does(arch):
    """A difference by design (ROADMAP.md Queue 3): with remat, torch's
    checkpoint re-runs a region's ops in the backward up to its last saved
    input, and a region nested in another (attention's core, the SSD scan)
    once more, where JAX's remat recomputes only what the backward reads.
    The port's recompute is at least JAX's and at most two forwards."""
    plain = _dot_flops(_jax_program(arch, "train", remat=False).jaxpr)
    jax_remat = _dot_flops(_jax_program(arch, "train").jaxpr)
    port = _port_dot_flops(arch, "train")
    fwd = _dot_flops(_jax_program(arch, "forward").jaxpr)
    assert plain < jax_remat <= port <= plain + 2 * fwd


# ---------------------------------------------------------------------------
# composition: cost_cell against a whole-step trace, on a fake (2, 2) mesh
# ---------------------------------------------------------------------------

_COMPOSE = r"""
import json, sys
import repro_torch.configs as C
from repro_torch.configs import reduced_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells, costing
from repro_torch.launch.fakeworld import fake_world

real = C.get_config
out = {}
for label, arch, shape, over in (
        ("qwen_train", "qwen3-32b", ShapeConfig("t", "train", 32, 8), {}),
        ("granite_train_dp_includes_model", "granite-moe-1b-a400m",
         ShapeConfig("t", "train", 32, 8), {"dp_includes_model": True}),
        ("qwen_decode", "qwen3-32b", ShapeConfig("d", "decode", 64, 4), {}),
        ("qwen_prefill", "qwen3-32b", ShapeConfig("p", "prefill", 64, 4), {})):
    red = reduced_for_smoke(real(arch))
    C.get_config = cells.get_config = lambda a, red=red: red
    with fake_world((2, 2), ("data", "model")) as mesh:
        cell = cells.build_cell(arch, shape, mesh, **over)
        whole = costing.trace_cell(cell)
        cc = costing.cost_cell(arch, shape, overrides=over, mesh=mesh)
    out[label] = {"whole_dot": whole["dot_flops"], "whole_coll": sum(whole["coll"].values()),
                  "whole_counts": whole["coll_counts"], "dot": cc["dot_flops"],
                  "coll": cc["coll_bytes"], "dp_includes_model": cell.pcfg.dp_includes_model}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def composed():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_COMPOSE)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.mark.parametrize("label", ["qwen_train", "granite_train_dp_includes_model",
                                   "qwen_decode", "qwen_prefill"])
def test_composition_is_exact(composed, label):
    """cost_cell's dot FLOPs and collective bytes equal a whole-step trace
    of the same cell (one microbatch; no remainder layers)."""
    r = composed[label]
    assert r["dot"] == r["whole_dot"] and r["coll"] == r["whole_coll"]
    assert r["whole_coll"] > 0


def test_dp_includes_model_step_traces(composed):
    """The granite step whose rows split over both mesh axes
    (``dp_includes_model``) traces under the fake group (``axes_group``
    builds its rank lists in Python ints), all-reducing over them."""
    r = composed["granite_train_dp_includes_model"]
    assert r["dp_includes_model"] and r["whole_counts"]["all-reduce"] > 0
