"""Every architecture of the zoo on the port against the JAX package.

For each of the ten ``configs.ARCHITECTURES`` at ``reduced_for_smoke`` in
float32: JAX's weights (biases drawn nonzero where the config has them:
the reference initialises them to zero, which would test nothing) carried
across with ``bridge``, the forward's logits, a cached prefill and one
decode step from that cache, dense and compressed (the port's
``execute_plan`` of those weights, carried back to JAX; the port's forward
with its kernel hooks off and on: on the CPU the hooks run the kernels'
plain twins).  The compressed tree's plan is JAX's, and ``execute_plan``
is held to JAX's where its result is deterministic (int8: the dense
leaves bit for bit, the scales within an ulp, the codes but at ties).  Architectures with an embeddings front end
(musicgen's frames, internvl2's patches) get the same numpy embeddings on
both sides, for the prefill and for the decode step.

Then the zoo sweep (``tools/torch_config_zoo_smoke.py::run_arch``) on its
four architectures against ``tools/config_zoo_smoke.py``'s plan: the same
plan JSON, the same skipped list, and a clean roundtrip.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import ARCHITECTURES as J_ARCHITECTURES
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_model as j_init_model
from repro.models.frontends import needs_embeds as j_needs_embeds
from repro.models.params import split as j_split
from repro_torch import bridge
from repro_torch import compression as tc
from repro_torch.configs import ARCHITECTURES, get_config, reduced_for_smoke
from repro_torch.kernels import ops as tops
from repro_torch.models import forward, init_cache
from repro_torch.models.frontends import needs_embeds

torch.set_num_threads(1)

LOGIT_TOL = 2e-4      # float32 on both sides, as tests/test_torch_models.py holds them
B, P = 2, 8           # batch, prompt length (one SSD chunk at the reduced chunk of 16)
MAX_LEN = P + 2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_port_hooks():
    tops.disable_kernels()
    yield
    tops.disable_kernels()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(t, j):
    np.testing.assert_allclose(_np(t), _np(j), rtol=LOGIT_TOL, atol=LOGIT_TOL)


def _carry(jtree):
    return bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jtree)}, "cpu")


def _with_biases(jvals, seed):
    """Every bias leaf ("b") replaced by a normal draw of scale 0.1."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) == "b":
            return jnp.asarray(0.1 * rng.standard_normal(leaf.shape), leaf.dtype)
        return leaf

    return jax.tree_util.tree_map_with_path(draw, jvals)


def _inputs(cfg, seed):
    """The prompt and the decode step's input, as (JAX, port) dicts."""
    rng = np.random.default_rng(seed)
    if needs_embeds(cfg):
        e = (0.02 * rng.standard_normal((B, P + 1, cfg.d_model))).astype(np.float32)
        pairs = [{"embeds": e[:, :P]}, {"embeds": e[:, P:]}]
    else:
        t = rng.integers(0, cfg.vocab_size, (B, P + 1)).astype(np.int32)
        pairs = [{"tokens": t[:, :P]}, {"tokens": t[:, P:]}]
    return [({k: jnp.asarray(v) for k, v in d.items()},
             {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
              for k, v in d.items()}) for d in pairs]


def _policy(lib=jc):
    return lib.CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                                 min_size=4096)


def _to_jax(ttree):
    """A port tree as JAX's nested dict of arrays."""
    out = {}
    for path, v in bridge.to_numpy(ttree).items():
        *parents, name = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = jnp.asarray(v)
    return out


@pytest.fixture(scope="module", params=sorted(ARCHITECTURES))
def arch(request):
    """One architecture's configs, JAX's dense and compressed trees with
    their port copies, JAX's logits (prefill and decode) on both, inputs."""
    name = request.param
    jcfg = j_reduced(j_get_config(name))
    tcfg = reduced_for_smoke(get_config(name))
    assert jcfg.dtype == tcfg.dtype == "float32"
    jvals = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0]
    if jcfg.use_bias:
        jvals = _with_biases(jvals, seed=1)
    tvals = _carry(jvals)
    tcv, _ = tc.execute_plan(tc.plan_compression(tvals, _policy(tc)), tvals, seed=0,
                             device="cpu")
    jcv = _to_jax(tcv)
    inputs = _inputs(tcfg, seed=2)
    jforward = jax.jit(j_forward, static_argnums=(2,), static_argnames=("pos_offset",))
    want = {}
    for kind, tree in (("dense", jvals), ("compressed", jcv)):
        cache = j_init_cache(jcfg, B, MAX_LEN)
        full, cache, _ = jforward(tree, inputs[0][0], jcfg, cache=cache)
        step, _, _ = jforward(tree, inputs[1][0], jcfg, cache=cache, pos_offset=P)
        want[kind] = (np.asarray(full, np.float32), np.asarray(step, np.float32))
    return {"name": name, "jcfg": jcfg, "tcfg": tcfg, "inputs": inputs, "want": want,
            "trees": {"dense": tvals, "compressed": tcv},
            "jtrees": {"dense": jvals, "compressed": jcv}}


def test_the_zoo_is_the_reference_zoo():
    assert ARCHITECTURES == J_ARCHITECTURES and len(ARCHITECTURES) == 10
    for name in ("internvl2-2b", "mistral-nemo-12b", "musicgen-medium", "command-r-plus-104b"):
        assert name in ARCHITECTURES
    for name in ARCHITECTURES:
        assert needs_embeds(get_config(name)) == j_needs_embeds(j_get_config(name))


@pytest.mark.parametrize("hooks", [False, True])
@pytest.mark.parametrize("kind", ["dense", "compressed"])
def test_forward_prefill_and_decode_match_jax(arch, kind, hooks):
    """Full logits without a cache, a cached prefill's logits and one
    decode step from that cache, within LOGIT_TOL of JAX's."""
    tcfg, tvals = arch["tcfg"], arch["trees"][kind]
    (_, prompt), (_, nxt) = arch["inputs"]
    full_want, step_want = arch["want"][kind]
    if hooks:
        tops.enable_kernels()
    with torch.inference_mode():
        logits, c, _ = forward(tvals, prompt, tcfg)
        assert c is None
        _close(logits, full_want)
        cache = init_cache(tcfg, B, MAX_LEN, device="cpu")
        logits, cache, _ = forward(tvals, prompt, tcfg, cache=cache)
        _close(logits, full_want)
        step, _, _ = forward(tvals, nxt, tcfg, cache=cache, pos_offset=P)
    assert step.shape == (B, 1, tcfg.vocab_size)
    _close(step, step_want)


def test_compressed_trees_are_the_same_on_both_sides(arch):
    """The plan behind the compressed tree the forwards above served is
    JAX's, and its compressed leaves (with use_bias, nonzero biases beside
    them) lie at JAX's paths.  ``execute_plan`` itself is held to JAX's on
    a method whose result is deterministic: int8 over the same tree gives
    JAX's manifest and JAX's compressed tree leaf for leaf, bit for bit:
    every leaf left dense, the scales and the int8 codes."""
    jvals = arch["jtrees"]["dense"]
    jplan = jc.plan_compression(jvals, _policy())
    tplan = tc.plan_compression(arch["trees"]["dense"], _policy(tc))
    assert tplan.to_json() == jplan.to_json()
    tleaves = bridge.to_numpy(arch["trees"]["compressed"])
    assert {p.rsplit("/", 1)[0] for p in tleaves if p.endswith("/m_packed")} == {
        t.path for t in jplan.tensors}
    if arch["tcfg"].use_bias:
        biases = [v for p, v in tleaves.items() if p.endswith("/b")]
        assert biases and all(np.abs(b).max() > 0 for b in biases)

    kw = dict(method="int8", tile_d=32, min_size=4096)
    jcv, jart = jc.execute_plan(jc.plan_compression(jvals, jc.CompressionPolicy(**kw)), jvals,
                                key=jax.random.PRNGKey(0))
    tvals = arch["trees"]["dense"]
    tcv, tart = tc.execute_plan(tc.plan_compression(tvals, tc.CompressionPolicy(**kw)), tvals,
                                device="cpu")
    assert jart.manifest["tensors"] and list(tart.manifest["tensors"]) == list(
        jart.manifest["tensors"])
    for path, e in jart.manifest["tensors"].items():
        te = tart.manifest["tensors"][path]
        assert (te["new_bytes"], te["q"], te["scale"]) == (e["new_bytes"], e["q"], e["scale"])
        np.testing.assert_allclose(te["rel_err"], e["rel_err"], rtol=1e-5)
    jleaves = {p: np.asarray(v) for p, v in j_tree_paths(jcv)}
    tleaves = bridge.to_numpy(tcv)
    assert list(tleaves) == list(jleaves)
    for p, v in tleaves.items():
        assert v.dtype == jleaves[p].dtype and v.shape == jleaves[p].shape, p
        np.testing.assert_array_equal(v, jleaves[p], err_msg=p)


ZOO = ("mamba2-130m", "zamba2-1.2b", "internvl2-2b", "musicgen-medium")


@pytest.fixture(scope="module")
def zoo_tools():
    return _load_tool("config_zoo_smoke"), _load_tool("torch_config_zoo_smoke")


def test_the_sweeps_cover_the_same_architectures(zoo_tools):
    jtool, ttool = zoo_tools
    assert tuple(ttool.ARCHS) == tuple(jtool.ARCHS) == ZOO


@pytest.mark.parametrize("name", ZOO)
def test_zoo_sweep_plans_as_the_reference_and_roundtrips(zoo_tools, name):
    """The port's run_arch (its four checks) plans what JAX's
    ``plan_compression`` plans on the reference sweep's tree, under the
    reference sweep's policy."""
    _, ttool = zoo_tools
    info = ttool.run_arch(name, device="cpu")
    jcfg = j_reduced(j_get_config(name))
    shapes = jax.eval_shape(lambda k: j_split(j_init_model(k, jcfg))[0], jax.random.PRNGKey(0))
    jplan = jc.plan_compression(shapes, _policy())
    assert ttool.smoke_policy().to_dict() == _policy(tc).to_dict() == _policy().to_dict()
    assert info["plan_json"] == jplan.to_json()
    assert info["skipped"] == [list(s) for s in jplan.skipped]
    assert info["tensors"] == len(jplan.tensors) > 0
    assert info["argmax_mismatch"] == 0
    assert info["logits"] == [2, 16, jcfg.vocab_size]


def test_zoo_sweep_main_reports_every_architecture(zoo_tools, capsys):
    _, ttool = zoo_tools
    assert ttool.main(["--device", "cpu", "--archs", "internvl2-2b", "musicgen-medium"]) == 0
    out = capsys.readouterr().out
    assert "[zoo] internvl2-2b: OK" in out and "[zoo] musicgen-medium: OK" in out
    assert "[zoo] all 2 archs passed" in out
