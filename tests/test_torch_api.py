"""The port's package-level API against the JAX package's.

Every name a JAX module exports (its ``__all__``) exists in the port's
counterpart, apart from the JAX and XLA shims that have nothing to port;
the single-problem annealers and ``params.merge`` / ``count`` agree with
JAX's on one seeded input (spins bit-identical on dyadic fixtures, where
every field and energy sum is exact in float32)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.sa_sweep import sa_sweep as j_sa_sweep
from repro.models import params as jparams
from repro_torch.configs.base import ParallelConfig
from repro_torch.distributed import sharding as tshd
from repro_torch.kernels import ref as tref
from repro_torch.kernels import sa_sweep as tsa
from repro_torch.models import params as tparams

torch.set_num_threads(1)

# JAX module -> names of its __all__ the port does not carry, and why
SHIMS = {
    "kernels.ops": {"default_interpret"},    # Pallas interpret mode off the TPU
    "launch.costing": {"CellCosts"},         # an XLA compiled program's summary
    "launch.mesh": {"set_mesh"},             # jax.set_mesh across JAX versions
}
MODULES = ("core", "compression", "models.params", "kernels.ref", "kernels.sa_sweep",
           "serving", "kernels.ops", "launch.costing", "launch.mesh", "distributed.sharding")


@pytest.mark.parametrize("module", MODULES)
def test_every_exported_name_of_the_reference_exists_in_the_port(module):
    jmod = importlib.import_module(f"repro.{module}")
    tmod = importlib.import_module(f"repro_torch.{module}")
    want = set(jmod.__all__) - SHIMS.get(module, set())
    missing = sorted(n for n in want if not hasattr(tmod, n))
    assert not missing, f"repro_torch.{module} lacks {missing}"
    assert want <= set(tmod.__all__)
    for name in SHIMS.get(module, ()):
        assert not hasattr(tmod, name)


def test_the_quickstart_imports():
    from repro_torch.core import greedy_decompose, run_bbo_batch, shrunk_vgg_instance

    assert callable(run_bbo_batch) and callable(greedy_decompose)
    W = shrunk_vgg_instance(0, device="cpu")
    assert tuple(W.shape) == (8, 100)


def test_activation_spec_is_the_rule_activation_rules_installs():
    """The reference names ``activation_spec`` in ``__all__`` but defines no
    such function (ROADMAP Queue 3); the port's gives each kind's spec
    without installing it."""
    from repro.distributed import sharding as jshd

    assert "activation_spec" in jshd.__all__ and not hasattr(jshd, "activation_spec")
    for pcfg in (ParallelConfig(mesh_shape=(2, 2)),
                 ParallelConfig(mesh_shape=(2, 2), dp_includes_model=True)):
        mesh = {"data": 2, "model": 2}
        with tshd.activation_rules(pcfg, mesh) as specs:
            for kind in ("hidden", "logits", "batch", "decode_sp_axis"):
                assert tshd.activation_spec(pcfg, mesh, kind) == specs.get(kind)
                assert tshd.current_rule(kind) == specs.get(kind)
    assert tshd.activation_spec(ParallelConfig(), {"data": 2, "model": 2}, "hidden") == (
        "data", None, "model")


def _dyadic(rng, n):
    h = (rng.integers(-256, 257, n) / 64.0).astype(np.float32)
    B = np.triu(rng.integers(-256, 257, (n, n)) / 64.0, 1)
    return h, (B + B.T).astype(np.float32)


def _spins(rng, shape):
    return np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)


def test_sa_sweep_and_its_ref_match_jax_single_problem():
    rng = np.random.default_rng(3)
    C, S, n = 4, 6, 16
    h, B = _dyadic(rng, n)
    x0 = _spins(rng, (C, n))
    u = rng.random((C, S, n), dtype=np.float32)
    temps = np.geomspace(6.0, 0.05, S).astype(np.float32)
    args = [torch.from_numpy(a) for a in (h, B, x0, u, temps)]
    before = tsa.sa_sweep_many.launches
    xt, et = tsa.sa_sweep(*args)                    # CPU tensors: the plain version
    assert tsa.sa_sweep_many.launches == before
    xr, er = tref.sa_sweep_ref(*args)
    xm, em = tsa.sa_sweep_many(*(a[None] for a in args))
    jargs = [jnp.asarray(a) for a in (h, B, x0, u, temps)]
    xj, ej = jref.sa_sweep_ref(*jargs)
    xp, ep = j_sa_sweep(*jargs, interpret=True)
    assert xt.shape == (C, n) and et.shape == (C,)
    for x, e in ((xr, er), (xm[0], em[0])):
        assert torch.equal(xt, x) and torch.equal(et, e)
    for x, e in ((xj, ej), (xp, ep)):
        np.testing.assert_array_equal(xt.numpy(), np.asarray(x))
        np.testing.assert_array_equal(et.numpy(), np.asarray(e))


def test_sqa_sweep_ref_matches_jax_single_problem():
    rng = np.random.default_rng(4)
    C, T, S, n = 3, 4, 5, 12
    h, B = _dyadic(rng, n)
    X0 = _spins(rng, (C, T, n))
    u = rng.random((C, S, T, n), dtype=np.float32)
    jperps = np.linspace(0.1, 2.0, S).astype(np.float32)
    Xt, Et = tref.sqa_sweep_ref(*(torch.from_numpy(a) for a in (h, B, X0, u, jperps)),
                                temperature=0.05)
    Xm, Em = tref.sqa_sweep_many_ref(*(torch.from_numpy(a)[None] for a in (h, B, X0, u)),
                                     torch.from_numpy(jperps), temperature=0.05)
    Xj, Ej = jref.sqa_sweep_ref(*(jnp.asarray(a) for a in (h, B, X0, u, jperps)),
                                temperature=0.05)
    assert Xt.shape == (C, T, n) and Et.shape == (C, T)
    assert torch.equal(Xt, Xm[0]) and torch.equal(Et, Em[0])
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(Et.numpy(), np.asarray(Ej))


def test_merge_and_count_match_jax():
    rng = np.random.default_rng(5)
    arrays = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": {"c": rng.standard_normal(5).astype(np.float32),
                    "d": rng.integers(0, 9, (2, 2, 2)).astype(np.int32)}}
    axes = {"a": ("embed", "mlp"), "b": {"c": (None,), "d": ("layers", None, "vocab")}}
    jvals = jax.tree.map(jnp.asarray, arrays)
    tvals = {"a": torch.from_numpy(arrays["a"]),
             "b": {k: torch.from_numpy(v) for k, v in arrays["b"].items()}}
    jtree = jparams.merge(jvals, axes)
    ttree = tparams.merge(tvals, axes)
    assert tparams.count(tvals) == jparams.count(jvals) == 12 + 5 + 8
    assert isinstance(ttree["b"]["d"], tparams.Param) and ttree["b"]["d"].axes == axes["b"]["d"]
    assert jtree["b"]["d"].axes == ttree["b"]["d"].axes
    back, back_axes = tparams.split(ttree)
    assert back_axes == axes
    assert all(back[k] is tvals[k] for k in ("a",)) and back["b"]["c"] is tvals["b"]["c"]
    jback = jparams.split(jtree)[0]
    np.testing.assert_array_equal(np.asarray(jback["b"]["d"]), back["b"]["d"].numpy())
