"""The port's logical-axis sharding rules against the JAX package's, with no
process group: ``spec_for`` on every leaf of every config, the train
state's shardings, ``activation_rules`` and ``cache_shardings``, on mesh
shapes (the port) and ``AbstractMesh`` (JAX), entry for entry; the boxes
of ``NamedSharding``; ``fit``; and the identity of every helper outside an
installed rule."""

import dataclasses

import jax
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHITECTURES
from repro.configs import get_config as j_get_config
from repro.configs.base import ParallelConfig as JParallel
from repro.distributed import sharding as jshd
from repro.serving.engine import cache_shardings as j_cache_shardings
from repro.training.loop import _axes_trees as j_axes_trees
from repro.training.loop import state_shardings as j_state_shardings
from repro_torch.compression.plan import tree_paths
from repro_torch.configs import get_config
from repro_torch.configs.base import ParallelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import init_model
from repro_torch.models.params import split
from repro_torch.serving.engine import cache_shardings
from repro_torch.training import state_shardings

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
VARIANTS = {
    "fsdp": {},
    "no_fsdp": {"fsdp": False},
    "dp_includes_model": {"dp_includes_model": True},
}


def _pcfgs(mesh, variant):
    shape, axes = MESHES[mesh]
    kw = dict(mesh_shape=shape, mesh_axes=axes, **VARIANTS[variant])
    return JParallel(**kw), ParallelConfig(**kw), AbstractMesh(shape, axes), dict(zip(axes, shape))


def _spec(s) -> tuple:
    """A JAX spec (a PartitionSpec, or a NamedSharding's) as a tuple."""
    return tuple(s.spec if hasattr(s, "spec") else s)


@pytest.fixture(scope="module")
def axes_trees():
    """Every config's leaves in both packages: {arch: (JAX {path: (shape,
    axes)}, port {path: (shape, axes)})}."""
    out = {}
    for arch in ARCHITECTURES:
        jshapes, jaxes = j_axes_trees(j_get_config(arch))
        jl = {"/".join(str(getattr(k, "key", k)) for k in p): v
              for p, v in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
        ja = {"/".join(str(getattr(k, "key", k)) for k in p): v
              for p, v in jax.tree_util.tree_flatten_with_path(
                  jaxes, is_leaf=lambda x: isinstance(x, tuple))[0]}
        values, axes = split(init_model(get_config(arch), device="meta"))
        out[arch] = ({p: (tuple(jl[p].shape), ja[p]) for p in jl},
                     {p: (tuple(v.shape), a) for (p, v), (_, a) in
                      zip(tree_paths(values), _axes_leaves(axes))})
    return out


def _axes_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_axes_leaves(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return [(prefix, tree)]


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_matches_jax_on_every_leaf_of_every_config(axes_trees, mesh, variant):
    jp, tp, jmesh, sizes = _pcfgs(mesh, variant)
    jrules, trules = jshd.make_rules(jp), shd.make_rules(tp)
    assert jrules == trules
    n = 0
    for arch, (jleaves, tleaves) in axes_trees.items():
        assert sorted(jleaves) == sorted(tleaves), arch
        for path, (shape, axes) in jleaves.items():
            assert tleaves[path] == (shape, axes), (arch, path)
            want = _spec(jshd.spec_for(axes, shape, jrules, jmesh))
            assert shd.spec_for(axes, shape, trules, sizes) == want, (arch, path)
            n += 1
    assert n > 200


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", ["2x16x16", "2x2"])
@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_state_shardings_match_jax(mesh, variant, optimizer):
    """Params, the same-shape moments (the parameter's spec), Adafactor's
    factored moments and the step (replicated)."""
    jp, tp, jmesh, sizes = _pcfgs(mesh, variant)
    for arch in ("granite-moe-1b-a400m", "zamba2-1.2b", "llama3-405b"):
        jsh = j_state_shardings(j_get_config(arch), dataclasses.replace(jp, optimizer=optimizer),
                                jmesh)
        tsh = state_shardings(get_config(arch), dataclasses.replace(tp, optimizer=optimizer),
                              sizes)
        jl = jax.tree_util.tree_flatten_with_path(jsh)[0]
        tl = tree_paths(tsh)
        assert len(jl) == len(tl), arch
        for (jpth, js), (tpth, ts) in zip(jl, tl):
            assert "/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in jpth) == tpth
            assert ts.spec == _spec(js), (arch, tpth)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_activation_rules_match_jax(mesh, variant):
    jp, tp, jmesh, sizes = _pcfgs(mesh, variant)
    with jshd.activation_rules(jp, jmesh) as jspecs, shd.activation_rules(tp, sizes) as tspecs:
        assert sorted(jspecs) == sorted(tspecs)
        for k, v in jspecs.items():
            assert tspecs[k] == (tuple(v) if isinstance(v, JP) else v), k
            assert shd.current_rule(k) == tspecs[k]
        assert shd.current_mesh() == sizes
    assert shd.current_rule("hidden") is None and shd.current_mesh() is None


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-32b", "granite-moe-1b-a400m", "zamba2-1.2b",
                                  "mamba2-130m"])
def test_cache_shardings_match_jax(arch, mesh, stacked):
    """k/v sequence-sharded, state head-sharded, conv channel-sharded, the
    batch over dp only where it divides (batch 32 and 3)."""
    jp, tp, jmesh, sizes = _pcfgs(mesh, "fsdp")
    for batch in (32, 3):
        js = j_cache_shardings(j_get_config(arch), jp, jmesh, batch, 256, stacked=stacked)
        ts = cache_shardings(get_config(arch), tp, sizes, batch, 256, stacked=stacked)
        jl = jax.tree_util.tree_flatten_with_path(js)[0]
        tl = tree_paths(ts)
        assert len(jl) == len(tl) > 0
        for (_, j), (path, t) in zip(jl, tl):
            assert t.spec == _spec(j), (path, batch)


def test_cache_shardings_cover_the_page_pool_view():
    """``cache_shardings`` maps over ``PagePool.view_template()``: the same
    leaves, shapes and dtypes as ``init_cache``."""
    from repro_torch.serving.kv_pages import PagePool

    cfg = dataclasses.replace(get_config("qwen3-32b"), num_layers=2)
    pool = PagePool(cfg, num_slots=2, max_len=32, page_size=8, device="meta")
    tmpl = tree_paths(pool.view_template())
    sh = tree_paths(cache_shardings(cfg, None, {"data": 2, "model": 2}, 2, 32))
    assert [p for p, _ in tmpl] == [p for p, _ in sh]
    for (p, leaf), (_, s) in zip(tmpl, sh):
        assert s.spec[1:3] == ("data", "model"), p
        boxes = s.devices_indices_map(tuple(leaf.shape))
        assert sorted({(b[1].start, b[2].start) for b in boxes.values()}) == \
            [(0, 0), (0, 16), (1, 0), (1, 16)]


def test_named_sharding_boxes_are_pod_major():
    """A dim split over ('pod', 'data') is split pod first, as JAX's
    ``devices_indices_map`` orders it; placements per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    s = shd.NamedSharding({"pod": 2, "data": 2, "model": 3}, (("pod", "data"), "model"))
    boxes = s.devices_indices_map((8, 6))
    assert boxes[0] == (slice(0, 2), slice(0, 2))
    assert boxes[1] == (slice(0, 2), slice(2, 4))
    assert boxes[3] == (slice(2, 4), slice(0, 2))
    assert boxes[6] == (slice(4, 6), slice(0, 2))
    assert boxes[11] == (slice(6, 8), slice(4, 6))
    assert s.placements() == [Shard(0), Shard(0), Shard(1)]
    assert shd.NamedSharding({"data": 2, "model": 2}, ()).placements() == [Replicate()] * 2
    with pytest.raises(NotImplementedError, match="out of mesh order"):
        shd.NamedSharding({"data": 2, "model": 2}, (("model", "data"),))
    with pytest.raises(ValueError, match="does not split evenly"):
        s.devices_indices_map((6, 6))


def test_fit_and_spec_for_fallbacks_match_jax():
    """``fit`` keeps the largest dividing suffix; ``spec_for`` retries a
    tuple rule's largest dividing prefix and uses an axis once."""
    sizes = {"pod": 2, "data": 16, "model": 16}
    jmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    rules = {"embed": ("pod", "data"), "mlp": "model", "vocab": "model", None: None}
    for axes, shape in [(("embed", "mlp"), (64, 128)), (("embed", "mlp"), (6, 128)),
                        (("embed", "mlp"), (2, 128)), (("vocab", "mlp"), (32, 32)),
                        (("embed", None), (3, 5)), (("mlp", "embed"), (16, 64))]:
        assert shd.spec_for(axes, shape, rules, sizes) == \
            _spec(jshd.spec_for(axes, shape, rules, jmesh)), (axes, shape)
    assert shd.fit(256, ("pod", "data", "model"), sizes) == ("data", "model")
    assert shd.fit(512, ("pod", "data", "model"), sizes) == ("pod", "data", "model")
    assert shd.fit(16, ("pod", "data", "model"), sizes) == "model"
    assert shd.fit(3, ("pod", "data"), sizes) is None
    assert shd.fit(4, None, sizes) is None


def test_helpers_are_the_identity_outside_installed_rules():
    x = torch.arange(6.0).reshape(2, 3)
    assert shd.constrain(x, "hidden") is x
    assert shd.dp_sum(x) is x
    assert torch.equal(shd.dp_mean(x, (0, 1)), x.mean(dim=(0, 1)))
    assert shd.local_value(x) is x and shd.full_value(x) is x
    with shd.activation_rules(ParallelConfig(mesh_shape=(2, 2)), {"data": 2, "model": 2}):
        assert shd.constrain(x, "hidden") is x          # a plain tensor passes unchanged
    with shd.data_parallel(None, 1):
        assert shd.dp_sum(x) is x


# model_all_to_all on three ranks: rank r's x is (5, 6) of r * 100 + its
# index; SEND[r][t] the indices of dim 1 it sends rank t: uneven, empty,
# and an index sent to several ranks (and twice to one)
A2A_M = 3
A2A_SEND = [[[0, 1], [1, 4, 5], []],
            [[2], [0], [2, 3, 2, 5]],
            [[5, 0, 1], [], [0]]]


def _a2a_x(r, dtype):
    return (torch.arange(30, dtype=torch.float64).reshape(5, 6) + 100 * r).to(dtype)


def _a2a_cot(r, n, dtype):
    return torch.randn((5, n), generator=torch.Generator().manual_seed(7 + r),
                       dtype=torch.float64).to(dtype)


def _a2a_share(r, group, dtype=torch.float32):
    """Rank r's result and the gradient of <result, its cotangent> on x,
    with the ones the definition gives."""
    recv = [len(A2A_SEND[s][r]) for s in range(A2A_M)]
    x = _a2a_x(r, dtype).requires_grad_()
    with shd.model_parallel((group, A2A_M, r)):
        y = shd.model_all_to_all(x, A2A_SEND[r], recv, dim=1)
        (grad,) = torch.autograd.grad(y, x, _a2a_cot(r, sum(recv), dtype))
    want_y = torch.cat([_a2a_x(s, dtype)[:, A2A_SEND[s][r]] for s in range(A2A_M)], 1)
    # rank t's cotangent, read at the columns rank r sent it, summed back at
    # their indices
    want_g = torch.zeros((5, 6), dtype=torch.float64)
    for t in range(A2A_M):
        off = sum(len(A2A_SEND[s][t]) for s in range(r))
        n = sum(len(A2A_SEND[s][t]) for s in range(A2A_M))
        part = _a2a_cot(t, n, dtype).double()[:, off:off + len(A2A_SEND[r][t])]
        for j, i in enumerate(A2A_SEND[r][t]):
            want_g[:, i] += part[:, j]
    return y.detach(), grad, want_y, want_g


def _a2a_ranks(rank, world):
    import torch.distributed as dist

    return [_a2a_share(rank, dist.group.WORLD, dt) for dt in (torch.float32, torch.bfloat16)]


def _check_a2a(results, dtype):
    for y, grad, want_y, want_g in results:
        assert y.dtype == grad.dtype == dtype
        assert torch.equal(y, want_y)
        tol = 1e-6 if dtype == torch.float32 else 1e-2
        assert float((grad.double() - want_g).abs().max()) <= tol * float(want_g.abs().max())


def test_model_all_to_all_on_gloo(tmp_path):
    """On three gloo ranks: each rank receives, in rank order, the indices
    every rank sends it (uneven, some none, some to several ranks), and
    the backward is the reverse all-to-all with the copies of an index
    summed, in f32 and (accumulated in f32) in bf16."""
    from repro_torch.distributed.local_ranks import run_ranks

    ranks = run_ranks(_a2a_ranks, A2A_M, str(tmp_path))
    for i, dt in enumerate((torch.float32, torch.bfloat16)):
        _check_a2a([r[i] for r in ranks], dt)


def test_model_all_to_all_on_the_stand_in():
    """The same three ranks one after another on ``TurnGroup``; and with
    one rank, an index select."""
    from repro_torch.distributed.local_ranks import run_in_turns

    outs, passes, calls = run_in_turns(_a2a_share, A2A_M)
    assert calls == 2 and passes == 3         # forward, then the reverse in backward
    _check_a2a(outs, torch.float32)
    x = _a2a_x(0, torch.float32)
    with shd.model_parallel(None):
        assert torch.equal(shd.model_all_to_all(x, [[4, 1, 1]], [3]), x[:, [4, 1, 1]])
