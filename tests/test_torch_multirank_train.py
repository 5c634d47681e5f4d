"""Sharded training, checkpoints and flash-decode on four gloo ranks against
the JAX package on four forced host devices, both on a (2, 2) ("data",
"model") mesh.

JAX runs in a subprocess (its device count is fixed at its first use, as
``tests/test_multidevice.py`` does it); the port's ranks are CPU processes
joined by a ``FileStore`` under ``tmp_path`` (no port number, so parallel
test workers do not meet).  The port starts from JAX's own initial state,
saved by JAX's checkpointer from its four devices, so the losses and
parameters are comparable."""

import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.distributed.local_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, STEPS, MICRO = "qwen3-32b", 4, 2
SEQ, BATCH = 32, 8
# the tolerances of tests/test_torch_training.py's unsharded parity
LOSS_TOL, PARAM_TOL, NORM_TOL = 1e-6, 1e-4, 1e-5
# flash-decode: B, Smax, KV, rep, hd
DEC = (2, 16, 2, 2, 8)

JAX_TRAIN = """
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.launch.mesh import make_mesh, set_mesh
from repro.configs import get_config, reduced_for_smoke
from repro.configs.base import ParallelConfig, ShapeConfig
from repro.training import init_train_state, make_train_step, state_shardings
from repro.distributed.sharding import activation_rules
from repro.data.pipeline import make_pipeline
from repro.optim import warmup_cosine
from repro.checkpoint.manager import CheckpointManager
from repro.compression.plan import tree_paths
from repro.models.attention import _decode_attention

out = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
cfg = reduced_for_smoke(get_config("{arch}"))
pcfg = ParallelConfig(mesh_shape=(2, 2), mesh_axes=("data", "model"), microbatches={micro})
state = init_train_state(jax.random.PRNGKey(0), cfg, pcfg, mesh)
sh = state_shardings(cfg, pcfg, mesh)
mgr = CheckpointManager(out + "/jax_init", keep_last=1)
mgr.save(0, state); mgr.wait()
def box(ix, shape):
    return [[s.start or 0, s.stop if s.stop is not None else d] for s, d in zip(ix, shape)]
# per mesh position, row-major, as the port's ranks are laid out
boxes = {{p: [box(s_.devices_indices_map(tuple(leaf.shape))[d], leaf.shape)
              for d in mesh.devices.flat]
         for (p, leaf), (_, s_) in zip(tree_paths(state), tree_paths(sh))}}
step_fn = make_train_step(cfg, pcfg, warmup_cosine(1e-2, 1, 8))
pipe = make_pipeline(cfg, ShapeConfig("t", "train", {seq}, {batch}), mesh)
losses, norms = [], []
with set_mesh(mesh), activation_rules(pcfg, mesh):
    jstep = jax.jit(step_fn, in_shardings=(sh, None), out_shardings=(sh, None))
    for i in range({steps}):
        state, m = jstep(state, pipe.batch_at(i))
        losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    B, S, KV, R, H = {dec}
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, KV, R, H), (B, S, KV, H), (B, S, KV, H)])
    val1 = np.arange(S) < 11
    val2 = np.arange(S)[None, :] < np.array([[5], [13]])
    dec = {{}}
    for name, val in (("val1", val1), ("val2", val2)):
        dec[name] = np.asarray(jax.jit(lambda *a: _decode_attention(*a, 0.35, jnp.float32))(
            q, k, v, val))
np.savez(out + "/ref.npz", losses=np.array(losses), norms=np.array(norms),
         **{{"p:" + p: np.asarray(x, np.float32) for p, x in tree_paths(state.params)}},
         **{{"dec:" + k: x for k, x in dec.items()}})
with open(out + "/boxes.json", "w") as f:
    json.dump(boxes, f)
print("JAX_OK")
"""

JAX_RESTORE = """
import sys
import numpy as np
import jax
from repro.launch.mesh import make_mesh
from repro.configs import get_config, reduced_for_smoke
from repro.configs.base import ParallelConfig
from repro.training import init_train_state, state_shardings
from repro.checkpoint.manager import CheckpointManager
from repro.compression.plan import tree_paths

out = sys.argv[1]
mesh = make_mesh((2, 2), ("data", "model"))
cfg = reduced_for_smoke(get_config("{arch}"))
pcfg = ParallelConfig(mesh_shape=(2, 2), mesh_axes=("data", "model"), microbatches={micro})
like = init_train_state(jax.random.PRNGKey(1), cfg, pcfg, mesh)
step, got = CheckpointManager(out + "/port_ckpt").restore_latest(
    like, state_shardings(cfg, pcfg, mesh))
want = np.load(out + "/port_state.npz")
leaves = dict(tree_paths(got))
assert step == {steps} and sorted(leaves) == sorted(want.files), step
for p, x in leaves.items():
    a = np.asarray(x)
    b = want[p].view(a.dtype) if want[p].dtype.kind == "V" else want[p]
    assert a.tobytes() == b.tobytes(), p
print("JAX_RESTORE_OK", len(leaves))
"""


def _run_jax(code: str, out: str, timeout: int = 300) -> str:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code), out],
                       capture_output=True, text=True, timeout=timeout, env=env)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-3000:]}"
    return r.stdout


def _fmt(code: str) -> str:
    return code.format(arch=ARCH, micro=MICRO, seq=SEQ, batch=BATCH, steps=STEPS, dec=DEC)


def _cfgs(mesh_shape):
    return (reduced_for_smoke(get_config(ARCH)),
            ParallelConfig(mesh_shape=mesh_shape, mesh_axes=("data", "model"),
                           microbatches=MICRO))


def _train_ranks(rank, world, out):
    """On (2, 2): restore JAX's initial state, record each leaf's box,
    train, save a sharded checkpoint, and run flash-decode."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import bridge
    from repro_torch.checkpoint.checkpointer import to_numpy
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression.plan import tree_paths
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import attention
    from repro_torch.models.attention import _decode_attention
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import (TrainState, init_train_state, make_train_step,
                                      state_shardings)

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg, pcfg = _cfgs((2, 2))
    sh = state_shardings(cfg, pcfg, mesh)
    step0, state = CheckpointManager(out + "/jax_init").restore_latest(
        init_train_state(0, cfg, pcfg, device="meta"), shardings=sh)
    boxes = {p: [[b.start, b.stop] for b in shd.dtensor_box(x)] for p, x in tree_paths(state)}
    init = {p: x.to_local().clone() for p, x in tree_paths(state.params)}

    # the bridge's mesh path: JAX's state as numpy, placed by state_shardings
    whole = CheckpointManager(out + "/jax_init").restore_latest(
        init_train_state(0, cfg, pcfg, device="meta"), device="cpu")[1]
    numpy_state = TrainState(*(_numpy_tree(getattr(whole, f)) for f in TrainState._fields))
    bridged = bridge.train_state_to_torch(numpy_state, mesh=mesh, cfg=cfg, pcfg=pcfg)
    flat = {p: to_numpy(x) for p, x in tree_paths(whole.params)}
    values = bridge.to_torch(flat, shardings=sh.params)
    bridge_ok = all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                    for (_, a), (_, b) in zip(tree_paths(bridged), tree_paths(state))) and \
        all(torch.equal(a.to_local(), b.to_local())
            for (_, a), (_, b) in zip(tree_paths(values), tree_paths(state.params)))

    # the port's own sharded init: each rank's shards of the unsharded init
    mine = init_train_state(3, cfg, pcfg, mesh=mesh)
    ref = init_train_state(3, cfg, pcfg, device="cpu")
    init_ok = all(torch.equal(a.to_local(), b[shd.dtensor_box(a)])
                  for (_, a), (_, b) in zip(tree_paths(mine), tree_paths(ref)))
    del mine, ref

    # constrain: a DTensor redistributed to the installed rule, fitted
    x = shd.NamedSharding(mesh, ()).shard(torch.arange(64.0).reshape(4, 2, 8))
    odd = shd.NamedSharding(mesh, ()).shard(torch.arange(48.0).reshape(3, 2, 8))
    with shd.activation_rules(pcfg, mesh):
        cx, codd = shd.constrain(x, "hidden"), shd.constrain(odd, "hidden")
    constrain_ok = (cx.placements == (Shard(0), Shard(2)) and torch.equal(cx.full_tensor(),
                                                                           x.full_tensor())
                    and codd.placements == (Replicate(), Shard(2)))
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(1e-2, 1, 8))
    pipe = make_pipeline(cfg, ShapeConfig("t", "train", SEQ, BATCH), mesh)
    metrics = []
    # the first step's gathers (their outputs) and gradient reductions
    def tp_shape(x):
        """A group's slice of a stacked leaf as the TP step gathers it: its
        dims on ``data`` whole, its dim on ``model`` this rank's box."""
        shape = list(x.shape[1:])
        mesh_ = x.device_mesh
        for name, p, n in zip(mesh_.mesh_dim_names, x.placements, mesh_.shape):
            if name == "model" and p.is_shard():
                shape[p.dim - 1] //= int(n)
        return tuple(shape)

    gathers = {"out": [], "reduced": [], "scattered": 0,
               "stacked": {p: (tuple(x.shape), shd.is_whole(x))
                           for p, x in tree_paths(state.params) if p.startswith("groups/")},
               "tp_shape": {p: tp_shape(x) for p, x in tree_paths(state.params)
                            if p.startswith("groups/")}}
    fwd, bwd = shd._GatherParam.forward, shd._GatherParam.backward

    def rec_fwd(ctx, *a):
        out = fwd(ctx, *a)
        gathers["out"].append(tuple(out.shape))
        return out

    def rec_bwd(ctx, g):
        gathers["reduced"].append(tuple(g.shape))
        gathers["scattered"] += ctx.dim is not None
        return bwd(ctx, g)

    for i in range(STEPS):
        if i == 0:
            shd._GatherParam.forward, shd._GatherParam.backward = \
                staticmethod(rec_fwd), staticmethod(rec_bwd)
        try:
            state, m = step_fn(state, pipe.batch_at(i))
        finally:
            shd._GatherParam.forward, shd._GatherParam.backward = \
                staticmethod(fwd), staticmethod(bwd)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    mgr = CheckpointManager(out + "/port_ckpt", keep_last=1)
    mgr.save(int(shd.local_value(state.step)), state)
    mgr.wait()
    full = {p: shd.full_value(x).clone() for p, x in tree_paths(state)}

    B, S, KV, R, H = DEC
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in [(B, KV, R, H), (B, S, KV, H), (B, S, KV, H)])
    vals = {"val1": torch.arange(S) < 11,
            "val2": torch.arange(S)[None, :] < torch.tensor([[5], [13]])}
    cache_sh = shd.NamedSharding(mesh, ("data", "model"))
    flash_calls = []
    real = attention._flash_decode
    attention._flash_decode = lambda *a: (flash_calls.append(a[-2:]), real(*a))[1]
    dec = {}
    for name, val in vals.items():
        plain = _decode_attention(q, k, v, val, 0.35, torch.float32)
        with shd.activation_rules(pcfg, mesh):
            whole = _decode_attention(q, k, v, val, 0.35, torch.float32)
            sharded = _decode_attention(shd.NamedSharding(mesh, ("data",)).shard(q),
                                        cache_sh.shard(k), cache_sh.shard(v), val, 0.35,
                                        torch.float32)
        dec[name] = (plain, whole, sharded, cache_sh.local_box(k.shape)[0])
    dec["flash_calls"] = flash_calls
    return {"step0": step0, "boxes": boxes, "init": init, "metrics": metrics,
            "gathers": gathers, "n_groups": cfg.num_groups,
            "checks": {"bridge": bridge_ok, "init": init_ok, "constrain": constrain_ok},
            "full": full if rank == 0 else None, "dec": dec}


def _numpy_tree(tree):
    from repro_torch.checkpoint.checkpointer import to_numpy

    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    a = to_numpy(tree)
    if tree.dtype == torch.bfloat16:
        import ml_dtypes

        a = a.view(ml_dtypes.bfloat16)
    return a


def _restore_ranks(rank, world, out):
    """The port's (2, 2) checkpoint restored on (4, 1)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression.plan import tree_paths
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import init_train_state, state_shardings

    mesh = make_mesh((4, 1), ("data", "model"), "cpu")
    cfg, pcfg = _cfgs((4, 1))
    mgr = CheckpointManager(out + "/port_ckpt")
    step, got = mgr.restore_latest(init_train_state(0, cfg, pcfg, device="meta"),
                                   shardings=state_shardings(cfg, pcfg, mesh))
    # a DTensor template places each leaf as it is placed
    _, like = mgr.restore_latest(init_train_state(5, cfg, pcfg, mesh=mesh))
    assert all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
               for (_, a), (_, b) in zip(tree_paths(got), tree_paths(like)))
    return step, {p: (shd.dtensor_box(x), shd.full_value(x).clone()) for p, x in tree_paths(got)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multirank"))
    assert "JAX_OK" in _run_jax(_fmt(JAX_TRAIN), out)
    ref = dict(np.load(out + "/ref.npz"))
    with open(out + "/boxes.json") as f:
        boxes = json.load(f)
    ranks = run_ranks(_train_ranks, 4, out + "/w1", out)
    return out, ref, boxes, ranks


def test_sharded_training_matches_jax_on_the_same_mesh(runs):
    """Four steps, microbatches 2: every rank's loss and grad norm equal
    JAX's within the unsharded parity's tolerance, and so do the final
    parameters."""
    _, ref, _, ranks = runs
    assert all(r["step0"] == 0 for r in ranks)
    for r in ranks:
        assert r["metrics"] == ranks[0]["metrics"]
        for (loss, norm), jl, jn in zip(r["metrics"], ref["losses"], ref["norms"]):
            assert abs(loss - jl) <= LOSS_TOL * abs(jl), (loss, jl)
            assert abs(norm - jn) <= NORM_TOL * abs(jn), (norm, jn)
    assert ref["losses"][-1] < ref["losses"][0]
    full = ranks[0]["full"]
    params = {k[2:]: v for k, v in ref.items() if k.startswith("p:")}
    assert sorted(params) == sorted(p[len("params/"):] for p in full if p.startswith("params/"))
    for p, j in params.items():
        t = full["params/" + p].float().numpy()
        assert np.abs(t - j).max() <= PARAM_TOL * max(np.abs(j).max(), 1e-30), p


def test_sharded_step_gathers_and_reduces_one_group_at_a_time(runs):
    """The first step never makes a stacked leaf whole: each group's slice
    of a sharded leaf is gathered inside the group's remat, in the forward
    and again in the recompute, every microbatch, over ``data`` alone (its
    dim on ``model`` stays the rank's box: the step is tensor-parallel),
    and its gradient is reduced alone, once a microbatch, a leaf sharded
    over ``data`` (the dp axis here) by a reduce-scatter."""
    from collections import Counter

    _, _, _, ranks = runs
    for r in ranks:
        g, G = r["gathers"], r["n_groups"]
        out, reduced = Counter(g["out"]), Counter(g["reduced"])
        stacked = {shape for shape, _ in g["stacked"].values()}
        assert G > 1 and not stacked & set(out) and not stacked & set(reduced)
        assert not reduced - out                 # only gathered values are reduced
        sharded = Counter(g["tp_shape"][p] for p, (_, whole) in g["stacked"].items()
                          if not whole)
        assert sharded
        for shape, k in sharded.items():
            assert out[shape] >= 2 * MICRO * G * k, (shape, out[shape])
            assert reduced[shape] >= MICRO * G * k, (shape, reduced[shape])
        assert 0 < g["scattered"] < len(g["reduced"])
        assert max(math.prod(s) for s in reduced) < \
            sum(math.prod(shape) for shape, _ in g["stacked"].values())


def test_each_ranks_shard_box_is_jaxs_devices_indices_map(runs):
    """Rank r's box of every state leaf (params, moments, step) is JAX's
    box for device r of the same (2, 2) mesh; the shards restored from
    JAX's four-device checkpoint hold JAX's values there."""
    out, _, boxes, ranks = runs
    assert sorted(ranks[0]["boxes"]) == sorted(boxes)
    sharded = 0
    for p, per_device in boxes.items():
        for r, rk in enumerate(ranks):
            assert rk["boxes"][p] == per_device[r], (p, r)
        sharded += len({json.dumps(b) for b in per_device}) > 1
    assert sharded >= 10


def test_sharded_init_bridge_and_constrain(runs):
    """``init_train_state(mesh=)`` gives each rank its shards of the
    unsharded init bit for bit; the bridge places JAX's state (and values)
    as the restore does; ``constrain`` redistributes a DTensor to the
    ``hidden`` rule, falling back where the batch does not divide."""
    _, _, _, ranks = runs
    for r in ranks:
        assert r["checks"] == {"bridge": True, "init": True, "constrain": True}


def test_jax_checkpoint_restores_shard_by_shard_in_the_port(runs):
    from repro_torch.checkpoint.checkpointer import read_leaf_slice

    out, _, boxes, ranks = runs
    for r, rk in enumerate(ranks):
        for p, local in rk["init"].items():
            box = tuple(slice(a, b) for a, b in boxes["params/" + p][r])
            raw = read_leaf_slice(out + "/jax_init", 0, "params/" + p, box)
            want = local.view(torch.int16).numpy() if local.dtype == torch.bfloat16 \
                else local.numpy()
            assert raw.tobytes() == want.tobytes(), (p, r)


def test_port_checkpoint_restores_elastically_and_in_jax(runs):
    """The port's checkpoint from (2, 2) restores on (4, 1), unsharded on
    one process, and in JAX on its (2, 2) mesh, bit for bit."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression.plan import tree_paths
    from repro_torch.training import init_train_state

    out, _, _, ranks = runs
    full = ranks[0]["full"]
    back = run_ranks(_restore_ranks, 4, out + "/w2", out)
    for r, (step, leaves) in enumerate(back):
        assert step == STEPS
        assert sorted(leaves) == sorted(full)
        for p, (box, value) in leaves.items():
            assert torch.equal(value, full[p]), (p, r)
        assert back[r][1]["params/embed/table"][0][1] == slice(16 * r, 16 * (r + 1))
    cfg, pcfg = _cfgs((1, 1))
    step, whole = CheckpointManager(out + "/port_ckpt").restore_latest(
        init_train_state(0, cfg, pcfg, device="meta"), device="cpu")
    assert step == STEPS
    for p, x in tree_paths(whole):
        assert torch.equal(x, full[p]), p
    from repro_torch.checkpoint.checkpointer import to_numpy

    np.savez(out + "/port_state.npz", **{p: to_numpy(x) for p, x in full.items()})
    assert "JAX_RESTORE_OK" in _run_jax(_fmt(JAX_RESTORE), out)


@pytest.mark.parametrize("valid", ["val1", "val2"])
def test_flash_decode_matches_jax_and_the_plain_path(runs, valid):
    """The cache's sequence on model = 2: partial softmax statistics per
    rank combined by MAX and SUM all-reduces, with the cache whole or
    sharded as ``cache_shardings`` places it; against JAX's shard_map
    branch and the plain path, within 1e-5 of max|logit| (f32)."""
    _, ref, _, ranks = runs
    want = ref["dec:" + valid]
    scale = np.abs(want).max()
    for rk in ranks:
        assert rk["dec"]["flash_calls"] == [("model", 2)] * 4     # the branch ran
        plain, whole, sharded, rows = rk["dec"][valid]
        assert np.abs(plain.numpy() - want).max() <= 1e-5 * scale
        assert np.abs(whole.numpy() - want).max() <= 1e-5 * scale
        assert np.abs(sharded.numpy() - want[rows]).max() <= 1e-5 * scale
