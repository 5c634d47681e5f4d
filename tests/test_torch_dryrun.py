"""The port's cells and dry run against the JAX package's, on the CPU at
small size, over a (2, 2) mesh: every ``in_shardings`` spec of
``build_cell`` leaf by leaf and the argument bytes against
``memory_analysis().argument_size_in_bytes`` (JAX in a subprocess on 4
forced host devices, with ``get_config`` and ``SHAPES`` of its
``launch/cells.py`` replaced by reduced ones; nothing in ``src/repro/``
changes), for a train, prefill, decode and compressed decode cell; and the
record ``run_cell`` writes (in a subprocess: the fake process group)."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.compression import CompressionArtifact, CompressionPolicy, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells
from repro_torch.training.loop import _axes_trees

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-32b"
MESH = {"data": 2, "model": 2}
# name -> (kind, seq_len, global batch, compressed)
CELLS = {"train": ("train", 32, 8, False), "prefill": ("prefill", 32, 4, False),
         "decode": ("decode", 32, 4, False), "decode_compressed": ("decode", 32, 4, True)}
# a policy that compresses the reduced widths (d_model 64)
POLICY = dict(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.25, min_size=1024)

_JAX = r"""
import dataclasses, json, sys
import jax
from repro.compression import CompressionArtifact, CompressionPolicy, plan_compression
from repro.configs import get_config, reduced_for_smoke
from repro.configs.base import ShapeConfig
from repro.distributed.sharding import activation_rules
from repro.kernels import ops
from repro.launch import cells
from repro.launch.mesh import make_mesh, set_mesh
from repro.training.loop import _axes_trees

CELLS, POLICY, ARCH = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
cfg = reduced_for_smoke(get_config(ARCH))
cells.get_config = lambda a: cfg
mesh = make_mesh((2, 2), ("data", "model"))


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, tuple) and not hasattr(tree, "spec"):
        names = getattr(tree, "_fields", range(len(tree)))
        return {k2: v for n, t in zip(names, tree) for k2, v in flat(t, f"{prefix}/{n}").items()}
    if tree is None:
        return {prefix: None}
    return {prefix: [list(e) if isinstance(e, tuple) else e for e in tree.spec]}


out = {}
for name, (kind, S, B, compressed) in CELLS.items():
    cells.SHAPES = {name: ShapeConfig(name, kind, S, B)}
    art = None
    if compressed:
        shapes, _ = _axes_trees(cfg)
        art = CompressionArtifact.from_plan(plan_compression(shapes, CompressionPolicy(**POLICY)))
        ops.enable_kernels(interpret=True)
    else:
        ops.disable_kernels()
    cell = cells.build_cell(ARCH, name, mesh, artifact=art)
    with set_mesh(mesh), activation_rules(cell.pcfg, mesh):
        compiled = jax.jit(cell.fn, in_shardings=cell.in_shardings,
                           out_shardings=cell.out_shardings,
                           donate_argnums=cell.donate_argnums).lower(*cell.args).compile()
    out[name] = {"specs": flat(cell.in_shardings),
                 "argument_bytes": compiled.memory_analysis().argument_size_in_bytes}
print("RESULT " + json.dumps(out))
"""


def _norm(spec):
    """A spec as JAX's ``PartitionSpec`` normalises it: a 1-tuple is its
    axis, an empty tuple None, trailing Nones dropped."""
    if spec is None:
        return None
    out = [None if e in ((), []) else e[0] if isinstance(e, (list, tuple)) and len(e) == 1
           else (tuple(e) if isinstance(e, list) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k in tree for k2, v in _flat(tree[k], f"{prefix}/{k}").items()}
    if isinstance(tree, tuple):
        names = getattr(tree, "_fields", range(len(tree)))
        return {k2: v for n, t in zip(names, tree) for k2, v in _flat(t, f"{prefix}/{n}").items()}
    return {prefix: None if tree is None else tree.spec}


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_JAX), json.dumps(CELLS),
                        json.dumps(POLICY), ARCH], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def port_cells():
    cfg = reduced_for_smoke(get_config(ARCH))
    saved = cells.get_config
    cells.get_config = lambda a: cfg
    try:
        out = {}
        for name, (kind, S, B, compressed) in CELLS.items():
            art = None
            if compressed:
                shapes, _ = _axes_trees(cfg)
                art = CompressionArtifact.from_plan(plan_compression(shapes,
                                                                     CompressionPolicy(**POLICY)))
            out[name] = cells.build_cell(ARCH, ShapeConfig(name, kind, S, B), MESH, artifact=art)
        return out
    finally:
        cells.get_config = saved


@pytest.mark.parametrize("name", list(CELLS))
def test_build_cell_specs_match_jax(jax_cells, port_cells, name):
    want = {p: _norm(s) for p, s in jax_cells[name]["specs"].items()}
    got = {p: _norm(s) for p, s in _flat(port_cells[name].in_shardings).items()}
    assert got == want


@pytest.mark.parametrize("name", list(CELLS))
def test_argument_bytes_match_jax(jax_cells, port_cells, name):
    """Rank 0's boxes of every argument: JAX's per-device argument bytes."""
    assert cells.argument_bytes(port_cells[name]) == jax_cells[name]["argument_bytes"]


def test_train_cells_refuse_an_artifact():
    with pytest.raises(ValueError, match="compression artifacts only apply to serving"):
        cells.build_cell(ARCH, ShapeConfig("t", "train", 32, 8), MESH, artifact=object())


_RUN = r"""
import json, sys
import repro_torch.configs as C
from repro_torch.configs import reduced_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells, dryrun

red = reduced_for_smoke(C.get_config("qwen3-32b"))
C.get_config = cells.get_config = lambda a: red
rec = dryrun.run_cell("qwen3-32b", ShapeConfig("decode_32k", "decode", 32, 4), False, sys.argv[1],
                      mesh={"data": 2, "model": 2})
try:
    dryrun.run_cell("qwen3-32b", ShapeConfig("t", "train", 32, 8), False, None,
                    mesh={"data": 2, "model": 2}, compress=True)
except ValueError as e:
    print("REFUSED " + str(e))
from repro_torch.launch.fakeworld import fake_world
with fake_world((2,), ("data",)):
    try:
        with fake_world((2,), ("data",)):
            pass
    except RuntimeError as e:
        print("NESTED " + str(e))
import torch.distributed as dist
print("AFTER", dist.is_initialized())
print("RESULT " + json.dumps(rec))
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_RUN), str(out)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(next(ln for ln in r.stdout.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    return out, rec, r.stdout


def test_run_cell_writes_the_references_record(run):
    """The reference's keys, ``trace_s`` for ``lower_s``/``compile_s`` and
    the roofline terms beside them; argument bytes from the cell; every
    count finite; a train cell refuses compression."""
    out, rec, stdout = run
    assert "REFUSED compression artifacts only apply to serving" in stdout
    with open(out / "qwen3-32b__decode_32k__pod.json") as f:
        assert json.load(f) == rec
    jax_keys = {"arch", "shape", "mesh", "kind", "compressed", "pcfg", "memory", "cost",
                "collectives", "lower_s", "compile_s", "fits_hbm"}
    assert set(rec) == (jax_keys - {"lower_s", "compile_s"}) | {"trace_s", "roofline"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                  "alias_bytes", "per_device_total"}
    assert set(rec["cost"]) >= {"flops", "bytes", "transcendentals"}
    assert set(rec["collectives"]) == {"all-reduce", "all-gather", "reduce-scatter",
                                       "all-to-all", "collective-permute", "total", "counts"}
    assert rec["mesh"] == "data=2xmodel=2" and rec["fits_hbm"] is True
    assert rec["memory"]["alias_bytes"] > 0 and rec["cost"]["flops"] > 0
    assert rec["collectives"]["total"] > 0 and rec["roofline"]["bound_s"] > 0


_SHARED_TRAIN = r"""
import json
import repro_torch.configs as C
from repro_torch.configs import reduced_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells, costing, dryrun

red = reduced_for_smoke(C.get_config("zamba2-1.2b"))
C.get_config = cells.get_config = lambda a: red
shape = ShapeConfig("t", "train", 32, 8)
cc = costing.cost_cell("zamba2-1.2b", shape, mesh={"data": 2, "model": 2})
rec = dryrun.run_cell("zamba2-1.2b", shape, False, None, mesh={"data": 2, "model": 2})
print("RESULT " + json.dumps({"cost_cell": [cc["dot_flops"], cc["coll_bytes"]],
                              "run_cell": [rec["cost"]["dot_flops"],
                                           rec["collectives"]["total"]]}))
"""


def test_a_train_cell_with_a_shared_block_is_costed():
    """Reduced zamba2 (its shared attention block gathered once a forward,
    in the stem) costed as a train cell on a fake (2, 2) mesh by
    ``cost_cell`` and by ``run_cell``: both complete, with the same
    positive dot FLOPs and collective bytes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_SHARED_TRAIN)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(next(ln for ln in r.stdout.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    assert res["cost_cell"] == res["run_cell"]
    assert min(res["cost_cell"]) > 0


def test_fake_world_refuses_a_second_group(run):
    """Inside a fake world, another is refused (as is any process that
    already has a process group), and the group is gone after it."""
    stdout = run[2]
    assert "NESTED fake_world: this process already has a process group" in stdout
    assert "AFTER False" in stdout


def test_dataclass_overrides_reach_the_cell():
    cell = cells.build_cell(ARCH, "decode_32k", MESH, microbatches=1, optimizer="adafactor")
    assert dataclasses.asdict(cell.pcfg)["optimizer"] == "adafactor"


@pytest.mark.parametrize("pos,S,L,ring", [(0, 5, 8, False), (6, 5, 8, False), (3, 1, 8, True),
                                          (5, 4, 8, True), (3, 12, 8, True), (0, 8, 8, True)])
def test_slots_place_tokens_as_the_whole_cache_write(pos, S, L, ring):
    """``_slots`` (the runs a sharded cache write splits into) puts every
    token where ``_write_cache`` puts it in a whole cache."""
    import torch

    from repro_torch.models import attention

    k = torch.arange(1, S + 1, dtype=torch.float32).reshape(1, S, 1, 1)
    want = attention._write_cache({"k": torch.zeros(1, L, 1, 1), "v": torch.zeros(1, L, 1, 1)},
                                  k, k, pos, False, ring)["k"]
    got = torch.zeros(1, L, 1, 1)
    for t, slot, n in attention._slots(pos, S, L, ring):
        got[:, slot:slot + n] = k[:, t:t + n]
    assert torch.equal(got, want)


# label -> (architecture, vocabulary (None: the reduced config's 257),
# ParallelConfig overrides): ``dp_includes_model`` keeps the whole mesh
# data-parallel, the weights gathered whole and no collective along ``model``
SERVING_ARCHS = {"qwen3-32b": ("qwen3-32b", None, {}), "qwen3-32b/v256": ("qwen3-32b", 256, {}),
                 "qwen3-32b/dp_includes_model": ("qwen3-32b", None,
                                                 {"dp_includes_model": True}),
                 "granite-moe-1b-a400m": ("granite-moe-1b-a400m", 256, {}),
                 "mamba2-130m": ("mamba2-130m", None, {}), "zamba2-1.2b": ("zamba2-1.2b", None, {})}


def _serving_ranks(rank, world):
    """On a (1, 2) gloo mesh: the prefill and decode cells' steps on real
    DTensors (tensor- and expert-parallel along ``model``: each rank its
    heads, kv heads, mlp and experts, and its vocabulary box where 2
    divides it; weights gathered a group at a time, the KV cache sequence-
    sharded over ``model``, the SSM states head-sharded) against the plain
    forward on whole tensors, for attention, MoE, SSM and hybrid models;
    and qwen3-32b with ``dp_includes_model`` (no tensor parallelism)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import forward, init_cache, init_model
    from repro_torch.models.params import split

    mesh = make_mesh((1, 2), ("data", "model"), "cpu")
    B, S = 2, 16

    def placed(tree, sh):
        return cells._tree_map(lambda x, ns: ns.shard(x), tree, sh)

    def cache_err(c_dt, cache):
        return max(float((shd.local_value(d) - x[shd.dtensor_box(d)]).abs().max())
                   for d, x in zip(cells._leaves(c_dt), cells._leaves(cache)))

    rows_whole, whole = shd.rows_whole, []
    shd.rows_whole = lambda x, d: (whole.append(x.shape), rows_whole(x, d))[1]
    out = {}
    for label, (arch, vocab, over) in SERVING_ARCHS.items():
        whole.clear()
        cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype="float32",
                                  vocab_size=vocab or 257)
        cells.get_config = lambda a, cfg=cfg: cfg
        params = split(init_model(cfg, seed=0, device="cpu"))[0]
        toks = torch.randint(0, cfg.vocab_size, (B, S),
                             generator=torch.Generator().manual_seed(1))
        cache = init_cache(cfg, B, S, device="cpu")
        pre = cells.build_cell(arch, ShapeConfig("p", "prefill", S, B), mesh, **over)
        p_dt, c_dt = placed(params, pre.in_shardings[0]), placed(cache, pre.in_shardings[2])
        tok_dt = pre.in_shardings[1]["tokens"].shard(toks)
        got, _ = pre.fn(p_dt, {"tokens": tok_dt}, c_dt)
        want, _, _ = forward(params, {"tokens": toks}, cfg, cache=cache, pos_offset=0,
                             last_only=True)
        r = {"prefill_logits": float((got - want[:, -1]).abs().max()),
             "prefill_cache": cache_err(c_dt, cache)}
        dec = cells.build_cell(arch, ShapeConfig("d", "decode", S, B), mesh, **over)
        tok = toks[:, -1]
        got, _ = dec.fn(p_dt, dec.in_shardings[1].shard(tok), c_dt,
                        torch.zeros((), dtype=torch.int32))
        want, _, _ = forward(params, {"tokens": tok[:, None]}, cfg, cache=cache, pos_offset=S - 1)
        r.update(decode_logits=float((got - want[:, 0]).abs().max()),
                 decode_cache=cache_err(c_dt, cache), scale=float(want.abs().max()),
                 cache_scale=max(float(x.abs().max()) for x in cells._leaves(cache)),
                 made_whole=[list(x) for x in whole],
                 state_shapes=[list(x.shape) for p, x in cells._paths(cache)
                               if p.endswith("/state")])
        out[label] = r
    return out


def test_serving_steps_on_a_mesh_match_the_plain_forward(tmp_path):
    """Each rank's prefill and decode logits within 1e-5 of max|logit| of
    the plain forward's (f32; the row-parallel products' partial sums and
    flash-decode add in another order), and its boxes of the cache the
    plain forward's within 1e-5 of max|cache| (a later layer's inputs come
    from the earlier layers' sums over ``model``); without tensor
    parallelism (``dp_includes_model``) the prefill's KV exactly.  The SSM
    models' states are used in place as the rank's boxes of the heads."""
    from repro_torch.distributed.local_ranks import run_ranks

    for ranks in run_ranks(_serving_ranks, 2, str(tmp_path)):
        assert sorted(ranks) == sorted(SERVING_ARCHS)
        for arch, r in ranks.items():
            if arch == "qwen3-32b/dp_includes_model":
                assert r["prefill_cache"] == 0.0, arch
            assert r["prefill_cache"] <= 1e-5 * r["cache_scale"], arch
            assert r["decode_cache"] <= 1e-5 * r["cache_scale"], arch
            assert max(r["prefill_logits"], r["decode_logits"]) <= 1e-5 * r["scale"], arch
            if arch in ("mamba2-130m", "zamba2-1.2b"):
                # the conv windows made whole, never a state
                assert r["made_whole"] and r["state_shapes"], arch
                assert not any(x in r["state_shapes"] for x in r["made_whole"]), arch
