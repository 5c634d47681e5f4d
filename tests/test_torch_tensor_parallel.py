"""Tensor and expert parallelism along ``model`` on four gloo ranks against
the JAX package's sharded step on four forced host devices.

Each case trains a reduced config two steps (microbatches 2) on the same
mesh in both, from JAX's own initial state (saved by JAX's checkpointer,
restored shard by shard by the port), and compares losses, grad norms and
the updated parameters at ``tests/test_torch_multirank_train.py``'s
tolerances.  The cases cover what the port's tensor-parallel step must get
right: kv shards smaller than a head (2 kv heads on 4 ranks), a vocabulary
that ``model`` divides (vocab-parallel embedding, head and CE, tied and
untied) and one that it does not (257: replicated), expert parallelism (2
and 1 experts a rank), ``dp_includes_model``, which keeps the whole
mesh data-parallel, and the SSM layers of zamba2 and mamba2 (each rank its
heads, the fused ``in_proj``'s columns moved by an all-to-all).  The
gathers the step issues are recorded: no weight with a dim on ``model`` is
gathered over ``model``."""

import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS, MICRO, SEQ, BATCH = 2, 2, 32, 8
LOSS_TOL, PARAM_TOL, NORM_TOL = 1e-6, 1e-4, 1e-5
# name -> (arch, mesh shape, vocab (None: the reduced config's 257), dp_includes_model)
CASES = {
    "qwen_1x4_v256": ("qwen3-32b", (1, 4), 256, False),
    "granite_2x2": ("granite-moe-1b-a400m", (2, 2), None, False),
    "granite_1x4_v256": ("granite-moe-1b-a400m", (1, 4), 256, False),
    "qwen_1x4_dp_includes_model": ("qwen3-32b", (1, 4), None, True),
}
# the SSM cases, run by a fixture of their own: a rank's 128 rows take
# in_proj's weight route (its needed columns of the weight moved)
SSM_CASES = {
    "zamba2_1x4": ("zamba2-1.2b", (1, 4), None, False),
    "mamba2_1x4": ("mamba2-130m", (1, 4), None, False),
}

JAX_TRAIN = """
import dataclasses, json, sys
import numpy as np
import jax
from repro.launch.mesh import make_mesh, set_mesh
from repro.configs import get_config, reduced_for_smoke
from repro.configs.base import ParallelConfig, ShapeConfig
from repro.training import init_train_state, make_train_step, state_shardings
from repro.distributed.sharding import activation_rules
from repro.data.pipeline import make_pipeline
from repro.optim import warmup_cosine
from repro.checkpoint.manager import CheckpointManager
from repro.compression.plan import tree_paths

out = sys.argv[1]
for name, (arch, shape, vocab, dpm) in json.loads(sys.argv[2]).items():
    mesh = make_mesh(tuple(shape), ("data", "model"))
    cfg = reduced_for_smoke(get_config(arch))
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    pcfg = ParallelConfig(mesh_shape=tuple(shape), mesh_axes=("data", "model"),
                          microbatches={micro}, dp_includes_model=dpm)
    state = init_train_state(jax.random.PRNGKey(0), cfg, pcfg, mesh)
    sh = state_shardings(cfg, pcfg, mesh)
    mgr = CheckpointManager(f"{{out}}/{{name}}/jax_init", keep_last=1)
    mgr.save(0, state); mgr.wait()
    step_fn = make_train_step(cfg, pcfg, warmup_cosine(1e-2, 1, 8))
    pipe = make_pipeline(cfg, ShapeConfig("t", "train", {seq}, {batch}), mesh)
    losses, norms = [], []
    with set_mesh(mesh), activation_rules(pcfg, mesh):
        jstep = jax.jit(step_fn, in_shardings=(sh, None), out_shardings=(sh, None))
        for i in range({steps}):
            state, m = jstep(state, pipe.batch_at(i))
            losses.append(float(m["loss"])); norms.append(float(m["grad_norm"]))
    np.savez(f"{{out}}/{{name}}/ref.npz", losses=np.array(losses), norms=np.array(norms),
             **{{"p:" + p: np.asarray(x, np.float32) for p, x in tree_paths(state.params)}})
print("JAX_OK")
"""


def _cfgs(arch, shape, vocab, dpm):
    import dataclasses

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.configs.base import ParallelConfig

    cfg = reduced_for_smoke(get_config(arch))
    if vocab:
        cfg = dataclasses.replace(cfg, vocab_size=vocab)
    return cfg, ParallelConfig(mesh_shape=shape, mesh_axes=("data", "model"),
                               microbatches=MICRO, dp_includes_model=dpm)


def _tp_ranks(rank, world, out, cases):
    """Every case on this rank: restore JAX's initial state, train, record
    the step's gathers and model collectives, return the metrics and
    (rank 0) the whole final parameters."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression.plan import tree_paths
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import warmup_cosine
    from repro_torch.training import init_train_state, make_train_step, state_shardings

    res = {}
    for name, (arch, shape, vocab, dpm) in cases.items():
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        cfg, pcfg = _cfgs(arch, shape, vocab, dpm)
        sh = state_shardings(cfg, pcfg, mesh)
        _, state = CheckpointManager(f"{out}/{name}/jax_init").restore_latest(
            init_train_state(0, cfg, pcfg, device="meta"), shardings=sh)
        stored = {p: (tuple(x.shape), ns.spec) for (p, x), (_, ns)
                  in zip(tree_paths(state.params), tree_paths(sh.params))}
        step_fn = make_train_step(cfg, pcfg, warmup_cosine(1e-2, 1, 8))
        pipe = make_pipeline(cfg, ShapeConfig("t", "train", SEQ, BATCH), mesh)
        gathers, model_colls = [], []
        fwd = shd._GatherParam.forward
        fns = {f: getattr(shd, f) for f in ("_all_gather", "_reduce_scatter", "_all_reduce",
                                            "_all_to_all")}

        def rec(ctx, local, sharding, shp, *a, fwd=fwd, gathers=gathers):
            y = fwd(ctx, local, sharding, shp, *a)
            gathers.append((a[-1], tuple(y.shape)))
            return y

        def counted(f, kind, model_colls=model_colls):
            return lambda *a, **k: (model_colls.append(kind), f(*a, **k))[1]

        metrics = []
        for i in range(STEPS):
            if i == 0:
                shd._GatherParam.forward = staticmethod(rec)
                for f, fn in fns.items():
                    setattr(shd, f, counted(fn, f))
            try:
                state, m = step_fn(state, pipe.batch_at(i))
            finally:
                shd._GatherParam.forward = staticmethod(fwd)
                for f, fn in fns.items():
                    setattr(shd, f, fn)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        full = {p: shd.full_value(x).float().clone() for p, x in tree_paths(state.params)}
        res[name] = {"metrics": metrics, "gathers": gathers, "stored": stored,
                     "model_colls": model_colls, "full": full if rank == 0 else None}
        del state, step_fn
    return res


def _run_cases(tmp_path_factory, cases: dict):
    """JAX's references for ``cases`` in a subprocess, then the port's four
    ranks: (references by case, each rank's results)."""
    from repro_torch.distributed.local_ranks import run_ranks

    out = str(tmp_path_factory.mktemp("tp"))
    code = textwrap.dedent(JAX_TRAIN.format(micro=MICRO, seq=SEQ, batch=BATCH, steps=STEPS))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code, out, json.dumps(cases)],
                       capture_output=True, text=True, timeout=400, env=env)
    assert r.returncode == 0 and "JAX_OK" in r.stdout, r.stderr[-3000:]
    refs = {name: dict(np.load(f"{out}/{name}/ref.npz")) for name in cases}
    return refs, run_ranks(_tp_ranks, 4, out + "/w", out, cases)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_cases(tmp_path_factory, CASES)


@pytest.fixture(scope="module")
def ssm_runs(tmp_path_factory):
    return _run_cases(tmp_path_factory, SSM_CASES)


def _case_runs(request, name):
    return request.getfixturevalue("ssm_runs" if name in SSM_CASES else "runs")


ALL_CASES = {**CASES, **SSM_CASES}


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_tensor_parallel_step_matches_jax(request, name):
    """Two steps: every rank's loss and grad norm equal JAX's sharded
    step's within the unsharded parity's tolerances, and so do the final
    parameters."""
    refs, ranks = _case_runs(request, name)
    ref = refs[name]
    for r in ranks:
        got = r[name]["metrics"]
        assert got == ranks[0][name]["metrics"]
        for (loss, norm), jl, jn in zip(got, ref["losses"], ref["norms"]):
            assert abs(loss - jl) <= LOSS_TOL * abs(jl), (loss, jl)
            assert abs(norm - jn) <= NORM_TOL * abs(jn), (norm, jn)
    full = ranks[0][name]["full"]
    params = {k[2:]: v for k, v in ref.items() if k.startswith("p:")}
    assert sorted(params) == sorted(full)
    for p, j in params.items():
        t = full[p].numpy()
        assert np.abs(t - j).max() <= PARAM_TOL * max(np.abs(j).max(), 1e-30), p


@pytest.mark.parametrize("name", list(ALL_CASES))
def test_no_model_sharded_weight_is_gathered_over_model(request, name):
    """Every gather the first step issues keeps a dim on ``model`` at the
    rank's box (the weights' ``data`` part alone is gathered; on one data
    rank such a weight is not gathered at all), each group's weights are
    gathered in the forward and again in the recompute, and collectives
    along ``model`` run exactly when the rules put something there: none
    with ``dp_includes_model``; the SSM layers move their columns by
    all-to-all."""
    _, ranks = _case_runs(request, name)
    arch, shape, _, dpm = ALL_CASES[name]
    m = shape[1]
    for r in ranks:
        rec = r[name]
        assert rec["gathers"]
        stored = rec["stored"]
        on_model = 0
        for path, out in rec["gathers"]:
            gshape, spec = stored[path]
            lead = 1 if path.startswith("groups/") else 0
            for t, e in enumerate(spec[lead:]):
                axes = e if isinstance(e, tuple) else (e,)
                if "model" in axes:
                    on_model += 1
                    assert out[t] == gshape[t + lead] // m, (path, out, gshape, spec)
        # with one data rank a weight's model box needs no gather at all
        assert (on_model > 0) == (not dpm and shape[0] > 1)
        n_groups = sum(1 for p, _ in rec["gathers"] if p == "groups/0/norm1/scale")
        assert n_groups >= 2 * MICRO * 2           # fwd + recompute, each microbatch, 2 groups
        assert bool(rec["model_colls"]) == (not dpm)
        if not dpm:
            assert {"_all_gather", "_reduce_scatter", "_all_reduce"} <= set(rec["model_colls"])
        assert ("_all_to_all" in rec["model_colls"]) == (name in SSM_CASES)


_FLOPS = r"""
import dataclasses, json
import repro_torch.configs as C
from repro_torch.configs import reduced_for_smoke
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import cells, costing

red = dataclasses.replace(reduced_for_smoke(C.get_config("qwen3-32b")), vocab_size=256)
C.get_config = cells.get_config = lambda a: red
out = {}
for m in (1, 4):
    cc = costing.cost_cell("qwen3-32b", ShapeConfig("t", "train", 64, 8),
                           mesh={"data": 1, "model": m})
    out[m] = {k: cc[k] for k in ("dot_flops", "flops", "coll_bytes")}
print("RESULT " + json.dumps(out))
"""


def test_per_rank_dot_flops_divide_by_the_model_axis():
    """Reduced qwen3-32b (vocab 256, so every TP dim divides) costed on a
    fake (1, 4) mesh: each rank's dot FLOPs are the (1, 1) step's / 4
    within 1%, where a data-parallel step along ``model`` repeats them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_FLOPS)], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(next(ln for ln in r.stdout.splitlines()
                          if ln.startswith("RESULT "))[len("RESULT "):])
    one, four = res["1"]["dot_flops"], res["4"]["dot_flops"]
    assert abs(four - one / 4) <= 0.01 * one / 4, (one, four)
    assert res["4"]["coll_bytes"] > 0


# (label, arch, overrides, model ranks, in_proj and out_proj compressed)
SHARE_CASES = [
    ("kv_box_half_a_head", "qwen3-32b", {}, 4, False),
    ("kv_heads_aligned", "qwen3-32b", {"num_heads": 8, "num_kv_heads": 4}, 2, False),
    ("q_heads_across_kv_groups", "qwen3-32b", {"num_heads": 12, "num_kv_heads": 3,
                                               "d_model": 96}, 4, False),
    ("q_box_splits_a_head", "qwen3-32b", {"num_heads": 6, "num_kv_heads": 6, "d_model": 96}, 4,
     False),
    ("only_the_carry_divides", "qwen3-32b", {"num_heads": 5, "num_kv_heads": 5,
                                             "d_model": 96}, 3, False),
    ("mha_with_biases", "musicgen-medium", {}, 2, False),
    ("parallel_block", "command-r-plus-104b", {}, 2, False),
    ("experts_on_model", "granite-moe-1b-a400m", {}, 4, False),
    ("experts_fall_back_to_mlp", "granite-moe-1b-a400m", {"num_experts": 3}, 2, False),
    ("ssm_and_shared_block", "zamba2-1.2b", {}, 2, False),
    ("ssm_box_splits_a_head", "mamba2-130m", {"d_model": 96, "ssm_headdim": 32}, 4, False),
    ("ssm_weight_route", "mamba2-130m", {"d_model": 16, "ssm_headdim": 8}, 4, False),
    ("ssm_compressed_projections", "zamba2-1.2b", {}, 2, True),
]


def _compressed_block(values, axes):
    """``values`` with its ``w`` leaves of at least 4,096 elements
    compressed on the CPU (``execute_plan``, tiles of 16 x 8), and a
    function of a mesh giving their shardings: the compressed leaves
    replicated, as the serving cells place them."""
    from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
    from repro_torch.compression.plan import tree_paths
    from repro_torch.distributed import sharding as shd

    policy = CompressionPolicy(method="greedy", tile_n=16, tile_d=8, rank_ratio=0.5,
                               min_size=4096)
    plan = plan_compression(values, policy)
    new, _ = execute_plan(plan, values, device="cpu")
    packed = {p for p, x in tree_paths(new) if p.endswith(("/m_packed", "/C"))}
    assert {p.rsplit("/", 2)[0] for p in packed} == {"ssm/in_proj", "ssm/out_proj"}, packed

    def shardings(rules, mesh):
        def walk(v, a, path):
            if isinstance(v, dict) and "m_packed" in v:
                return {k: shd.NamedSharding(mesh, ()) for k in v}
            if isinstance(v, dict):
                return {k: walk(v[k], a[k], f"{path}/{k}") for k in v}
            return shd.NamedSharding(mesh, shd.spec_for(a, tuple(v.shape), rules, mesh))
        return walk(new, axes, "")

    return new, shardings


@pytest.mark.parametrize("label,arch,over,m,compressed", SHARE_CASES,
                         ids=[c[0] for c in SHARE_CASES])
def test_rank_shares_join_to_the_whole_block(label, arch, over, m, compressed):
    """One block (f32, reduced widths) computed whole and as each rank's
    share along ``model`` = m, the ranks one after another
    (``model_parallel`` with a stand-in group): the shares' carries,
    joined, equal the whole block's within f32 rounding, for kv boxes of
    half a head, q heads that straddle kv groups (one kv head a q head), a
    q box that splits a head (every head computed), heads, kv, mlp or
    experts that ``model`` does not divide (whole, counted once, or the
    experts' mlp on ``model``), biases added once, the parallel block,
    zamba2's SSM (each rank its heads, the fused columns' product moved)
    with its tensor-parallel shared block, an SSM whose ``d_inner`` box
    splits a head (every head computed, the box's channels for the norm
    and ``out_proj``), one whose rank rows exceed ``d_model`` (the weight's
    columns moved) and compressed (whole) ``in_proj`` and ``out_proj``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.local_ranks import RankMesh, local_boxes, run_in_turns
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import split

    cfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), **over)
    kind = cfg.block_pattern[-1]
    g = torch.Generator().manual_seed(0)
    values, axes = split(tr._init_block(g, kind, cfg, torch.float32))
    block_shardings = functools.partial(shd.param_shardings, axes, values)
    if compressed:
        values, block_shardings = _compressed_block(values, axes)
    shared = shared_axes = None
    if kind == "ssm_attn":
        shared, shared_axes = split(tr._init_shared_attn(g, cfg, torch.float32))
    if cfg.use_bias:      # nonzero biases, so that adding one once is seen
        values = {k: v for k, v in values.items()}
        for sub in ("attn", "mlp"):
            for w in values.get(sub, {}).values():
                if isinstance(w, dict) and "b" in w:
                    w["b"] = torch.randn(w["b"].shape, generator=g)
    x = torch.randn((2, 16, cfg.d_model), generator=g)
    kw = dict(cache=None, pos_offset=0, window=cfg.sliding_window)
    whole, _, aux = tr._apply_block(x, values, kind, cfg, shared, **kw)
    rules = shd.make_rules(ParallelConfig(mesh_shape=(1, m), mesh_axes=("data", "model")))
    d = cfg.d_model // m if cfg.d_model % m == 0 else cfg.d_model

    def share(r, grp):
        sh = {"block": block_shardings(rules, RankMesh(m, r))}
        local = {"block": local_boxes(values, sh["block"])}
        if shared is not None:
            sh["shared"] = shd.param_shardings(shared_axes, shared, rules, RankMesh(m, r))
            local["shared"] = local_boxes(shared, sh["shared"])
        with torch.no_grad(), shd.gathering(sh, None, (), torch.float32), \
                shd.model_parallel((grp, m, r)):
            p = shd.gather_params(local["block"], "block")
            sp = shd.gather_params(local["shared"], "shared") if shared is not None else None
            xr = x[..., r * d:(r + 1) * d] if d < cfg.d_model else x
            return tr._apply_block(xr, p, kind, cfg, sp, **kw)

    outs, passes, _ = run_in_turns(share, m)
    shares = [y for y, _, _ in outs]
    a = outs[-1][2]
    joined = torch.cat(shares, -1) if d < cfg.d_model else shares[0]
    assert passes > 1                     # the share ran collectives along model
    err = float((joined - whole).abs().max())
    assert err <= 1e-5 * float((whole - x).abs().max()), (label, err)
    assert abs(float(a) - float(aux)) <= 1e-5 * max(abs(float(aux)), 1.0)


@pytest.mark.parametrize("route,seq", [("activation", 16), ("weight", 48)])
def test_ssm_share_moves_columns_and_gathers_no_projection(route, seq):
    """Reduced zamba2's SSM layer as four ranks' shares: no rank gathers
    ``in_proj``, ``out_proj`` or the norm's scale over ``model`` (only the
    conv weights, a few KiB), the fused columns move by all-to-all (the
    product's at 32 rows a rank, the weight's at 96 > ``d_model``), and the
    SSD runs on the rank's nh / 4 heads."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.local_ranks import RankMesh, local_boxes, run_in_turns
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import split

    m = 4
    cfg = reduced_for_smoke(get_config("zamba2-1.2b"))
    cfg = dataclasses.replace(cfg, block_pattern=("ssm",), num_layers=cfg.num_groups)
    g = torch.Generator().manual_seed(0)
    values, axes = split(tr._init_block(g, "ssm", cfg, torch.float32))
    x = torch.randn((2, seq, cfg.d_model), generator=g)
    kw = dict(cache=None, pos_offset=0, window=0)
    whole, _, _ = tr._apply_block(x, values, "ssm", cfg, **kw)
    rules = shd.make_rules(ParallelConfig(mesh_shape=(1, m), mesh_axes=("data", "model")))
    gathered, moved, heads = [], [], []
    fns = shd._all_gather, shd._all_to_all, ssm._ssd

    def rec_gather(x, dim, *a):
        gathered.append(tuple(x.shape))
        return fns[0](x, dim, *a)

    def rec_move(x, send, recv, group):
        moved.append((tuple(x.shape), sum(recv)))
        return fns[1](x, send, recv, group)

    def rec_ssd(u, *a):
        heads.append(u.shape[2])
        return fns[2](u, *a)

    def share(r, grp):
        sh = shd.param_shardings(axes, values, rules, RankMesh(m, r))
        with torch.no_grad(), shd.gathering({"b": sh}, None, (), torch.float32), \
                shd.model_parallel((grp, m, r)):
            p = shd.gather_params(local_boxes(values, sh), "b")
            d = cfg.d_model // m
            return tr._apply_block(x[..., r * d:(r + 1) * d], p, "ssm", cfg, **kw)[0]

    shd._all_gather, shd._all_to_all, ssm._ssd = rec_gather, rec_move, rec_ssd
    try:
        outs, _, _ = run_in_turns(share, m)
    finally:
        shd._all_gather, shd._all_to_all, ssm._ssd = fns
    err = float((torch.cat(outs, -1) - whole).abs().max())
    assert err <= 1e-5 * float((whole - x).abs().max()), err
    di, ds, nh, d = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.d_model
    conv_dim = di + 2 * ds
    # the carry before the norm, then the conv weights' boxes: nothing else
    assert set(gathered) <= {(2, seq, d // m), (cfg.ssm_dconv, conv_dim // m),
                             (conv_dim // m,)}, gathered
    need = 2 * di // m + 2 * ds + nh // m
    # each rank sends columns of its box and receives its heads' columns:
    # of the product (their rows after them) or of the weight (d_model)
    assert moved and all(n == need and x[0] <= need * m for x, n in moved), moved
    rest = (2, seq) if route == "activation" else (d,)
    assert all(x[1:] == rest for x, _ in moved), moved
    assert set(heads) == {nh // m}, heads


def test_a_weight_without_its_placement_fails_loudly():
    """Under ``model_parallel`` a layer that reads a weight whose mark an
    op dropped (here a clone of the gathered boxes) raises, where reading
    the rank's box as a whole weight would drop the other ranks' terms
    without a sound; the marked weights compute."""
    import torch

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.local_ranks import RankMesh, TurnGroup, local_boxes
    from repro_torch.models import layers
    from repro_torch.models.params import split

    g = torch.Generator().manual_seed(0)
    values, axes = split(layers.init_mlp(g, 16, 32, torch.float32))
    rules = shd.make_rules(ParallelConfig(mesh_shape=(1, 2), mesh_axes=("data", "model")))
    sh = shd.param_shardings(axes, values, rules, RankMesh(2, 0))
    x = torch.randn((2, 3, 16), generator=g)
    with torch.no_grad(), shd.gathering({"mlp": sh}, None, (), torch.float32), \
            shd.model_parallel((TurnGroup(2), 2, 0)):
        p = shd.gather_params(local_boxes(values, sh), "mlp")
        assert [shd.tp_dim(p[n]["w"]) for n in ("gate", "up", "down")] == [1, 1, 0]
        assert layers.mlp(x, p).shape == x.shape
        dropped = {n: {"w": w["w"].clone()} for n, w in p.items()}
        with pytest.raises(ValueError, match="placement along model"):
            layers.mlp(x, dropped)
