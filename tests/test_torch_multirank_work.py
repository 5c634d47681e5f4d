"""The sharded compression pool and the meshed training launcher on gloo
ranks: ``execute_plan(mesh=)`` on four ranks gives the single process's
artifact byte for byte (and says which chunks ran replicated), and
``train_once`` on a 2-rank mesh, killed and resumed, gives the losses of
an uninterrupted run and of the unsharded launcher."""

import contextlib
import io
import json

import pytest
import torch

from repro_torch import compression as tc
from repro_torch.compression.plan import tree_paths
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.distributed.local_ranks import run_ranks
from repro_torch.launch import train as train_cli
from repro_torch.models import init_model
from repro_torch.models.params import split

torch.set_num_threads(1)

_POLICY = dict(method="alternating", tile_d=32, min_size=1024, bbo_iters=4)
_RULES = (dict(pattern=r"attn/w[kv]", method="bbo", rank_ratio=0.375),
          dict(pattern=r"mlp/up", method="int8"))


def _plan():
    values = split(init_model(reduced_for_smoke(get_config("qwen3-32b")), device="cpu"))[0]
    policy = tc.CompressionPolicy(**_POLICY, rules=tuple(tc.CompressionRule(**r) for r in _RULES))
    return values, tc.plan_compression(values, policy)


def _execute_ranks(rank, world, max_pool_tiles):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    values, plan = _plan()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cv, art = tc.execute_plan(plan, values, device="cpu", mesh=mesh,
                                  max_pool_tiles=max_pool_tiles)
    return dict(tree_paths(cv)), json.dumps(art.manifest, sort_keys=True), buf.getvalue()


@pytest.mark.parametrize("max_pool_tiles", ["auto", 6])
def test_execute_with_mesh_matches_unsharded(tmp_path, max_pool_tiles):
    """Greedy/alternating, BBO and int8 pools: every rank's compressed
    tree and manifest equal the single process's; a chunk whose tiles the
    4-rank mesh does not divide runs replicated with the reference's line,
    and every other chunk is sharded."""
    values, plan = _plan()
    cv, art = tc.execute_plan(plan, values, device="cpu", max_pool_tiles=max_pool_tiles)
    ref, manifest = dict(tree_paths(cv)), json.dumps(art.manifest, sort_keys=True)
    got = run_ranks(_execute_ranks, 4, str(tmp_path), max_pool_tiles)
    replicated = [(p["method"], ci, n) for p in art.manifest["pools"]
                  for ci, n in enumerate(p["chunk_sizes"]) if n % 4]
    sharded = [(p["method"], n) for p in art.manifest["pools"]
               for n in p["chunk_sizes"] if n % 4 == 0]
    if max_pool_tiles == "auto":
        assert {m for m, _ in sharded} >= {"bbo", "alternating", "int8"}
    else:
        assert replicated and sharded
    for leaves, man, out in got:
        assert sorted(leaves) == sorted(ref)
        for k, v in ref.items():
            assert v.dtype == leaves[k].dtype and torch.equal(v, leaves[k]), k
        assert man == manifest
        lines = [ln for ln in out.splitlines() if "running replicated" in ln]
        assert len(lines) == len(replicated)
        for (method, ci, n), line in zip(replicated, lines):
            assert line.startswith(f"[compress] pool {method} ") and f"chunk {ci}: {n} tiles " \
                f"do not divide the 4-device mesh; running replicated" in line


def _args(ckpt_dir, **over):
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "6", "--seq-len", "32",
            "--batch", "4", "--microbatches", "2", "--warmup", "2", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "3", "--keep-last", "1", "--log-every", "1", "--mesh", "2x1"]
    for k, v in over.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return train_cli.build_parser().parse_args(argv)


def _train_ranks(rank, world, root):
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.fault_tolerance import run_with_restarts

    out = {}
    for name, over in (("clean", {}), ("killed", {"fail_at_step": 5})):
        ev = []
        box = {}

        def attempt(a, name=name, over=over, ev=ev, box=box):
            box["state"] = train_cli.train_once(_args(f"{root}/{name}", **over), a, device="cpu",
                                                report=ev.append)

        restarts = run_with_restarts(attempt, max_restarts=1)
        out[name] = (restarts, ev, {p: shd.full_value(x).clone()
                                    for p, x in tree_paths(box["state"])})
    return out


def test_train_once_on_a_mesh_killed_and_resumed(tmp_path):
    """``--mesh 2x1`` on two ranks: attempt 0 raises at step 5 and attempt
    1 resumes from step 3's sharded checkpoint; the recomputed steps'
    losses and the final state equal the uninterrupted run's bit for bit,
    on both ranks, and the losses equal the unsharded launcher's."""
    got = run_ranks(_train_ranks, 2, str(tmp_path / "ranks"), str(tmp_path))
    for r in got:
        n0, ev0, clean = r["clean"]
        n1, ev1, resumed = r["killed"]
        assert (n0, n1) == (0, 1)
        assert [(e["attempt"], e["step"]) for e in ev1 if e["event"] == "resume"] == [(1, 3)]
        loss0 = {e["step"]: e["loss"] for e in ev0 if e["event"] == "step"}
        for e in ev1:
            if e["event"] == "step":
                assert e["loss"] == loss0[e["step"]], e
        for p, x in clean.items():
            assert torch.equal(x, resumed[p]), p
        assert loss0 == {e["step"]: e["loss"] for e in got[0]["clean"][1]
                         if e["event"] == "step"}
    single = []
    train_cli.train_once(_args(tmp_path / "single", mesh="1x1"), 0, device="cpu",
                         report=single.append)
    for e in single:
        if e["event"] == "step":
            want = loss0[e["step"]]
            assert abs(e["loss"] - want) <= 1e-6 * abs(want), (e, want)


# Adafactor factors the moments of every leaf whose two trailing dims reach
# this (the default, 128, is above the reduced configs' widths)
_FACTORED_FROM = 32


def _step_setup(optimizer, dp_includes_model, mesh_shape):
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.optim import adafactor, adamw, warmup_cosine
    from repro_torch.training import loop

    loop.make_optimizer = lambda pcfg: {"adamw": adamw, "adafactor": lambda: adafactor(
        min_dim_factored=_FACTORED_FROM)}[pcfg.optimizer]()
    cfg = reduced_for_smoke(get_config("granite-moe-1b-a400m"))
    pcfg = ParallelConfig(mesh_shape=mesh_shape, mesh_axes=("data", "model"), microbatches=2,
                          optimizer=optimizer, dp_includes_model=dp_includes_model)
    return (cfg, pcfg, loop.make_train_step(cfg, pcfg, warmup_cosine(1e-2, 1, 8)),
            ShapeConfig("t", "train", 32, 8))


def _sharded_steps(rank, world, optimizer, dp_includes_model):
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.training import loop

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    cfg, pcfg, step_fn, shape = _step_setup(optimizer, dp_includes_model, (2, 2))
    state = loop.init_train_state(0, cfg, pcfg, mesh=mesh)
    placed = {p: shd.is_whole(x) for p, x in tree_paths(state)}
    pipe = make_pipeline(cfg, shape, mesh)
    metrics = []
    for i in range(2):
        state, m = step_fn(state, pipe.batch_at(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, placed, {p: shd.full_value(x).clone() for p, x in tree_paths(state)}


@pytest.mark.parametrize("optimizer,dp_includes_model", [("adafactor", False), ("adamw", True)])
def test_sharded_step_matches_the_unsharded_step(tmp_path, monkeypatch, optimizer,
                                                 dp_includes_model):
    """Two steps of the reduced granite-moe (MoE balance loss over the dp
    group, 2 microbatches) on four gloo ranks against the unsharded step on
    one process: Adafactor with factored (replicated) moments and sharded
    ones, updated one whole leaf at a time; AdamW with the batch over the
    whole mesh.  Losses and norms within 1e-6 and 1e-5, the state within
    1e-4 of each leaf's largest value."""
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.training import loop

    monkeypatch.setattr(loop, "make_optimizer", loop.make_optimizer)
    cfg, pcfg, step_fn, shape = _step_setup(optimizer, dp_includes_model, (1, 1))
    state = loop.init_train_state(0, cfg, pcfg, device="cpu")
    pipe = make_pipeline(cfg, shape, device="cpu")
    want = []
    for i in range(2):
        state, m = step_fn(state, pipe.batch_at(i))
        want.append((float(m["loss"]), float(m["grad_norm"])))
    ref = dict(tree_paths(state))
    got = run_ranks(_sharded_steps, 4, str(tmp_path), optimizer, dp_includes_model)
    for metrics, placed, leaves in got:
        assert metrics == got[0][0]
        for (loss, norm), (wl, wn) in zip(metrics, want):
            assert abs(loss - wl) <= 1e-6 * abs(wl) and abs(norm - wn) <= 1e-5 * wn
        assert sorted(leaves) == sorted(ref)
        for p, x in leaves.items():
            assert torch.allclose(x.float(), ref[p].float(), rtol=0,
                                  atol=1e-4 * max(ref[p].float().abs().max().item(), 1e-30)), p
    placed = got[0][1]
    assert not all(placed.values())
    if optimizer == "adafactor":
        factored = [p for p in placed if p.endswith(("/vr", "/vc"))]
        assert factored and all(placed[p] for p in factored)
        assert not all(placed[p] for p in placed if p.endswith("/v"))
