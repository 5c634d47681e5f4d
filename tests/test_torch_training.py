"""The port's training path against the JAX package's, on the same numpy
inputs (CPU): the data pipeline, ``train_loss`` and its gradients, remat,
the train step (through the bridge's ``TrainState``), the presets, the
launcher's kill-and-resume, and a JAX training checkpoint restored in the
port.

Tolerances (float32 on both sides, different summation orders): losses
within 1e-6 relative; gradients per leaf within 1e-4 of the leaf's max|g|
(measured: <= 1.2e-5); parameters after three optimiser steps within 1e-4
of the leaf's max|p| (measured: <= 1e-5); gradient norms within 1e-5
relative.  Pipelines, presets, checkpoints and a resumed run are exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import SHAPES as J_SHAPES
from repro.configs import ARCHITECTURES
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.configs.base import ParallelConfig as JParallel
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import make_pipeline as j_make_pipeline
from repro.launch.presets import parallel_preset as j_preset
from repro.models import init_model as j_init_model
from repro.models import train_loss as j_train_loss
from repro.models.params import split as j_split
from repro.optim import warmup_cosine as j_warmup_cosine
from repro.training.loop import TrainState as JTrainState
from repro.training.loop import make_optimizer as j_make_optimizer
from repro.training.loop import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint.checkpointer import leaf_entries
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compression.plan import tree_paths
from repro_torch.configs import SHAPES, get_config, reduced_for_smoke
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.data import make_pipeline
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import run_with_restarts
from repro_torch.launch import train as train_cli
from repro_torch.launch.presets import parallel_preset
from repro_torch.models import train_loss
from repro_torch.optim import warmup_cosine
from repro_torch.training import TrainState, init_train_state, make_train_step

torch.set_num_threads(1)

LOSS_TOL, GRAD_TOL, PARAM_TOL, NORM_TOL = 1e-6, 1e-4, 1e-4, 1e-5
# zamba2 at 8 layers: one group of 5 SSD + ssm_attn, a remainder of 2 SSD
# blocks (remat on both); sequences of 32 split into two SSD chunks of 16
LAYERS = {"qwen3-32b": None, "granite-moe-1b-a400m": None, "zamba2-1.2b": 8}


def _configs(arch):
    jc, tc = j_reduced(j_get_config(arch)), reduced_for_smoke(get_config(arch))
    if LAYERS.get(arch):
        jc = dataclasses.replace(jc, num_layers=LAYERS[arch])
        tc = dataclasses.replace(tc, num_layers=LAYERS[arch])
    return jc, tc


def _jax_values(jc, seed=0):
    return j_split(j_init_model(jax.random.PRNGKey(seed), jc))[0]


def _to_port(jvalues):
    return bridge.to_torch({p: np.asarray(a) for p, a in j_tree_paths(jvalues)}, device="cpu")


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _assert_leaves_close(t_tree, j_tree, tol, label):
    jflat = dict(j_tree_paths(j_tree))
    tflat = dict(tree_paths(t_tree))
    assert tflat.keys() == jflat.keys(), label
    for p, t in tflat.items():
        j = np.asarray(jflat[p], np.float32)
        err = np.abs(t.detach().float().numpy() - j).max()
        assert err <= tol * max(np.abs(j).max(), 1e-30), f"{label} {p}: {err:.3g}"


def _grads(values, batch, cfg):
    pairs = tree_paths(values)
    live = [t.detach().requires_grad_(True) for _, t in pairs]
    tree: dict = {}
    for (p, _), t in zip(pairs, live):
        node = tree
        *head, last = p.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    loss, metrics = train_loss(tree, batch, cfg)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    return loss.detach(), metrics, dict(zip((p for p, _ in pairs), grads))


# -- data -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-32b", "musicgen-medium"])
def test_batch_at_is_bit_equal_to_jax(arch):
    """Tokens (and the stub frontend's embeddings and labels) of every
    step equal JAX's bit for bit, on the pipeline's device."""
    jc, tc = j_reduced(j_get_config(arch)), reduced_for_smoke(get_config(arch))
    jp = j_make_pipeline(jc, JShape("s", "train", 24, 5), seed=3)
    tp = make_pipeline(tc, ShapeConfig("s", "train", 24, 5), seed=3, device="cpu")
    for step in (0, 1, 7, 1000):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert tb[k].device.type == "cpu"
            assert np.array_equal(tb[k].numpy(), np.asarray(jb[k])), (arch, step, k)
            assert tb[k].numpy().dtype == np.asarray(jb[k]).dtype


def _meshed_pipeline_rows(rank, world, arch, batch):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    pipe = make_pipeline(reduced_for_smoke(get_config(arch)), ShapeConfig("s", "train", 24, batch),
                         mesh, seed=3)
    try:
        b = pipe.batch_at(7)
    except ValueError as e:
        return str(e)
    return {k: (shd.dtensor_box(v), v.to_local().clone(), tuple(v.shape)) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["qwen3-32b", "musicgen-medium"])
def test_pipeline_refuses_a_mesh(tmp_path, arch):
    """A pipeline on a mesh keeps on each rank exactly its block of JAX's
    rows (the reference's ``P(dp, None)``: rank r of the dp axis holds rows
    r*B/dp ...), and refuses a batch the dp axes do not divide, as JAX's
    ``device_put`` does."""
    from repro_torch.distributed.local_ranks import run_ranks

    jb = j_make_pipeline(j_reduced(j_get_config(arch)), JShape("s", "train", 24, 4),
                         seed=3).batch_at(7)
    got = run_ranks(_meshed_pipeline_rows, 2, str(tmp_path / "a"), arch, 4)
    for r, leaves in enumerate(got):
        assert sorted(leaves) == sorted(jb)
        for k, (box, local, shape) in leaves.items():
            assert shape == tuple(np.shape(jb[k]))
            assert box[0] == slice(2 * r, 2 * r + 2)
            assert np.array_equal(local.numpy(), np.asarray(jb[k])[box]), (r, k)
    refused = run_ranks(_meshed_pipeline_rows, 2, str(tmp_path / "b"), arch, 5)
    assert all("does not split evenly" in e for e in refused)


# -- train_loss -------------------------------------------------------------

@pytest.mark.parametrize("arch", list(LAYERS))
def test_train_loss_and_grads_match_jax(arch):
    """Loss, CE, aux and every leaf's gradient against
    ``jax.value_and_grad`` of JAX's ``train_loss``: dense, MoE, hybrid."""
    jc, tc = _configs(arch)
    jv = _jax_values(jc)
    toks = np.asarray(j_make_pipeline(jc, JShape("s", "train", 32, 4)).batch_at(0)["tokens"])
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: j_train_loss(p, {"tokens": jnp.asarray(toks)}, jc), has_aux=True))(jv)
    tl, tm, tg = _grads(_to_port(jv), {"tokens": torch.from_numpy(toks.copy())}, tc)
    assert _rel(tl, jl) <= LOSS_TOL
    for k in ("ce", "aux"):
        assert abs(float(tm[k].detach()) - float(jm[k])) <= LOSS_TOL * max(abs(float(jm[k])), 1.0), k
    if arch == "granite-moe-1b-a400m":
        assert float(tm["aux"]) > 0
    jflat = dict(j_tree_paths(jg))
    assert tg.keys() == jflat.keys()
    for p, g in tg.items():
        j = np.asarray(jflat[p], np.float32)
        err = np.abs(g.numpy() - j).max()
        assert err <= GRAD_TOL * np.abs(j).max(), f"{arch} {p}: {err:.3g}"


def test_train_loss_labels_and_mask_branches_match_jax():
    """``embeds`` + ``labels`` (no shift) and a ``loss_mask`` (shifted with
    the tokens) give JAX's loss."""
    jc, tc = _configs("qwen3-32b")
    jv = _jax_values(jc)
    tv = _to_port(jv)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jc.vocab_size, (2, 16)).astype(np.int32)
    emb = (rng.standard_normal((2, 16, jc.d_model)) * 0.02).astype(np.float32)
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    for batch in ({"embeds": emb, "labels": toks}, {"tokens": toks, "loss_mask": mask},
                  {"embeds": emb, "labels": toks, "loss_mask": mask}):
        jl, _ = jax.jit(lambda p, b: j_train_loss(p, b, jc))(
            jv, {k: jnp.asarray(v) for k, v in batch.items()})
        tl, _ = train_loss(tv, {k: torch.from_numpy(v.copy()) for k, v in batch.items()}, tc)
        assert _rel(tl, jl) <= LOSS_TOL, sorted(batch)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-1.2b"])
def test_remat_gives_the_same_values_and_grads(arch):
    """``cfg.remat`` on and off: the same loss and gradients bit for bit
    (recomputation repeats the same operations)."""
    _, tc = _configs(arch)
    jc, _ = _configs(arch)
    tv = _to_port(_jax_values(jc))
    toks = torch.from_numpy(
        np.array(j_make_pipeline(jc, JShape("s", "train", 32, 2)).batch_at(1)["tokens"]))
    on = _grads(tv, {"tokens": toks}, dataclasses.replace(tc, remat=True))
    off = _grads(tv, {"tokens": toks}, dataclasses.replace(tc, remat=False))
    assert torch.equal(on[0], off[0])
    for p in on[2]:
        assert torch.equal(on[2][p], off[2][p]), p


def test_remat_checkpoints_only_while_autograd_records(monkeypatch):
    """The reference's four remat sites (group, remainder layer, chunked
    attention, SSD, each CE chunk) go through ``torch.utils.checkpoint``
    during a backward pass, and never in inference."""
    import torch.utils.checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint

    def counting(fn, *a, **k):
        calls.append(getattr(fn, "__name__", type(fn).__name__))
        return real(fn, *a, **k)

    monkeypatch.setattr(ckpt, "checkpoint", counting)
    jc, tc = _configs("zamba2-1.2b")
    tv = _to_port(_jax_values(jc))
    toks = torch.randint(0, tc.vocab_size, (1, 32), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        train_loss(tv, {"tokens": toks}, tc)
    assert calls == []
    _grads(tv, {"tokens": toks}, tc)
    # 1 group + 2 remainder layers (each recomputed inside: SSDs, the shared
    # block's attention) + 1 CE chunk
    assert calls.count("group_fn") == 1 and calls.count("<lambda>") >= 2
    assert "chunk_sum" in calls and "partial" in calls


# -- the train step ---------------------------------------------------------

@pytest.mark.parametrize("optimizer,micro", [("adamw", 1), ("adamw", 2), ("adafactor", 1),
                                             ("adafactor", 2)])
def test_train_step_matches_jax(optimizer, micro):
    """Three steps of JAX's jitted ``make_train_step`` and the port's from
    the same ``TrainState`` (carried by the bridge), on the same batches:
    loss, grad norm and lr per step, and every parameter and moment."""
    jc, tc = _configs("granite-moe-1b-a400m")
    jpcfg = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), microbatches=micro,
                      optimizer=optimizer)
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), microbatches=micro,
                          optimizer=optimizer)
    jv = _jax_values(jc)
    jstate = JTrainState(jnp.zeros((), jnp.int32), jv, j_make_optimizer(jpcfg).init(jv))
    tstate = bridge.train_state_to_torch(jax.tree.map(np.asarray, jstate), device="cpu")
    assert isinstance(tstate, TrainState) and tstate.step.dtype == torch.int32
    jstep = jax.jit(j_make_train_step(jc, jpcfg, j_warmup_cosine(1e-2, 1, 3)))
    tstep = make_train_step(tc, pcfg, warmup_cosine(1e-2, 1, 3))
    jpipe = j_make_pipeline(jc, JShape("s", "train", 32, 4))
    tpipe = make_pipeline(tc, ShapeConfig("s", "train", 32, 4), device="cpu")
    for s in range(3):
        jstate, jm = jstep(jstate, jpipe.batch_at(s))
        tstate, tm = tstep(tstate, tpipe.batch_at(s))
        assert int(tstate.step) == int(jstate.step) == s + 1
        assert _rel(tm["loss"], jm["loss"]) <= LOSS_TOL
        assert _rel(tm["grad_norm"], jm["grad_norm"]) <= NORM_TOL
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    _assert_leaves_close(tstate.params, jstate.params, PARAM_TOL, "params")
    _assert_leaves_close(tstate.opt, jstate.opt, PARAM_TOL, "opt")


def test_train_step_clears_the_kernel_hooks():
    """The step differentiates the plain attention even with K5's adapter
    registered (it has no backward), and leaves the hooks as it found them."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention

    _, tc = _configs("qwen3-32b")
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"))
    state = init_train_state(0, tc, pcfg, device="cpu")
    batch = make_pipeline(tc, ShapeConfig("s", "train", 16, 2), device="cpu").batch_at(0)
    ops.enable_kernels()
    try:
        state, m = make_train_step(tc, pcfg, warmup_cosine(1e-3, 0, 2))(state, batch)
        assert attention._FLASH_IMPL is ops.flash_attention_model_layout
    finally:
        ops.disable_kernels()
    assert np.isfinite(float(m["loss"])) and int(state.step) == 1


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_parallel_preset_equals_jax(arch):
    for name, shape in J_SHAPES.items():
        for multi_pod in (False, True):
            want = dataclasses.asdict(j_preset(j_get_config(arch), shape, multi_pod=multi_pod))
            got = dataclasses.asdict(parallel_preset(get_config(arch), SHAPES[name],
                                                     multi_pod=multi_pod))
            assert got == want, (arch, name, multi_pod)


# -- the launcher and checkpoints --------------------------------------------

def _args(ckpt_dir, **over):
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "6", "--seq-len", "32",
            "--batch", "4", "--microbatches", "2", "--warmup", "2", "--ckpt-dir", str(ckpt_dir),
            "--ckpt-every", "3", "--keep-last", "1", "--log-every", "1"]
    for k, v in over.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return train_cli.build_parser().parse_args(argv)


def test_train_once_killed_and_resumed_matches_an_uninterrupted_run(tmp_path):
    """``--fail-at-step 5``: attempt 0 raises at step 5, attempt 1 resumes
    from step 3's checkpoint; the final state, and the losses of the
    recomputed steps, are bit-identical to an uninterrupted run's."""
    def run(args):
        events, states = [], []
        restarts = run_with_restarts(
            lambda a: states.append(train_cli.train_once(args, a, device="cpu",
                                                         report=events.append)),
            max_restarts=2)
        return restarts, states[-1], events

    n0, clean, ev0 = run(_args(tmp_path / "clean"))
    n1, resumed, ev1 = run(_args(tmp_path / "killed", fail_at_step=5))
    assert (n0, n1) == (0, 1)
    resume = [e for e in ev1 if e["event"] == "resume"]
    assert [(e["attempt"], e["step"]) for e in resume] == [(1, 3)]
    loss = {(e["attempt"], e["step"]): e["loss"] for e in ev1 if e["event"] == "step"}
    clean_loss = {e["step"]: e["loss"] for e in ev0 if e["event"] == "step"}
    assert sorted(loss) == [(0, s) for s in range(1, 6)] + [(1, s) for s in (4, 5, 6)]
    for (a, s), v in loss.items():
        assert v == clean_loss[s], (a, s)
    assert clean_loss[6] < clean_loss[1]
    assert [e["step"] for e in ev1 if e["event"] == "save"] == [3, 6]
    for (p, a), (_, b) in zip(tree_paths(clean), tree_paths(resumed)):
        assert torch.equal(a, b), p
    # keep_last 1: only the final checkpoint remains
    assert CheckpointManager(str(tmp_path / "killed")).latest_step() == 6


def test_train_cli_refuses_a_mesh(capsys):
    """The refusals that stay: a world size other than the mesh's product
    (here no launcher, so one rank) and more ranks on a host than GPUs."""
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "qwen3-32b", "--reduced", "--mesh", "2x2"])
    assert "--mesh 2x2 needs 4 ranks" in capsys.readouterr().err
    with pytest.raises(ValueError, match="needs 2 ranks"):
        train_cli.train_once(_args("unused", mesh="1x2"), 0, device="cpu")
    with pytest.raises(ValueError, match="world size is 2"):
        train_cli.check_launch("2x2", 2, 2, None)
    with pytest.raises(ValueError, match="2 ranks on this host but only 1 GPU"):
        train_cli.check_launch("1x2", 2, 2, 1)
    train_cli.check_launch("1x2", 2, 2, 2)
    train_cli.check_launch("2x1x2", 4, 4, None)
    with pytest.raises(ValueError, match="at most 3 dims"):
        train_cli.parse_mesh("1x1x1x1")


def test_jax_train_state_checkpoint_restores_in_the_port(tmp_path):
    """A ``TrainState`` saved by JAX's ``CheckpointManager`` (NamedTuple
    fields as leaf names, bf16 and f32 leaves) restores into the port's
    template byte for byte, and the port's save of it restores in JAX."""
    jc = dataclasses.replace(j_reduced(j_get_config("granite-moe-1b-a400m")), dtype="bfloat16")
    tc = dataclasses.replace(reduced_for_smoke(get_config("granite-moe-1b-a400m")),
                             dtype="bfloat16")
    for optimizer in ("adamw", "adafactor"):
        jpcfg = JParallel(mesh_shape=(1, 1), mesh_axes=("data", "model"), optimizer=optimizer)
        jv = _jax_values(jc, seed=4)
        jopt = j_make_optimizer(jpcfg)
        js = JTrainState(jnp.asarray(7, jnp.int32), jv,
                         jax.tree.map(lambda z: z + 0.25, jopt.init(jv)))
        d = tmp_path / optimizer
        jm = JManager(str(d), async_save=False)
        jm.save(7, js)
        template = init_train_state(0, tc, ParallelConfig(optimizer=optimizer), device="meta")
        step, got = CheckpointManager(str(d)).restore_latest(template, device="cpu")
        assert step == 7 and isinstance(got, TrainState)
        want = bridge.train_state_to_torch(jax.tree.map(np.asarray, js), device="cpu")
        pairs_got, pairs_want = tree_paths(got), tree_paths(want)
        assert [p for p, _ in pairs_got] == [p for p, _ in pairs_want]
        assert sorted(p for p, _ in pairs_got) == sorted(leaf_entries(str(d), 7))
        assert pairs_got[0][0] == "step"
        for (p, a), (_, b) in zip(pairs_got, pairs_want):
            assert a.dtype == b.dtype and torch.equal(a, b), p
        # and back: the port's save restores in JAX
        CheckpointManager(str(d / "port"), async_save=False).save(8, got)
        _, back = JManager(str(d / "port")).restore_latest(js)
        for (p, a), (_, b) in zip(j_tree_paths(back), j_tree_paths(js)):
            a, b = np.asarray(a), np.asarray(b)
            assert (a.dtype, a.shape, a.tobytes()) == (b.dtype, b.shape, b.tobytes()), p
