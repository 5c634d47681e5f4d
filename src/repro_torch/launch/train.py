"""Training launcher: supervised, checkpointed, resumable.

Counterpart of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --steps 200 --ckpt-dir /tmp/run1

runs on the GPU (``train_once(args, attempt, device="cpu")`` runs on the
CPU).  ``--mesh AxB`` (or ``PxAxB``, axes ``(pod,) data, model``) trains
sharded over that many ranks, started by torch's launcher, one rank per
GPU of the host under NCCL:

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.train --mesh 2x2 --arch granite-moe-1b-a400m ...

The launcher's world size must be the mesh's product, and a host may not
run more ranks than it has GPUs: both are refused by name.  Without the
launcher, ``--mesh 1x1`` runs the unsharded single-device path.  When the
caller has initialised a process group (gloo ranks on the CPU, in tests),
``train_once`` trains on the mesh as well.  The run resumes from the newest committed checkpoint
(``CheckpointManager``); ``--max-restarts`` wraps it in the supervision
harness (``distributed/fault_tolerance.py``); ``--fail-at-step`` injects
one crash, to exercise the restart path end to end.

Differences from the reference: one process per rank, not one controller
for every device; a resumed run restores into a ``meta`` template (placed
by ``state_shardings`` on a mesh) instead of initialising the weights first;
only rank 0 prints, beats the heartbeat and collects checkpoint garbage;
an attempt that fails waits for its in-flight save to commit, so the next
attempt resumes from it; and the reference's
``_disable_persistent_compilation_cache`` (a JAX compilation-cache fault
across in-process restarts) has no counterpart: nothing is compiled here.
"""

from __future__ import annotations

import argparse
import math
import os
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config, reduced_for_smoke
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import Heartbeat, StepTimer, run_with_restarts
from repro_torch.optim import warmup_cosine
from repro_torch.training import init_train_state, make_train_step, state_shardings

__all__ = ["train_once", "main", "build_parser", "parse_mesh", "check_launch"]


def parse_mesh(s: str):
    dims = tuple(int(x) for x in s.split("x"))
    axes = ("pod", "data", "model")[-len(dims):] if len(dims) <= 3 else None
    if not axes:
        raise ValueError(f"--mesh {s}: a mesh has at most 3 dims")
    return dims, axes


def check_launch(mesh: str, world: int, local_world: int, gpus: int | None) -> None:
    """Refuse a launch whose world size is not the mesh's product, or that
    puts more ranks on this host than it has GPUs (``gpus`` None: a run on
    the CPU)."""
    dims, _ = parse_mesh(mesh)
    need = math.prod(dims)
    if world != need:
        raise ValueError(
            f"--mesh {mesh} needs {need} ranks, one per mesh position, but the world size "
            f"is {world}: start it with python -m torch.distributed.run --nproc-per-node {need}"
        )
    if gpus is not None and local_world > gpus:
        raise ValueError(
            f"--mesh {mesh}: {local_world} ranks on this host but only {gpus} GPU(s); "
            "each rank takes a GPU of its own"
        )


def train_once(args, attempt: int, device=None, report=None):
    """One supervised attempt: resume from the newest checkpoint (or start
    at step 0), train to ``args.steps`` on ``device`` (default: the GPU),
    saving every ``args.ckpt_every`` steps and at the end.  Returns the
    final ``TrainState``.  ``report``, when given, receives a dict per
    event: ``{"event": "state", "step"}`` once the state is built or
    restored (before the pipeline: a caller reads the device memory it
    holds there), ``{"event": "resume", "step", "restore_s"}``, ``{"event":
    "step", "step", "loss", "grad_norm", "lr", "s"}`` and ``{"event":
    "save", "step", "host_copy_s", "write_s"}`` (each with ``attempt``).

    Under an initialised process group the run is sharded over ``--mesh``
    (whose product must be the world size), on this rank's GPU, or on the
    CPU for ``device="cpu"``."""
    import torch.distributed as dist

    dims, axes = parse_mesh(args.mesh)
    mesh = None
    if dist.is_initialized():
        from repro_torch.distributed.sharding import mesh_device
        from repro_torch.launch.mesh import make_mesh

        check_launch(args.mesh, dist.get_world_size(), dist.get_world_size(), None)
        cpu = device is not None and torch.device(device).type == "cpu"
        mesh = make_mesh(dims, axes, "cpu" if cpu else "cuda")
        device = mesh_device(mesh)
    elif math.prod(dims) != 1:
        check_launch(args.mesh, 1, 1, None)
    device = resolve_device(device)
    rank0 = mesh is None or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)

    def emit(event, **kw):
        if report is not None:
            report({"event": event, "attempt": attempt, **kw})

    reported = set()

    def emit_save():      # the last committed save, once
        if mgr.last_save is not None and mgr.last_save["step"] not in reported:
            reported.add(mgr.last_save["step"])
            emit("save", **mgr.last_save)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    shape = (
        SHAPES[args.shape]
        if args.shape in SHAPES
        else ShapeConfig("custom", "train", args.seq_len, args.batch)
    )
    pcfg = ParallelConfig(mesh_shape=dims, mesh_axes=axes,
                          microbatches=args.microbatches, optimizer=args.optimizer)

    mgr = CheckpointManager(args.ckpt_dir, keep_last=args.keep_last)
    hb = Heartbeat(f"{args.ckpt_dir}/heartbeat.json", interval_s=5) if rank0 else None
    timer = StepTimer()

    t0 = time.perf_counter()
    template = init_train_state(args.seed, cfg, pcfg, device="meta")
    if mesh is None:
        start, state = mgr.restore_latest(template, device=device)
    else:
        start, state = mgr.restore_latest(template, shardings=state_shardings(cfg, pcfg, mesh))
    if state is not None:
        emit("resume", step=start, restore_s=time.perf_counter() - t0)
        say(f"[resume] from step {start} (attempt {attempt})")
    else:
        state = init_train_state(args.seed, cfg, pcfg, device=device, mesh=mesh)
    emit("state", step=start if start is not None else 0)

    step_fn = make_train_step(cfg, pcfg, warmup_cosine(args.lr, args.warmup, args.steps))
    pipe = make_pipeline(cfg, shape, mesh, seed=args.seed, device=device)

    step, loss = int(shd.local_value(state.step)), float("nan")
    try:
        while step < args.steps:
            timer.start()
            state, metrics = step_fn(state, pipe.batch_at(step))
            loss = float(metrics["loss"])
            dt = timer.stop()
            step = int(shd.local_value(state.step))
            emit("step", step=step, loss=loss, grad_norm=float(metrics["grad_norm"]),
                 lr=float(metrics["lr"]), s=dt)
            if hb is not None:
                hb.beat(step, {"loss": loss})
            if step % args.log_every == 0 or step == args.steps:
                tput = shape.tokens_per_step / dt
                say(f"step {step:6d} loss {loss:.4f} "
                      f"| {dt*1e3:6.0f} ms/step | {tput:9.0f} tok/s", flush=True)
            if args.fail_at_step and step == args.fail_at_step and attempt == 0:
                raise RuntimeError("injected failure (--fail-at-step)")
            if step % args.ckpt_every == 0 or step == args.steps:
                mgr.save(step, state)      # waits for the previous save first
                emit_save()
    finally:
        mgr.wait()
        emit_save()
    say(f"done at step {step}; final loss {loss:.4f}")
    return state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--shape", default="custom")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep-last", type=int, default=3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="inject one crash at this step (tests restart path)")
    return ap


def main(argv=None) -> None:
    """The CLI.  Under ``torch.distributed.run`` (``WORLD_SIZE`` set) each
    rank joins the process group on ``cuda:LOCAL_RANK`` under NCCL."""
    import torch.distributed as dist

    ap = build_parser()
    args = ap.parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    try:
        check_launch(args.mesh, world, local_world,
                     torch.cuda.device_count() if "WORLD_SIZE" in os.environ else None)
    except ValueError as e:
        ap.error(str(e))
    if "WORLD_SIZE" in os.environ:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl")
    try:
        restarts = run_with_restarts(
            lambda attempt: train_once(args, attempt),
            max_restarts=args.max_restarts,
            on_failure=lambda a, e: print(f"[supervisor] attempt {a} failed: {e}; restarting"),
        )
        if restarts and (not dist.is_initialized() or dist.get_rank() == 0):
            print(f"[supervisor] recovered after {restarts} restart(s)")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
