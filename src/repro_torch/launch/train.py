"""Training launcher: supervised, checkpointed, resumable.

Counterpart of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
        --steps 200 --ckpt-dir /tmp/run1

runs on the GPU (``train_once(args, attempt, device="cpu")`` runs on the
CPU).  The run resumes from the newest committed checkpoint
(``CheckpointManager``); ``--max-restarts`` wraps it in the supervision
harness (``distributed/fault_tolerance.py``); ``--fail-at-step`` injects
one crash, to exercise the restart path end to end.

Differences from the reference: a mesh other than ``1x1`` is refused (the
sharded state and batches come with the multi-GPU slice); a resumed run
restores into a ``meta`` template instead of initialising the weights first;
an attempt that fails waits for its in-flight save to commit, so the next
attempt resumes from it; and the reference's
``_disable_persistent_compilation_cache`` (a JAX compilation-cache fault
across in-process restarts) has no counterpart: nothing is compiled here.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import SHAPES, get_config, reduced_for_smoke
from repro_torch.configs.base import ParallelConfig, ShapeConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import Heartbeat, StepTimer, run_with_restarts
from repro_torch.optim import warmup_cosine
from repro_torch.training import init_train_state, make_train_step

__all__ = ["train_once", "main", "build_parser"]


def _check_mesh(mesh: str) -> None:
    if mesh != "1x1":
        raise ValueError(f"--mesh {mesh}: multi-GPU training (a sharded state and batch) is "
                         "not ported yet; only --mesh 1x1 runs")


def train_once(args, attempt: int, device=None, report=None):
    """One supervised attempt: resume from the newest checkpoint (or start
    at step 0), train to ``args.steps`` on ``device`` (default: the GPU),
    saving every ``args.ckpt_every`` steps and at the end.  Returns the
    final ``TrainState``.  ``report``, when given, receives a dict per
    event: ``{"event": "resume", "step", "restore_s"}``, ``{"event":
    "step", "step", "loss", "grad_norm", "lr", "s"}`` and ``{"event":
    "save", "step", "host_copy_s", "write_s"}`` (each with ``attempt``)."""
    _check_mesh(args.mesh)
    device = resolve_device(device)

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
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"),
                          microbatches=args.microbatches, optimizer=args.optimizer)

    mgr = CheckpointManager(args.ckpt_dir, keep_last=args.keep_last)
    hb = Heartbeat(f"{args.ckpt_dir}/heartbeat.json", interval_s=5)
    timer = StepTimer()

    t0 = time.perf_counter()
    start, state = mgr.restore_latest(init_train_state(args.seed, cfg, pcfg, device="meta"),
                                      device=device)
    if state is not None:
        emit("resume", step=start, restore_s=time.perf_counter() - t0)
        print(f"[resume] from step {start} (attempt {attempt})")
    else:
        state = init_train_state(args.seed, cfg, pcfg, device=device)

    step_fn = make_train_step(cfg, pcfg, warmup_cosine(args.lr, args.warmup, args.steps))
    pipe = make_pipeline(cfg, shape, None, seed=args.seed, device=device)

    step, loss = int(state.step), float("nan")
    try:
        while step < args.steps:
            timer.start()
            state, metrics = step_fn(state, pipe.batch_at(step))
            loss = float(metrics["loss"])
            dt = timer.stop()
            step = int(state.step)
            emit("step", step=step, loss=loss, grad_norm=float(metrics["grad_norm"]),
                 lr=float(metrics["lr"]), s=dt)
            hb.beat(step, {"loss": loss})
            if step % args.log_every == 0 or step == args.steps:
                tput = shape.tokens_per_step / dt
                print(f"step {step:6d} loss {loss:.4f} "
                      f"| {dt*1e3:6.0f} ms/step | {tput:9.0f} tok/s", flush=True)
            if args.fail_at_step and step == args.fail_at_step and attempt == 0:
                raise RuntimeError("injected failure (--fail-at-step)")
            if step % args.ckpt_every == 0 or step == args.steps:
                mgr.save(step, state)      # waits for the previous save first
                emit_save()
    finally:
        mgr.wait()
        emit_save()
    print(f"done at step {step}; final loss {loss:.4f}")
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
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        _check_mesh(args.mesh)
    except ValueError as e:
        ap.error(str(e))
    restarts = run_with_restarts(
        lambda attempt: train_once(args, attempt),
        max_restarts=args.max_restarts,
        on_failure=lambda a, e: print(f"[supervisor] attempt {a} failed: {e}; restarting"),
    )
    if restarts:
        print(f"[supervisor] recovered after {restarts} restart(s)")


if __name__ == "__main__":
    main()
