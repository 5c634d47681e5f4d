"""End-to-end training driver on the PyTorch/CUDA port: train a small LM
for a few hundred steps with the production stack (train step with
microbatching, checkpointing, auto-resume).

Default budget: ~20M params, 200 steps; pass --d-model 768 --layers 12 for
the ~100M variant.

    PYTHONPATH=src python examples/torch_train_small.py [--steps 200]
    PYTHONPATH=src python examples/torch_train_small.py --device cpu --steps 2 \\
        --d-model 64 --layers 1 --seq-len 16 --batch 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.configs.base import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.distributed import StepTimer  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    cfg = dataclasses.replace(
        cfg, d_model=args.d_model, num_layers=args.layers,
        num_heads=args.d_model // 64, num_kv_heads=max(args.d_model // 128, 1),
        head_dim=64, d_ff=args.d_model * 4, vocab_size=8192, dtype="float32",
    )
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({args.layers}L x {args.d_model}d)")

    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"), microbatches=2)
    shape = ShapeConfig("small", "train", args.seq_len, args.batch)

    mgr = CheckpointManager(args.ckpt_dir, keep_last=2)
    start, state = mgr.restore_latest(init_train_state(0, cfg, pcfg, device="meta"),
                                      device=dev)
    if state is not None:
        print(f"resumed from step {start}")
    else:
        state = init_train_state(0, cfg, pcfg, device=dev)

    step_fn = make_train_step(cfg, pcfg, warmup_cosine(3e-4, 20, args.steps))
    pipe = make_pipeline(cfg, shape, seed=0, device=dev)
    timer = StepTimer()

    step = int(state.step)
    first_loss = loss = None
    while step < args.steps:
        timer.start()
        state, m = step_fn(state, pipe.batch_at(step))
        loss = float(m["loss"])
        dt = timer.stop()
        step = int(state.step)
        if first_loss is None:
            first_loss = loss
        if step % 20 == 0 or step == args.steps:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"{shape.tokens_per_step/dt:,.0f} tok/s")
        if step % 50 == 0:
            mgr.save(step, state)
    mgr.save(step, state)
    mgr.wait()
    if first_loss is None:
        print(f"nothing to train: the checkpoint is at step {step} of {args.steps}")
        return 0
    print(f"loss {first_loss:.3f} -> {loss:.3f} over {args.steps} steps "
          f"({'DECREASED' if loss < first_loss else 'check config'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
