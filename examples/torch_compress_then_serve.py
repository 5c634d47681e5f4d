"""Train-compress-serve on the PyTorch/CUDA port: the paper's technique as a
deployment pipeline.

  1. train a tiny LM for a few steps (so weights have learned structure),
  2. plan compression from a policy (per-path rules: attention projections
     vs MLP weights get different tiles), inspect the predicted ratio,
  3. execute the plan (tiles pooled across all tensors into batched
     solves) and save checkpoint + artifact manifest,
  4. restore through the manifest (no shape-sniffing) and serve both
     models, comparing memory footprint + agreement.

    PYTHONPATH=src python examples/torch_compress_then_serve.py [--method bbo]
    PYTHONPATH=src python examples/torch_compress_then_serve.py --device cpu --train-steps 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.checkpoint import checkpointer  # noqa: E402
from repro_torch.compression import (  # noqa: E402
    CompressionArtifact,
    CompressionPolicy,
    CompressionRule,
    execute_plan,
    plan_compression,
)
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.configs.base import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.device import generator, resolve_device  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="alternating",
                    choices=["greedy", "alternating", "bbo"])
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--rank-ratio", type=float, default=0.5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced_for_smoke(get_config("mistral-nemo-12b"))
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=256, num_layers=4,
                              vocab_size=512, dtype="float32")
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"))
    shape = ShapeConfig("s", "train", 128, 8)

    # 1. short training run
    state = init_train_state(0, cfg, pcfg, device=dev)
    step = make_train_step(cfg, pcfg, warmup_cosine(3e-3, 10, args.train_steps))
    pipe = make_pipeline(cfg, shape, seed=0, device=dev)
    for i in range(args.train_steps):
        state, m = step(state, pipe.batch_at(i))
    print(f"trained {args.train_steps} steps, loss {float(m['loss']):.3f}")

    # 2. policy -> plan (pure; printable/diffable before any solver runs)
    policy = CompressionPolicy(
        method=args.method,
        tile_n=8 if args.method == "bbo" else 16,
        tile_d=128, rank_ratio=args.rank_ratio, min_size=8192, bbo_iters=24,
        rules=(
            # attention projections tolerate a lower rank than the MLP
            CompressionRule(pattern=r"attn/w[qkvo]/w$",
                            rank_ratio=0.75 * args.rank_ratio, tile_d=64),
        ),
    )
    plan = plan_compression(state.params, policy)
    print(plan.summary())
    print(f"planned: {plan.total_bytes() / 2**20:.2f} MiB compressed "
          f"(predicted x{plan.compression_ratio:.2f})")

    # 3. execute: tiles pooled across tensors into batched solves
    cvals, artifact = execute_plan(plan, state.params, seed=0, device=dev, max_pool_tiles=128)
    print(f"compressed {len(artifact.report.compressed)} tensors with "
          f"'{args.method}': {artifact.total_bytes() / 2**20:.2f} MiB "
          f"(x{artifact.compression_ratio:.2f})")
    for pth, ob, nb, err in artifact.report.compressed[:6]:
        print(f"  {pth:40s} rel_err={err:.3f}")

    # save + manifest-driven restore (what launch/serve.py does)
    with tempfile.TemporaryDirectory() as d:
        checkpointer.save(d, 0, {"params": cvals})
        artifact.save(d)
        art2 = CompressionArtifact.load(d)
        template = {"params": art2.restore_template(state.params)}
        restored = checkpointer.restore(d, 0, template, device=dev)["params"]
    print("manifest round trip: restored compressed checkpoint through "
          f"{len(art2.manifest['tensors'])}-tensor manifest")

    # 4. serve both (the engine validates params against the manifest)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=generator(dev, 7), device=dev)
    dense = Engine(cfg, state.params, max_len=44, batch=4)
    comp = Engine(cfg, restored, max_len=44, batch=4, artifact=art2)
    print(f"serving compressed: {comp.compression}")
    out_d = dense.generate(prompts, steps=24)
    out_c = comp.generate(prompts, steps=24)
    agree = float((out_d[:, 12:] == out_c[:, 12:]).to(torch.float32).mean())
    print(f"greedy-token agreement dense vs compressed: {agree*100:.1f}% "
          f"(rank_ratio={args.rank_ratio}; raise it for higher fidelity)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
