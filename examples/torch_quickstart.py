"""Quickstart on the PyTorch/CUDA port: the paper in one run.

Reproduces the core claim end-to-end at paper scale (8x100 matrix, K=3):
  1. generate a shrunk-VGG-like instance,
  2. run the original greedy algorithm (the paper's baseline),
  3. run BBO (nBOCS + simulated annealing; the annealer is the CUDA kernel
     ``csrc/sa_sweep.cu`` on the card),
  4. check that BBO finds a decomposition no worse than greedy,
  5. compress the matrix into (bit-packed M, C) and verify the product.

    PYTHONPATH=src python examples/torch_quickstart.py              # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
        --iters 576 --num-sweeps 4        # a smaller budget for the CPU

BBO runs the paper's budget by default (24 initial points + 2n^2 = 1,152
iterations of 10 reads x 64 sweeps).  On the CPU the annealer's plain
version takes ~0.17 s an iteration on one core; ``--iters`` and
``--num-sweeps`` shrink the budget.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.compression import CompressionPolicy, CompressionRule, plan_compression  # noqa: E402
from repro_torch.core import (  # noqa: E402
    BBOConfig,
    greedy_decompose,
    least_squares_C,
    make_objective,
    objective,
    pack_bits,
    run_bbo_batch,
    shrunk_vgg_instance,
    unpack_bits,
)
from repro_torch.device import generator, resolve_device  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=0,
                    help="BBO iterations (default 0: the paper's 2n^2 = 1152)")
    ap.add_argument("--num-sweeps", type=int, default=64,
                    help="annealing sweeps per read (default 64)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    W = shrunk_vgg_instance(0, device=dev)           # 8 x 100, the paper's Methods recipe
    print(f"instance W: {tuple(W.shape)}, ||W|| = {float(torch.linalg.norm(W)):.3f}")

    # --- the paper's original greedy algorithm (Eq. 5) ---
    g = greedy_decompose(W, 3, generator(dev, 0))
    print(f"greedy   cost  = {float(g.cost):.6f}  (rank-one steps, no refit)")

    # --- black-box optimisation (the paper's contribution) ---
    # paper budget: 24 initial points + 2n^2 = 1152 iterations; 4 runs in lock-step
    cfg = BBOConfig(n=24, N=8, K=3, algo="nbocs", solver="sa", iters=args.iters,
                    init_points=24, num_sweeps=args.num_sweeps)
    batch = run_bbo_batch(cfg, make_objective(W, 3), 4, generator(dev, 0))
    best = int(torch.argmin(batch.best_y))
    res_y = float(batch.best_y[best])
    M = batch.best_x[best].reshape(8, 3)
    print(f"nBOCS/SA cost  = {res_y:.6f}  "
          f"({'BETTER than' if res_y < float(g.cost) else 'matches'} greedy)")
    if res_y > float(g.cost) + 1e-6:
        print("BBO ended worse than greedy")
        return 1

    # --- deployable form: bit-packed M + real C ---
    C = least_squares_C(M, W)
    packed = pack_bits(M)
    if not torch.equal(unpack_bits(packed, 3), M):
        print("packed M did not round-trip")
        return 1
    bits = packed.numel() * 8 + C.numel() * 32
    print(f"storage: {bits} bits vs {W.numel() * 32} bits dense "
          f"(x{W.numel() * 32 / bits:.2f} compression at K=3)")
    reconstructed_cost = float(objective(M, W))
    if abs(reconstructed_cost - res_y) >= 1e-5:
        print(f"||W - MC||^2 = {reconstructed_cost:.6f} is not BBO's {res_y:.6f}")
        return 1
    print(f"||W - MC||^2 = {reconstructed_cost:.6f}")

    # --- scaling it up: the plan stage of the whole-model API ---
    # Planning is pure (no solver): policy rules pick per-path settings and
    # the plan predicts bytes/ratio before any compute is committed.
    toy_model = {
        "attn": {"wq": {"w": torch.zeros((256, 256), device="meta")}},
        "mlp": {"up": {"w": torch.zeros((256, 1024), device="meta")}},
    }
    policy = CompressionPolicy(
        method="greedy", tile_n=32, tile_d=128, rank_ratio=0.125, min_size=1,
        rules=(CompressionRule(pattern=r"attn", method="bbo", rank_ratio=0.375),),
    )
    plan = plan_compression(toy_model, policy)
    print("\nwhole-model plan (pure, solver-free):")
    print(plan.summary())
    print("-> done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
