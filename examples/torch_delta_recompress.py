"""The train -> compress -> serve *cycle* on the PyTorch/CUDA port:
periodic delta recompression.

examples/torch_compress_then_serve.py shows the one-shot pipeline; this
example closes the loop for weights that keep drifting (continued
fine-tuning).  A :class:`repro_torch.optim.grad_compress.CompressionCycle`
fires every N steps from the training loop:

  1. first firing: full cold compression (plan + execute),
  2. later firings: ``delta_recompress`` against the previous artifact:
     per-tile drift is measured against the manifest's recorded residuals
     and only tiles past the threshold re-solve, warm-started from the
     previous (M, C); everything else reuses the parent's packed bytes,
  3. the final artifact carries the delta lineage block (parent
     fingerprint, generation, tiles reused vs re-solved) and serves
     through the Engine: the fused bitlinear kernel and unpack+einsum must
     emit identical greedy tokens.

    PYTHONPATH=src python examples/torch_delta_recompress.py \\
        [--train-steps 24] [--every 12] [--method alternating] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.compression import CompressionPolicy  # noqa: E402
from repro_torch.configs import get_config, reduced_for_smoke  # noqa: E402
from repro_torch.configs.base import ParallelConfig, ShapeConfig  # noqa: E402
from repro_torch.data import make_pipeline  # noqa: E402
from repro_torch.device import generator, resolve_device  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.optim.grad_compress import CompressionCycle  # noqa: E402
from repro_torch.serving import Engine  # noqa: E402
from repro_torch.training import init_train_state, make_train_step  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="alternating",
                    choices=["greedy", "alternating", "bbo"])
    ap.add_argument("--train-steps", type=int, default=24)
    ap.add_argument("--every", type=int, default=12,
                    help="recompress every N steps (cold first, delta after)")
    ap.add_argument("--threshold", type=float, default=None,
                    help="drift ratio past which a tile re-solves "
                         "(default: repro_torch.compression.delta's 1.25)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.train_steps < 2 * args.every:
        raise SystemExit("need train-steps >= 2*every so a delta fires "
                         f"(got {args.train_steps} < {2 * args.every})")
    dev = resolve_device(args.device)

    cfg = reduced_for_smoke(get_config("mistral-nemo-12b"))
    cfg = dataclasses.replace(cfg, d_model=128, d_ff=256, num_layers=4,
                              vocab_size=512, dtype="float32")
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"))
    shape = ShapeConfig("s", "train", 128, 8)

    policy = CompressionPolicy(
        method=args.method, tile_n=8 if args.method == "bbo" else 16,
        tile_d=128, rank_ratio=0.5, min_size=8192, bbo_iters=24,
    )
    cycle = CompressionCycle(policy, every=args.every, device=dev,
                             threshold=args.threshold, verbose=True)

    state = init_train_state(0, cfg, pcfg, device=dev)
    step = make_train_step(cfg, pcfg, warmup_cosine(3e-3, 10, args.train_steps))
    pipe = make_pipeline(cfg, shape, seed=0, device=dev)
    for i in range(args.train_steps):
        state, m = step(state, pipe.batch_at(i))
        fired = cycle.maybe_recompress(i + 1, state.params)
        if fired is not None:
            _, art = fired
            kind = "delta" if art.delta else "cold"
            print(f"step {i + 1}: {kind} recompression "
                  f"(x{art.compression_ratio:.2f}, loss {float(m['loss']):.3f})")
    print(f"trained {args.train_steps} steps, loss {float(m['loss']):.3f}")

    cvals, artifact = cycle.compressed, cycle.artifact
    d = artifact.delta
    if d is None:
        print("no delta fired: raise --train-steps or lower --every")
        return 1
    print(f"delta lineage: parent {d['parent_fingerprint']} "
          f"generation {d['generation']}, re-solved "
          f"{d['tiles_resolved']}/{d['tiles_total']} tiles "
          f"({d['fraction_resolved']:.1%}), reused {d['tiles_reused']}")
    if d["tiles_reused"] <= 0:
        print("delta reused no tiles: drift threshold too low for this run")
        return 1

    # serve the delta artifact both ways; greedy tokens must be identical.
    # The hooks are process-global and read at call time: each engine's
    # generate runs under the setting its construction installed.
    prompts = torch.randint(0, cfg.vocab_size, (4, 12), generator=generator(dev, 7), device=dev)
    eng_e = Engine(cfg, cvals, max_len=44, batch=4, artifact=artifact,
                   use_fused_bitlinear=False)
    out_e = eng_e.generate(prompts, steps=24)
    eng_f = Engine(cfg, cvals, max_len=44, batch=4, artifact=artifact,
                   use_fused_bitlinear=True)
    out_f = eng_f.generate(prompts, steps=24)
    if not torch.equal(out_e, out_f):
        print("fused vs einsum greedy tokens diverged on the delta artifact")
        return 1
    print(f"serving delta artifact: {eng_f.compression}")
    print("fused vs einsum greedy tokens identical on the delta artifact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
