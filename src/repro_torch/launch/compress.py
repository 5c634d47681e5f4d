"""Compression launcher: init -> plan -> execute -> checkpoint + manifest.

Counterpart of the one-shot path of ``repro/launch/compress.py``:

    PYTHONPATH=src python -m repro_torch.launch.compress --arch qwen3-32b \
        --reduced --method greedy --tile-n 16 --tile-d 32 --min-size 4096 \
        --out-dir /tmp/cc

runs on the GPU and writes a checkpoint and ``compression_manifest.json``
that ``repro`` restores and serves as well.  ``--autotune-kernels`` times
the bitlinear schedules of every compressed geometry on the card and stores
the winners in the manifest's ``kernel_schedules``, which ``Engine``
installs.  ``--streaming``, ``--delta-from`` and ``--budget-mb`` are not
ported yet (ROADMAP.md) and exit with a message.
"""

from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import checkpointer
from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.models.params import split

__all__ = ["compress_model", "build_policy", "main"]


def compress_model(cfg, policy, out_dir, *, seed: int = 0, device=None,
                   max_pool_tiles="auto", values=None, autotune_kernels: bool = False,
                   verbose: bool = True):
    """Initialise ``cfg``'s weights from ``seed`` (unless ``values`` are
    given), plan and execute ``policy`` over them on ``device`` (default:
    the GPU), save the compressed params as checkpoint step 0 under
    ``out_dir`` with the artifact manifest.  With ``autotune_kernels`` the
    bitlinear schedules are tuned first (``kernels.autotune.tune_artifact``)
    so the manifest carries the table.  Returns (params, artifact)."""
    device = resolve_device(device)
    if values is None:
        values, _ = split(init_model(cfg, seed=seed, device=device))
    plan = plan_compression(values, policy)
    if verbose:
        print(plan.summary())
    t = time.time()
    cvalues, artifact = execute_plan(
        plan, values, seed=seed, device=device, max_pool_tiles=max_pool_tiles,
        verbose=verbose,
    )
    if verbose:
        print(f"\n[compress/{policy.method}] {len(artifact.manifest['tensors'])} "
              f"tensors in {time.time() - t:.1f}s")
        print(artifact.summary())
    if autotune_kernels:
        from repro_torch.kernels import autotune

        t = time.time()
        table = autotune.tune_artifact(artifact, device=device, verbose=verbose)
        if verbose:
            print(f"[autotune] {len(table['entries'])} kernel schedule(s) in "
                  f"{time.time() - t:.1f}s")
    path = checkpointer.save(out_dir, 0, {"params": cvalues})
    mpath = artifact.save(out_dir)
    if verbose:
        print(f"saved compressed params to {path}")
        print(f"saved compression manifest to {mpath}")
    return cvalues, artifact


def build_policy(args) -> CompressionPolicy:
    if args.policy:
        with open(args.policy) as f:
            return CompressionPolicy.from_json(f.read())
    return CompressionPolicy(
        method=args.method, tile_n=args.tile_n, tile_d=args.tile_d,
        rank_ratio=args.rank_ratio, min_size=args.min_size,
        bbo_iters=args.bbo_iters, solver_backend=args.backend,
    )


_NOT_PORTED = ("streaming", "delta_from", "budget_mb")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None, help="source checkpoint")
    ap.add_argument("--out-dir", default="/tmp/repro_compressed")
    ap.add_argument("--policy", default=None,
                    help="CompressionPolicy JSON file; overrides the flags below")
    ap.add_argument("--plan-only", action="store_true")
    ap.add_argument("--method", default="alternating",
                    choices=["greedy", "alternating", "bbo", "int8"])
    ap.add_argument("--tile-n", type=int, default=32)
    ap.add_argument("--tile-d", type=int, default=128)
    ap.add_argument("--rank-ratio", type=float, default=0.125)
    ap.add_argument("--min-size", type=int, default=1 << 16)
    ap.add_argument("--bbo-iters", type=int, default=64)
    ap.add_argument("--backend", default="auto", choices=["auto", "cuda", "torch"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--streaming", action="store_true")
    ap.add_argument("--delta-from", default=None)
    ap.add_argument("--budget-mb", type=float, default=None)
    ap.add_argument("--autotune-kernels", action="store_true",
                    help="time the bitlinear schedules of every compressed geometry and "
                         "persist the winners in manifest['kernel_schedules']")
    args = ap.parse_args(argv)
    for name in _NOT_PORTED:
        if getattr(args, name):
            ap.exit(2, f"--{name.replace('_', '-')} is not yet ported to repro_torch "
                       "(see ROADMAP.md, Queue 1); use repro.launch.compress\n")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    device = resolve_device()
    values, _ = split(init_model(cfg, seed=args.seed, device=device))
    if args.ckpt_dir:
        step = checkpointer.latest_step(args.ckpt_dir)
        if step is not None:
            values = checkpointer.restore(
                args.ckpt_dir, step, {"params": values}, device=device
            )["params"]
            print(f"[restore] step {step}")
    policy = build_policy(args)
    if args.plan_only:
        print(plan_compression(values, policy).summary())
        return
    compress_model(cfg, policy, args.out_dir, seed=args.seed, device=device,
                   values=values, autotune_kernels=args.autotune_kernels)


if __name__ == "__main__":
    main()
