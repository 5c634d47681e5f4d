"""Compression launcher: init -> plan -> execute -> checkpoint + manifest.

Counterpart of the one-shot path of ``repro/launch/compress.py``:

    PYTHONPATH=src python -m repro_torch.launch.compress --arch qwen3-32b \
        --reduced --method greedy --tile-n 16 --tile-d 32 --min-size 4096 \
        --out-dir /tmp/cc

runs on the GPU and writes a checkpoint and ``compression_manifest.json``
that ``repro`` restores and serves as well.  ``--autotune-kernels`` times
the bitlinear schedules of every compressed geometry on the card and stores
the winners in the manifest's ``kernel_schedules``, which ``Engine``
installs.

With ``--budget-mb`` the flags (or ``--policy``) become the base policy of
the rate-distortion autotuner (:mod:`repro_torch.compression.autotune`):
per-tensor (K, tile) settings are chosen by probing RD curves and
allocating the byte budget (``--engine greedy|qubo``), optionally weighted
by calibration (``--calibrate``), minimising weight-space distortion or
measured eval loss (``--objective eval-loss``):

    PYTHONPATH=src python -m repro_torch.launch.compress --arch qwen3-32b \
        --reduced --budget-mb 0.12 --tile-n 16 --tile-d 32 --rank-ratio 0.5 \
        --min-size 4096 --probe-tiles 8 --engine qubo --calibrate

``--streaming`` switches to the bounded-memory pipeline
(:mod:`repro_torch.compression.streaming`): the plan comes from checkpoint
metadata (or a ``meta`` template with ``--metadata-only``), the RD probe of
``--budget-mb`` uses SVD-tail surrogates, and the execute walks the
checkpoint one leaf at a time under ``REPRO_STREAM_BUDGET_BYTES`` (or
``--stream-budget-mb``), saving job state so a killed run resumes:

    PYTHONPATH=src python -m repro_torch.launch.compress --arch llama3-405b \
        --streaming --metadata-only --budget-mb 200000 --plan-only

    PYTHONPATH=src python -m repro_torch.launch.compress --arch mamba2-130m \
        --streaming --ckpt-dir /ckpts/run1 --out-dir /ckpts/run1-c

``--delta-from <dir>`` recompresses drifted weights as a delta against a
compressed checkpoint (:mod:`repro_torch.compression.delta`): geometry and
method come from the parent manifest, only tiles whose drift ratio crossed
``--delta-threshold`` re-solve, warm-started from the parent's factors:

    PYTHONPATH=src python -m repro_torch.launch.compress --arch mamba2-130m \
        --ckpt-dir /ckpts/run1-more-steps --delta-from /ckpts/run1-c \
        --out-dir /ckpts/run1-c2

Both print ``key=value`` lines for scripts (``stream_wall_s``, ``probe_s``,
``peak_rss_bytes``; ``delta_wall_s``, ``fraction_resolved``).
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

__all__ = ["compress_model", "build_policy", "run_streaming", "run_delta", "main"]


def report_autotune(result, budget_bytes: int) -> None:
    """The autotuner's lines: probe and allocation, the eval table and the
    LP cross-check where they ran."""
    a = result.allocation
    print(
        f"[autotune/{a.engine}] probed {len(result.probes)} tensors "
        f"in {result.probe_s:.1f}s, allocated "
        f"{a.total_bytes / 2**20:.2f} of {budget_bytes / 2**20:.2f} MiB "
        f"(solve {a.solve_s * 1e3:.1f} ms)"
    )
    if result.metric_table is not None:
        table = result.metric_table
        print(
            f"[eval] baseline loss {table.baseline.loss:.4f}, "
            f"{len(table.exact_paths)} tensor(s) spliced exactly, "
            f"surrogate skip rate {table.surrogate_skip_rate:.0%} "
            f"(table {table.build_s:.1f}s)"
        )
    if result.lp_check is not None:
        lp = result.lp_check
        print(
            f"[lp] {lp['status']}: gap {lp['relative_gap']:+.2%} "
            f"({'within' if lp['within_tolerance'] else 'OVER'} "
            f"{lp['tolerance']:.0%} tolerance)"
        )


def compress_model(cfg, policy, out_dir, *, seed: int = 0, device=None,
                   max_pool_tiles="auto", values=None, autotune_kernels: bool = False,
                   verbose: bool = True, budget_bytes: int | None = None, **autotune_kw):
    """Initialise ``cfg``'s weights from ``seed`` (unless ``values`` are
    given), plan and execute ``policy`` over them on ``device`` (default:
    the GPU), save the compressed params as checkpoint step 0 under
    ``out_dir`` with the artifact manifest.  With ``budget_bytes`` the plan
    is the autotuner's (``autotune_plan``, ``policy`` its base; further
    keywords, e.g. ``engine``, ``objective``, ``calibration``,
    ``k_fractions``, go to it), and ``compress_model.last_autotune`` keeps
    its :class:`AutotuneResult`.  With ``autotune_kernels`` the bitlinear
    schedules are tuned first (``kernels.autotune.tune_artifact``) so the
    manifest carries the table.  Returns (params, artifact)."""
    device = resolve_device(device)
    if values is None:
        values, _ = split(init_model(cfg, seed=seed, device=device))
    if budget_bytes is not None:
        from repro_torch.compression.autotune import autotune_plan

        autotune_kw.setdefault("cfg", cfg)
        result = autotune_plan(values, policy, budget_bytes, seed=seed, device=device,
                               verbose=verbose, **autotune_kw)
        compress_model.last_autotune = result
        plan = result.plan
        if verbose:
            report_autotune(result, budget_bytes)
    elif autotune_kw:
        raise TypeError(f"compress_model: {sorted(autotune_kw)} only apply with budget_bytes")
    else:
        plan = plan_compression(values, policy)
    if verbose:
        print(plan.summary())
    t = time.time()
    cvalues, artifact = execute_plan(
        plan, values, seed=seed, device=device, max_pool_tiles=max_pool_tiles,
        verbose=verbose,
    )
    compress_model.execute_s = time.time() - t
    if verbose:
        print(f"\n[compress/{policy.method}] {len(artifact.manifest['tensors'])} "
              f"tensors in {compress_model.execute_s:.1f}s")
        print(artifact.summary())
        print(f"compressed tensors: {artifact.manifest['totals']['orig_bytes'] / 2**20:.2f} "
              f"-> {artifact.total_bytes() / 2**20:.2f} MiB (x{artifact.compression_ratio:.2f})")
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


compress_model.last_autotune = None
compress_model.execute_s = 0.0


def build_policy(args) -> CompressionPolicy:
    if args.policy:
        with open(args.policy) as f:
            return CompressionPolicy.from_json(f.read())
    return CompressionPolicy(
        method=args.method, tile_n=args.tile_n, tile_d=args.tile_d,
        rank_ratio=args.rank_ratio, min_size=args.min_size,
        bbo_iters=args.bbo_iters, solver_backend=args.backend,
    )


def run_streaming(args, cfg) -> None:
    """The ``--streaming`` pipeline on the GPU."""
    from repro_torch.compression.streaming import (
        CheckpointLeafSource,
        RssSampler,
        TreeLeafSource,
        peak_rss_bytes,
        run_compression_job,
        streaming_autotune_plan,
    )

    device = resolve_device()
    if args.ckpt_dir:
        source = CheckpointLeafSource(args.ckpt_dir)
    elif args.metadata_only:
        # shapes and dtypes of the whole model as meta tensors: no weight
        # is allocated, so a llama3-405b plan costs host megabytes
        source = TreeLeafSource(split(init_model(cfg, seed=args.seed, device="meta"))[0])
    else:
        source = TreeLeafSource(split(init_model(cfg, seed=args.seed, device=device))[0])
    print(f"[stream] source {source.describe()}")

    policy = build_policy(args)
    budget_bytes = (int(args.stream_budget_mb * 2**20)
                    if args.stream_budget_mb is not None else None)
    t0 = time.time()
    with RssSampler() as rss:
        if args.budget_mb is not None:
            result = streaming_autotune_plan(
                source, policy, int(args.budget_mb * 2**20), seed=args.seed, device=device,
                engine=args.engine or "greedy", sample_tiles=args.sample_tiles or 8,
                backend=args.backend, verbose=True,
            )
        else:
            plan = plan_compression(source.template(), policy)
    if args.budget_mb is not None:
        plan = result.plan
        probe = plan.autotune["probe"]
        print(
            f"[autotune/stream] {probe['source']} surrogate probe of "
            f"{len(result.probes)} tensors in {result.probe_s:.2f}s, exact fallback on "
            f"{len(probe['exact_fallback'])} of {len(probe['boundary'])} boundary "
            f"tensor(s), allocated {result.allocation.total_bytes / 2**20:.2f} of "
            f"{args.budget_mb:.2f} MiB"
        )
        print(f"probe_s={result.probe_s:.3f}")
    print(plan.summary())
    if args.plan_only:
        print(f"[stream] planned in {time.time() - t0:.1f}s")
        print(f"peak_rss_bytes={peak_rss_bytes(rss.peak)}")
        return

    artifact, stats = run_compression_job(
        source, plan, args.out_dir, seed=args.seed, device=device, backend=args.backend,
        budget_bytes=budget_bytes,
        max_restarts=3 if args.max_restarts is None else args.max_restarts, verbose=True,
    )
    print(
        f"\n[stream] {stats['leaves_done_this_run']} leaves this run "
        f"({stats['resumed_leaves']} resumed), {stats['chunks']} solve chunk(s), "
        f"{stats['restarts']} restart(s), {stats['wall_s']:.1f}s"
    )
    print(f"compressed tensors: {artifact.manifest['totals']['orig_bytes'] / 2**20:.2f} "
          f"-> {artifact.total_bytes() / 2**20:.2f} MiB (x{artifact.compression_ratio:.2f})")
    if args.budget_mb is not None:
        over = artifact.total_bytes() > int(args.budget_mb * 2**20)
        print(f"budget: {args.budget_mb:.2f} MiB -> {'OVER' if over else 'met'}")
    print(f"saved compressed params to {args.out_dir}")
    print(f"stream_wall_s={stats['wall_s']:.3f}")
    print(f"peak_rss_bytes={stats['peak_rss_bytes']}")


def run_delta(args, values, device) -> None:
    """The ``--delta-from`` pipeline: anchor on a compressed checkpoint and
    re-solve only the drifted tiles."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.compression import (
        ColdStartRequired,
        CompressionArtifact,
        delta_recompress,
        plan_delta,
    )

    parent = CompressionArtifact.load(args.delta_from)
    template = parent.restore_template(values)
    step, state = CheckpointManager(args.delta_from, async_save=False).restore_latest(
        {"params": template}, device=device
    )
    if state is None:
        raise SystemExit(f"--delta-from {args.delta_from}: manifest found but no "
                         "restorable compressed checkpoint")
    prev = state["params"]
    print(f"[delta] parent {parent.fingerprint()} (step {step}, "
          f"{len(parent.manifest['tensors'])} tensors)")
    kw = {} if args.delta_threshold is None else {"threshold": args.delta_threshold}
    try:
        if args.plan_only:
            print(plan_delta(parent, prev, values, device=device, **kw).summary())
            return
        t = time.time()
        cvalues, artifact = delta_recompress(parent, prev, values, seed=args.seed,
                                             device=device, backend=args.backend,
                                             verbose=True, **kw)
        dt = time.time() - t
    except ColdStartRequired as e:
        raise SystemExit(f"--delta-from cannot anchor on {args.delta_from}: {e}\n"
                         "run a full compression (drop --delta-from) instead")
    d = artifact.delta
    print(f"\n[delta] gen {d['generation']}: {d['tiles_resolved']}/{d['tiles_total']} "
          f"tiles re-solved ({d['fraction_resolved']:.1%}) across "
          f"{d['tensors_touched']} tensor(s) in {dt:.1f}s")
    path = checkpointer.save(args.out_dir, 0, {"params": cvalues})
    mpath = artifact.save(args.out_dir)
    print(f"saved compressed params to {path}")
    print(f"saved compression manifest to {mpath}")
    print(f"delta_wall_s={dt:.3f}")
    print(f"fraction_resolved={d['fraction_resolved']:.4f}")


def _stray(pairs) -> list:
    return [name for name, val in pairs if val is not None]


def _check_flags(ap, args) -> None:
    """The reference CLI's checks of which flags combine."""
    if args.delta_from:
        stray = _stray((("--streaming", args.streaming or None),
                        ("--budget-mb", args.budget_mb),
                        ("--policy", args.policy),
                        ("--autotune-kernels", args.autotune_kernels or None)))
        if stray:
            ap.error(f"{', '.join(stray)} do not apply with --delta-from (geometry, method "
                     "and kernel schedules come from the parent manifest)")
    elif args.delta_threshold is not None:
        ap.error("--delta-threshold only applies with --delta-from")
    if not args.streaming:
        stray = _stray((("--metadata-only", args.metadata_only or None),
                        ("--stream-budget-mb", args.stream_budget_mb),
                        ("--sample-tiles", args.sample_tiles),
                        ("--max-restarts", args.max_restarts)))
        if stray:
            ap.error(f"{', '.join(stray)} only apply with --streaming")
    else:
        if args.calibrate:
            ap.error("--calibrate needs the full model in memory; it does not compose "
                     "with --streaming")
        if args.probe_tiles is not None:
            ap.error("--probe-tiles is the in-memory probe knob; use --sample-tiles "
                     "with --streaming")
        if args.metadata_only and not args.plan_only:
            ap.error("--metadata-only has no tensor data to execute on; add --plan-only "
                     "(or drop --metadata-only)")
        if args.metadata_only and args.ckpt_dir:
            ap.error("--metadata-only and --ckpt-dir are mutually exclusive sources")
    if args.budget_mb is None:
        stray = [
            name for name, val in (
                ("--engine", args.engine),
                ("--calibrate", args.calibrate or None),
                ("--calib-batch", args.calib_batch),
                ("--calib-seq", args.calib_seq),
                ("--calib-batches", args.calib_batches),
                ("--probe-tiles", args.probe_tiles),
                ("--objective", args.objective if args.objective != "frobenius" else None),
                ("--eval-batches", args.eval_batches),
                ("--eval-seq", args.eval_seq),
            ) if val is not None
        ]
        if stray:
            ap.error(f"{', '.join(stray)} only apply with --budget-mb "
                     "(the autotune path)")
    elif not args.calibrate and (
        args.calib_batch is not None or args.calib_seq is not None
        or args.calib_batches is not None
    ):
        ap.error("--calib-batch/--calib-seq/--calib-batches require --calibrate")
    if args.objective == "eval-loss":
        if args.streaming:
            ap.error("--objective eval-loss needs the full model in memory to splice "
                     "candidates; it does not compose with --streaming")
    elif args.eval_batches is not None or args.eval_seq is not None:
        ap.error("--eval-batches/--eval-seq require --objective eval-loss")
    if (args.calib_batches or 1) > 1 and (
        args.calib_batch is not None or args.calib_seq is not None
    ):
        ap.error("--calib-batches > 1 draws default-shaped batches; it is "
                 "mutually exclusive with --calib-batch/--calib-seq")


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
    ap.add_argument("--streaming", action="store_true",
                    help="bounded-memory pipeline: plan from metadata, surrogate RD probe, "
                         "leaf-at-a-time resumable execute")
    ap.add_argument("--metadata-only", action="store_true",
                    help="with --streaming: plan/probe from a meta template, no weight is "
                         "allocated (requires --plan-only)")
    ap.add_argument("--stream-budget-mb", type=float, default=None,
                    help="host-memory budget of streaming solves "
                         "(default REPRO_STREAM_BUDGET_BYTES or 1 GiB)")
    ap.add_argument("--sample-tiles", type=int, default=None,
                    help="surrogate probe sample tiles per (tensor, geometry) (default 8)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="streaming job supervision restarts (default 3)")
    ap.add_argument("--delta-from", default=None,
                    help="compressed checkpoint dir (manifest + compressed params): "
                         "recompress the current weights as a warm-started delta against it")
    ap.add_argument("--delta-threshold", type=float, default=None,
                    help="drift ratio above which a tile re-solves (default 1.25; an "
                         "unchanged tile sits at 1.0)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="autotune to this compressed-bytes budget (rate-distortion allocation)")
    ap.add_argument("--engine", default=None, choices=["greedy", "qubo"],
                    help="budget allocator engine (default greedy; qubo anneals the one-hot "
                         "QUBO encoding through ising.solve_many)")
    ap.add_argument("--calibrate", action="store_true",
                    help="weight probed distortion by activation-sensitivity second moments "
                         "from a calibration batch")
    ap.add_argument("--calib-batch", type=int, default=None)
    ap.add_argument("--calib-seq", type=int, default=None)
    ap.add_argument("--calib-batches", type=int, default=None,
                    help="calibration batches averaged into the sensitivity weights "
                         "(default 1)")
    ap.add_argument("--objective", default="frobenius", choices=["frobenius", "eval-loss"],
                    help="what the budget allocator minimises: weight-space Frobenius "
                         "distortion, or measured eval-loss deltas (requires --budget-mb)")
    ap.add_argument("--eval-batches", type=int, default=None,
                    help="eval harness batches for --objective eval-loss (default 4)")
    ap.add_argument("--eval-seq", type=int, default=None,
                    help="eval harness sequence length (default 32)")
    ap.add_argument("--probe-tiles", type=int, default=None,
                    help="trial-compressed tiles per (tensor, candidate); 0 probes every "
                         "tile (default 16)")
    ap.add_argument("--autotune-kernels", action="store_true",
                    help="time the bitlinear schedules of every compressed geometry and "
                         "persist the winners in manifest['kernel_schedules']")
    args = ap.parse_args(argv)
    _check_flags(ap, args)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    if args.streaming:
        run_streaming(args, cfg)
        return
    device = resolve_device()
    values, _ = split(init_model(cfg, seed=args.seed, device=device))
    if args.ckpt_dir:
        step = checkpointer.latest_step(args.ckpt_dir)
        if step is not None:
            values = checkpointer.restore(
                args.ckpt_dir, step, {"params": values}, device=device
            )["params"]
            print(f"[restore] step {step}")
    if args.delta_from:
        run_delta(args, values, device)
        return
    policy = build_policy(args)
    if args.budget_mb is None:
        if args.plan_only:
            print(plan_compression(values, policy).summary())
            return
        compress_model(cfg, policy, args.out_dir, seed=args.seed, device=device,
                       values=values, autotune_kernels=args.autotune_kernels)
        return
    from repro_torch.compression.autotune import autotune_plan, calibration_inputs

    budget_bytes = int(args.budget_mb * 2**20)
    probe_tiles = 16 if args.probe_tiles is None else args.probe_tiles
    cal_inputs = None
    if args.calibrate and (args.calib_batch or args.calib_seq):
        cal_inputs = calibration_inputs(cfg, batch=args.calib_batch or 4,
                                        seq_len=args.calib_seq or 32, seed=args.seed,
                                        device=device)
    autotune_kw = dict(
        engine=args.engine or "greedy", objective=args.objective.replace("-", "_"),
        calibration=args.calibrate, calibration_inputs=cal_inputs,
        calib_batches=args.calib_batches or 1, eval_batches=args.eval_batches or 4,
        eval_seq=args.eval_seq or 32, eval_seed=args.seed,
        max_probe_tiles=probe_tiles or None, backend=args.backend,
    )
    if args.plan_only:
        result = autotune_plan(values, policy, budget_bytes, seed=args.seed, device=device,
                               cfg=cfg, verbose=True, **autotune_kw)
        report_autotune(result, budget_bytes)
        print(result.plan.summary())
        return
    _, artifact = compress_model(cfg, policy, args.out_dir, seed=args.seed, device=device,
                                 values=values, autotune_kernels=args.autotune_kernels,
                                 budget_bytes=budget_bytes, **autotune_kw)
    over = artifact.total_bytes() > budget_bytes
    print(f"budget: {args.budget_mb:.2f} MiB -> {'OVER' if over else 'met'}")


if __name__ == "__main__":
    main()
