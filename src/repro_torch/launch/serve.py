"""Serving launcher: batched generation, optionally from a checkpoint and
optionally with integer-decomposition-compressed weights.

Counterpart of ``repro/launch/serve.py``'s fixed-batch path.  When
``--ckpt-dir`` holds a compression manifest, the compressed checkpoint is
restored through the manifest's template and the engine validates the
restored tree against it; compressed layers then run through kernel K3 and
prefill attention through kernel K5.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b \
        --reduced --compress --steps 32 --batch 4

runs on the GPU (``serve_model(..., device="cpu")`` runs on the CPU with
the kernels' plain versions).  ``--autotune-kernels`` tunes the bitlinear
schedules of the served artifact at T = batch and batch x prompt_len before
the engine is built.

``--load-curve`` swaps the one-shot fixed-batch generation for the
continuous-batching tier (``serving/scheduler.py``): ragged prompts arrive
as a Poisson process at each ``--qps`` rate through the async front end,
and the launcher prints per-rate p50/p99 latency, goodput and peak
concurrency as a CSV (``load_curve``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --reduced --compress --load-curve
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compression import CompressionArtifact, CompressionPolicy
from repro_torch.compression import execute_plan, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.device import generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.models import init_model
from repro_torch.models.params import split
from repro_torch.serving.engine import Engine
from repro_torch.serving.frontend import ServeFrontend
from repro_torch.serving.loadgen import LoadResult, run_load
from repro_torch.serving.scheduler import Scheduler

__all__ = ["ServeResult", "build_engine", "serve_model", "load_curve", "main"]

PROMPT_SEED = 1     # prompts are drawn from this seed, as repro's launcher does
SAMPLE_SEED = 2


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor        # (batch, prompt_len + steps)
    prompts: torch.Tensor       # (batch, prompt_len)
    engine: Engine
    wall_s: float               # generate(), host clock, ends in a device sync
    timing: dict                # Engine.last_timing: prefill_s, decode_s, decode_steps


def build_engine(cfg, *, ckpt_dir=None, compress=False, batch=4, prompt_len=16, steps=32,
                 temperature=0.0, eos_id=1, seed=0, device=None, use_fused_bitlinear=None,
                 compress_policy: CompressionPolicy | None = None,
                 autotune_kernels: bool = False, verbose: bool = True) -> Engine:
    """Initialise ``cfg``'s weights from ``seed``, restore the latest step
    of ``ckpt_dir`` over them (through the compression manifest when one is
    there), compress them when ``compress`` and no manifest was found, tune
    the bitlinear schedules at T = batch and batch x prompt_len when
    ``autotune_kernels`` (``kernels.autotune.tune_artifact``), and build
    the ``Engine`` (``max_len`` = prompt_len + steps) on ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    values, _ = split(init_model(cfg, seed=seed, device=device))
    say = print if verbose else (lambda *a, **k: None)

    artifact = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, async_save=False)
        if CompressionArtifact.exists(ckpt_dir):
            # the checkpoint's tree is compressed: rewrite the dense template
            artifact = CompressionArtifact.load(ckpt_dir)
            step, state = mgr.restore_latest({"params": artifact.restore_template(values)},
                                             device=device)
            if state is not None:
                values = state["params"]
                t = artifact.manifest["totals"]
                say(f"[restore] step {step} (compressed: "
                    f"{len(artifact.manifest['tensors'])} tensors, x{t['ratio']:.2f})")
            else:
                say(f"[restore] {ckpt_dir}: manifest present but no checkpoint step; "
                    "serving dense init")
                artifact = None
        else:
            like = {"step": torch.zeros((), dtype=torch.int32), "params": values}
            step, state = mgr.restore_latest(like, device=device)
            if state is not None:
                values = state["params"]
                say(f"[restore] step {step}")

    if compress and artifact is None:
        policy = compress_policy or CompressionPolicy(
            method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5, min_size=4096)
        t = time.time()
        values, artifact = execute_plan(plan_compression(values, policy), values, seed=seed,
                                        device=device, verbose=verbose)
        say(f"[compress] {len(artifact.manifest['tensors'])} tensors, "
            f"ratio {artifact.total_ratio:.2f}x, {time.time() - t:.1f}s; "
            f"skipped {len(artifact.manifest['skipped'])}")

    if autotune_kernels and artifact is not None:
        from repro_torch.kernels import autotune

        t = time.time()
        table = autotune.tune_artifact(artifact, T_values=(batch, batch * prompt_len),
                                       device=device, verbose=verbose)
        say(f"[autotune] {len(table['entries'])} kernel schedule(s) in {time.time() - t:.1f}s")

    eng = Engine(cfg, values, max_len=prompt_len + steps, batch=batch,
                 temperature=temperature, eos_id=eos_id, artifact=artifact,
                 use_fused_bitlinear=use_fused_bitlinear)
    if eng.compression is not None:
        path = "fused bitlinear kernel" if eng.fused_bitlinear else "unpack+einsum"
        say(f"[engine] serving compressed weights via {path}: {eng.compression}")
    return eng


def serve_model(cfg, *, batch=4, prompt_len=16, steps=32, device=None, verbose: bool = True,
                **engine_kw) -> ServeResult:
    """``build_engine`` (the same arguments), then generate ``steps`` tokens
    for ``batch`` random prompts of ``prompt_len`` tokens on ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    eng = build_engine(cfg, batch=batch, prompt_len=prompt_len, steps=steps, device=device,
                       verbose=verbose, **engine_kw)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=make_generator(device, PROMPT_SEED), device=device)
    t = time.perf_counter()
    out = eng.generate(prompts, steps, generator=make_generator(device, SAMPLE_SEED))
    wall = time.perf_counter() - t
    say(f"generated: {tuple(out.shape)} in {wall:.2f}s ({batch * steps / wall:.1f} tok/s)")
    say(out[0, : prompt_len + 8].tolist())
    return ServeResult(out, prompts, eng, wall, eng.last_timing)


LOAD_CSV_HEADER = "qps,completed,goodput_toks_per_s,p50_ms,p99_ms,peak,evictions"


def load_curve(eng: Engine, cfg, *, qps=(2.0, 8.0, 32.0), requests=16, num_slots=4,
               page_size=16, prompt_len=16, steps=32, seed=0, device=None,
               say=print) -> list[LoadResult]:
    """The ``--load-curve`` sweep: a ``Scheduler`` of ``num_slots`` slots
    over a fully provisioned page pool (``max_len`` = prompt_len + steps;
    the page size halved until it divides ``max_len``), warmed up on one
    prompt of each length, then ``requests`` prompts of ``prompt_len / 2``
    or ``prompt_len`` random tokens (from ``seed``) sent as a Poisson
    process at each rate in ``qps`` through one ``ServeFrontend``
    (overcommit 2, ``4 x requests`` pending), each ``steps`` new tokens with
    an ``eos_id`` never emitted.  Prints the reference's CSV header and one
    row per rate through ``say``; returns the rates' ``LoadResult``s."""
    max_len = prompt_len + steps
    page = min(page_size, max_len)
    while max_len % page != 0:
        page //= 2
    sched = Scheduler(eng, num_slots=num_slots, page_size=page, max_len=max_len,
                      device=device)
    rng = np.random.default_rng(seed)
    lens = sorted({max(2, prompt_len // 2), prompt_len})
    # warm-up: one prefill of each length and the decode step
    sched.generate_batch([np.full(L, 3, np.int32) for L in lens], max_tokens=2)
    prompts = [
        rng.integers(0, cfg.vocab_size, size=int(rng.choice(lens))).astype(np.int32)
        for _ in range(requests)
    ]
    say(LOAD_CSV_HEADER)
    results = []
    with ServeFrontend(sched, overcommit=2.0, max_pending=4 * requests) as fe:
        for rate in qps:
            sched.stats.reset()
            res = run_load(fe, prompts, max_tokens=steps, qps=rate, eos_id=10 ** 6)
            say(f"{rate:g},{res.completed},{res.goodput_toks_per_s:.1f},"
                f"{1e3 * res.p50_latency_s:.1f},{1e3 * res.p99_latency_s:.1f},"
                f"{res.peak_running},{res.evictions}")
            results.append(res)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--tile-n", type=int, default=16)
    ap.add_argument("--tile-d", type=int, default=32)
    ap.add_argument("--rank-ratio", type=float, default=0.5)
    ap.add_argument("--compress-method", default="alternating",
                    choices=["greedy", "alternating", "bbo"])
    ap.add_argument("--no-fused-bitlinear", action="store_true",
                    help="serve compressed weights through the unpack+einsum form "
                         "instead of the fused bitlinear kernel")
    ap.add_argument("--autotune-kernels", action="store_true",
                    help="tune the bitlinear schedules of the served artifact before serving")
    ap.add_argument("--load-curve", action="store_true",
                    help="serve a Poisson arrival sweep through the continuous-batching "
                         "scheduler instead of one fixed-batch generate() call")
    ap.add_argument("--qps", type=float, nargs="*", default=[2.0, 8.0, 32.0],
                    help="arrival rates for --load-curve")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests per --load-curve rate")
    ap.add_argument("--num-slots", type=int, default=4,
                    help="decode slots for --load-curve")
    ap.add_argument("--page-size", type=int, default=16,
                    help="KV page size (tokens) for --load-curve")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_for_smoke(cfg)
    policy = CompressionPolicy(
        method=args.compress_method, tile_n=args.tile_n, tile_d=args.tile_d,
        rank_ratio=args.rank_ratio, min_size=4096,
    )
    kw = dict(ckpt_dir=args.ckpt_dir, compress=args.compress, batch=args.batch,
              prompt_len=args.prompt_len, steps=args.steps, temperature=args.temperature,
              seed=args.seed, use_fused_bitlinear=False if args.no_fused_bitlinear else None,
              compress_policy=policy, autotune_kernels=args.autotune_kernels)
    if args.load_curve:
        load_curve(build_engine(cfg, **kw), cfg, qps=args.qps, requests=args.requests,
                   num_slots=args.num_slots, page_size=args.page_size,
                   prompt_len=args.prompt_len, steps=args.steps, seed=args.seed)
        return
    serve_model(cfg, **kw)


if __name__ == "__main__":
    main()
