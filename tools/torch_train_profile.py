#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's training step goes, on one GPU.

    python3 tools/torch_train_profile.py [--arch granite-moe-1b-a400m] [--batch 8]
                                         [--seq-len 1024] [--microbatches 2]

Trains ``chip_smoke.py`` phase 11's configuration: the whole model at its
published widths and depth (random weights from seed 0), AdamW with f32
accumulation, remat, batches from ``make_pipeline`` (seed 0).  After two
warm-up steps it prints JSON lines with:

  * ``step_ms``: three steps, each timed by the host clock to a
    synchronise;
  * ``parts_ms``: one microbatch's forward alone (``train_loss`` under
    ``torch.no_grad``), its loss and gradients (forward, remat's
    recomputation, backward), and the optimiser's update alone, each timed
    to a synchronise, median of three;
  * ``layer_ms``: one layer's attention and MoE blocks at a microbatch's
    shape, forward, by CUDA events (median of five), beside the plain
    chunked attention alone and the MoE's dispatch and combine einsums
    alone;
  * ``trace``: one step under ``torch.profiler``: host wall time, device
    busy time (the sum of kernel times: one stream), the idle share, the
    launches, and device time and launches per kernel name, largest first,
    and per class of kernel (GEMM, elementwise, reduction, copy, other).

Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_ms(torch, fn, reps: int = 3) -> float:
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def event_ms(torch, fn, reps: int = 5) -> float:
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def kernel_class(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "nvjet", "sm90_", "sm80_", "cutlass", "cublas", "xmma")):
        return "gemm"
    if any(k in n for k in ("reduce", "softmax", "norm", "cumsum", "scan", "sort")):
        return "reduction"
    if any(k in n for k in ("copy", "cat", "memcpy", "memset", "index", "gather", "scatter")):
        return "copy"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    return "other"


def traced(torch, fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    times, counts = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] += e.time_range.elapsed_us() / 1e3
            counts[e.name] += 1
    if not times:
        raise RuntimeError("the profiler recorded no device events")
    busy = sum(times.values())
    classes = collections.Counter()
    for name, ms in times.items():
        classes[kernel_class(name)] += ms
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "launches": sum(counts.values()),
            "by_class_ms": dict(classes.most_common()),
            "kernels": [{"name": n[:120], "ms": ms, "launches": counts[n]}
                        for n, ms in times.most_common(25)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=1024)
    ap.add_argument("--microbatches", type=int, default=2)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.kernels.ops import kernels_off
    from repro_torch.models import attention, layers, model_dtype, moe, train_loss
    from repro_torch.models.transformer import _index
    from repro_torch.optim import constant
    from repro_torch.training import init_train_state, make_optimizer, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit({"gpu": torch.cuda.get_device_name(0), "torch": torch.__version__})
    cfg = get_config(args.arch)
    pcfg = ParallelConfig(mesh_shape=(1, 1), mesh_axes=("data", "model"),
                          microbatches=args.microbatches)
    state = init_train_state(0, cfg, pcfg, device=dev)
    step_fn = make_train_step(cfg, pcfg, constant(1e-3))
    pipe = make_pipeline(cfg, ShapeConfig("custom", "train", args.seq_len, args.batch),
                         device=dev)
    box = {"state": state}

    def one_step(i=0):
        box["state"], m = step_fn(box["state"], pipe.batch_at(i))
        return float(m["loss"])

    for i in range(2):
        one_step(i)
    steps = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(2 + i)
        steps.append(1e3 * (time.perf_counter() - t0))
    emit({"step_ms": steps, "tokens_per_step": args.batch * args.seq_len})

    # one microbatch's forward, loss + gradients, and the optimiser alone
    params = box["state"].params
    mb = {k: v[: args.batch // args.microbatches] for k, v in pipe.batch_at(0).items()}

    def forward_only():
        with torch.no_grad(), kernels_off():
            train_loss(params, mb, cfg)

    leaves = {}

    def loss_and_grads():
        from repro_torch.compression.plan import tree_paths
        from repro_torch.compression.execute import _replace

        pairs = tree_paths(params)
        live = [t.detach().requires_grad_(True) for _, t in pairs]
        with kernels_off():
            loss = train_loss(_replace(params, dict(zip((p for p, _ in pairs), live))),
                              mb, cfg)[0]
            grads = torch.autograd.grad(loss, live)
        leaves["grads"] = _replace(params, {p: g.float() for (p, _), g in zip(pairs, grads)})

    opt = make_optimizer(pcfg)

    def update():
        s = box["state"]
        opt.update(leaves["grads"], s.opt, s.params, s.step, torch.tensor(0.0, device=dev))

    parts = {"forward": host_ms(torch, forward_only), "loss_and_grads":
             host_ms(torch, loss_and_grads), "optimizer": host_ms(torch, update)}
    leaves.clear()
    emit({"parts_ms": parts, "microbatch_tokens": mb["tokens"].numel()})

    # one layer's blocks at a microbatch's shape
    p0 = _index(params["groups"], 0)["0"]
    g = torch.Generator(device=dev).manual_seed(0)
    B = args.batch // args.microbatches
    dt = model_dtype(cfg)
    h = (torch.randn(B, args.seq_len, cfg.d_model, generator=g, device=dev) * 0.5).to(dt)
    hd, KV = cfg.resolved_head_dim, cfg.num_kv_heads
    rep = cfg.num_heads // KV
    qh = torch.randn(B, args.seq_len, KV, rep, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, args.seq_len, KV, hd, generator=g, device=dev).to(dt)
    onehot = torch.rand(B, args.seq_len, cfg.experts_per_token, cfg.num_experts,
                        generator=g, device=dev)
    C = moe.moe_capacity(cfg, min(args.seq_len, moe.ROUTE_BLOCK))
    pos_oh = torch.rand(B, args.seq_len, cfg.experts_per_token, C, generator=g, device=dev)
    dispatch = torch.einsum("bske,bskc->bsec", onehot, pos_oh).to(dt)
    xout = torch.randn(cfg.num_experts, B, C, cfg.d_model, generator=g, device=dev).to(dt)
    with torch.no_grad(), kernels_off():
        n = layers.rms_norm(h, p0["norm1"], cfg.norm_eps)
        layer = {
            "attention_block": event_ms(torch, lambda: attention.attention(n, p0["attn"], cfg)),
            "chunked_attention": event_ms(torch, lambda: attention._chunked_attention(
                qh, k, k, 0, attention.Q_CHUNK_DEFAULT)),
            "moe_block": event_ms(torch, lambda: moe.moe_block(n, p0["moe"], cfg)),
            "dispatch_onehot_einsum": event_ms(
                torch, lambda: torch.einsum("bske,bskc->bsec", onehot, pos_oh)),
            "dispatch_einsum": event_ms(torch, lambda: torch.einsum("bsec,bsd->ebcd",
                                                                    dispatch, h)),
            "combine_einsum": event_ms(torch, lambda: torch.einsum("bsec,ebcd->bsd",
                                                                   dispatch, xout)),
        }
    emit({"layer_ms": layer, "capacity": C, "microbatch_rows": B})

    emit({"trace": traced(torch, lambda: one_step(5))})
    emit({"peak_memory_allocated_bytes": torch.cuda.max_memory_allocated()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
