#!/usr/bin/env python3
"""K1's global-memory body as an earlier commit builds it, against this tree's.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/torch_k1_global_ab.py --parent build/parent

``--parent`` names an earlier checkout; ``--variant DIR`` (repeatable) a
directory that holds a ``sa_sweep.cu`` and its ``anneal_step.cuh`` (e.g. a
checkout's ``src/repro_torch/csrc``) whose C interface has
``sa_sweep_many_global_f32`` (h, B, x0, u, temps, theta, x, e, P, C, S, n,
direct, stream).  Each is built with this tree's flags into
``build/k1_global_ab/``.  On normal h and B, whose sums round, every variant
must give this tree's spins and energies bit for bit, and each is timed as
device time (CUDA events, median of 5, the L2 overwritten before each
launch, the card kept busy while the host enqueues it) in the order
variant, this, this, variant, at: the budget allocator's QUBO shape (6
problems x 8 reads x 96 sweeps, ising's annealing schedule) at n = 238, 512
and 1,024; one problem's 8 reads at n = 256 (1, 8, 96); BBO pools of 4
reads x 24 sweeps: at n = tn K = 256 33 tiles (132 chains, one wave of
split blocks on an H100), the executor's smallest chunk of 64 tiles (256
chains, two waves) and 2,048 tiles (537 MB of B), the 64-tile chunk at n =
480, 512 and 1,024 too and 67 tiles at 1,024 (three waves); and 192
chains at n = 1,024 (24 x 8 x 96, two waves).  At every shape above 237
spins this tree's two forms of the body (each chain split over a block's
warps, a warp a chain) are also timed against each other, beside the form
the rule picks.  Prints the card, the
ptxas registers and spills of every global-body instance, and one JSON line
per (variant, shape), with each side's time at one sweep beside (the
initial fields and the final energy) and the per-sweep time it leaves; and
at n = 237, this tree's shared-memory body against its global-memory body
on the same inputs.  Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "k1_global_ab")
sys.path.insert(0, os.path.join(ROOT, "src"))

SPIN_CYCLES = 200_000
# (P, C, S, n): the allocator's QUBO at n = 237 (this tree's two bodies),
# 238, 512, 1,024; one problem's reads; BBO pools at n = 256 on both sides
# of one wave of split blocks, at 480, 512 and 1,024 in two waves and at
# 1,024 in three; the allocator's problems x 4 at 1,024 (two waves)
SHAPES = ((6, 8, 96, 237), (6, 8, 96, 238), (6, 8, 96, 512), (6, 8, 96, 1024),
          (1, 8, 96, 256), (33, 4, 24, 256), (64, 4, 24, 256), (2048, 4, 24, 256),
          (64, 4, 24, 480), (64, 4, 24, 512), (64, 4, 24, 1024), (67, 4, 24, 1024),
          (24, 8, 96, 1024))


def build(src_dir: str, tag: str):
    """(ctypes entry, ptxas lines of the global-body instances)."""
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    out = os.path.join(OUT, f"libsa_sweep_{tag}.so")
    cmd = [_build._nvcc(), *_build._COMMON, *_build.SOURCES["sa_sweep"], "-o", out,
           os.path.join(src_dir, "sa_sweep.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src_dir}:\n{res.stderr[-4000:]}")
    lines, keep = [], False
    for ln in res.stderr.splitlines():
        if "Compiling entry function" in ln:
            keep = "sa_sweep_global_kernel" in ln or "sa_sweep_split_kernel" in ln
            if keep:
                lines.append(re.sub(r".*'(_Z\w+)'.*", r"\1", ln))
        elif keep and ("registers" in ln or "spill" in ln):
            lines.append(ln.strip())
    fn = ctypes.CDLL(out).sa_sweep_many_global_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="a checkout (git archive) of an earlier commit")
    ap.add_argument("--variant", action="append", default=[],
                    help="a directory with a sa_sweep.cu and its anneal_step.cuh")
    args = ap.parse_args()
    dirs = [os.path.join(d, "src", "repro_torch", "csrc") for d in args.parent] + args.variant
    if not dirs:
        ap.error("give --parent or --variant")
    import torch

    from repro_torch.core import ising
    from repro_torch.kernels import sa_sweep as sa

    if not torch.cuda.is_available():
        print("torch_k1_global_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    this, this_ptxas = build(os.path.join(ROOT, "src", "repro_torch", "csrc"), "this")
    print(json.dumps({"ptxas": {"this": this_ptxas}}))
    variants = {}
    for i, d in enumerate(dirs):
        variants[d] = build(d, f"v{i}")
        print(json.dumps({"ptxas": {d: variants[d][1]}}))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def launch(fn, h, B, x0, u, temps):
        P, C, S, n = u.shape
        x = torch.empty((P, C, n), device=dev)
        e = torch.empty((P, C), device=dev)
        theta = torch.empty_like(u)
        err = fn(h.data_ptr(), B.data_ptr(), x0.data_ptr(), u.data_ptr(), temps.data_ptr(),
                 theta.data_ptr(), x.data_ptr(), e.data_ptr(), P, C, S, n,
                 int(sa.direct_acceptance(P, C)), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return x, e

    def forms(split):
        """This tree's global body with its form pinned (1 split, 0 a warp a chain)."""
        def run(h, B, x0, u, temps):
            return sa.sa_sweep_many_global(h, B, x0, u, temps, split=bool(split))
        return run

    def timed(fn, args, reps=5):
        run = (lambda: launch(fn, *args)) if isinstance(fn, ctypes._CFuncPtr) else (
            lambda: fn(*args))
        run()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for P, C, S, n in SHAPES:
        h = torch.randn((P, n), generator=g, device=dev)
        B = torch.triu(torch.randn((P, n, n), generator=g, device=dev), 1)
        B = (B + B.transpose(1, 2)).contiguous()
        x0 = (2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, n), generator=g, device=dev)
        temps = ising._temperature_schedule(h, B, S).float().contiguous()
        args_ = (h, B, x0, u, temps)
        one = (h, B, x0, u[:, :, :1].contiguous(), temps[:, :1].contiguous())
        xt, et = launch(this, *args_)
        shape = {"P": P, "C": C, "S": S, "n": n,
                 "warps_a_chain": sa.global_warps(P * C, n, sms)}
        if sa.shared_body(n, C):
            # this tree's two bodies on the same inputs
            xs, es = sa.sa_sweep_many(*args_)
            order = [timed(sa.sa_sweep_many, args_), timed(this, args_), timed(this, args_),
                     timed(sa.sa_sweep_many, args_)]
            print(json.dumps({"bodies": "shared vs global", **shape,
                              "identical": bool(torch.equal(xs, xt) and torch.equal(es, et)),
                              "shared_device_ms": [order[0], order[3]],
                              "global_device_ms": [order[1], order[2]]}), flush=True)
            continue
        # this tree's two forms against each other
        split, warp = forms(1), forms(0)
        xs, es = split(*args_)
        xw, ew = warp(*args_)
        order = [timed(warp, args_), timed(split, args_), timed(split, args_),
                 timed(warp, args_)]
        print(json.dumps({"forms": "split vs a warp a chain", **shape,
                          "identical": bool(torch.equal(xs, xw) and torch.equal(es, ew)
                                            and torch.equal(xs, xt) and torch.equal(es, et)),
                          "split_device_ms": [order[1], order[2]],
                          "warp_device_ms": [order[0], order[3]]}), flush=True)
        for d, (fn, _) in variants.items():
            xv, ev = launch(fn, *args_)
            torch.cuda.synchronize()
            order = [timed(fn, args_), timed(this, args_), timed(this, args_), timed(fn, args_)]
            t1 = {"variant": timed(fn, one), "this": timed(this, one)}
            print(json.dumps({
                "variant": d, **shape,
                "identical": bool(torch.equal(xv, xt) and torch.equal(ev, et)),
                "variant_device_ms": [order[0], order[3]],
                "this_device_ms": [order[1], order[2]],
                "one_sweep_device_ms": t1,
                "per_sweep_ms": {"variant": (statistics.mean([order[0], order[3]]) - t1["variant"])
                                 / (S - 1),
                                 "this": (statistics.mean(order[1:3]) - t1["this"]) / (S - 1)},
                "this_ns_per_step": 1e6 * statistics.mean(order[1:3]) / (S * n)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
