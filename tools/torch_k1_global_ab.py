#!/usr/bin/env python3
"""K1's global-memory body as another source builds it, against this tree's.

    python3 tools/torch_k1_global_ab.py --variant DIR [--variant DIR2 ...]

DIR holds a ``sa_sweep.cu`` and its ``anneal_step.cuh`` (e.g. ``src/
repro_torch/csrc`` of an earlier commit unpacked by ``git archive`` into a
gitignored directory such as ``build/``) whose C interface has
``sa_sweep_many_global_f32`` (h, B, x0, u, temps, theta, x, e, P, C, S, n,
direct, stream).  Each variant is built with this tree's flags into
``build/k1_global_ab/``.  At the budget allocator's QUBO shape (6 problems x
8 reads x 96 sweeps, ising's annealing schedule) on normal h and B, whose
sums round, at n = 238, 512 and 1,024, every variant must give this tree's
spins and energies bit for bit, and each is timed as device time (CUDA
events, median of 5, the L2 overwritten before each launch, the card kept
busy while the host enqueues it) in the order variant, this, this, variant.
Prints the card, the ptxas registers and spills of every global-body
instance, and one JSON line per (variant, n), with each side's time at one
sweep beside (the initial fields and the final energy are most of it) and
the per-sweep time it leaves; and at n = 237, this tree's shared-memory
body against its global-memory body on the same inputs.  Needs one CUDA
card and nvcc; imports nothing of JAX.
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
SHAPE = (6, 8, 96)
NS = (237, 238, 512, 1024)


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
            keep = "sa_sweep_global_kernel" in ln
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
    ap.add_argument("--variant", action="append", required=True)
    args = ap.parse_args()
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
    for i, d in enumerate(args.variant):
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

    P, C, S = SHAPE
    for n in NS:
        h = torch.randn((P, n), generator=g, device=dev)
        B = torch.triu(torch.randn((P, n, n), generator=g, device=dev), 1)
        B = (B + B.transpose(1, 2)).contiguous()
        x0 = (2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, n), generator=g, device=dev)
        temps = ising._temperature_schedule(h, B, S).float().contiguous()
        args_ = (h, B, x0, u, temps)
        one = (h, B, x0, u[:, :, :1].contiguous(), temps[:, :1].contiguous())
        xt, et = launch(this, *args_)
        if sa.shared_body(n, C):
            # this tree's two bodies on the same inputs
            xs, es = sa.sa_sweep_many(*args_)
            order = [timed(sa.sa_sweep_many, args_), timed(this, args_), timed(this, args_),
                     timed(sa.sa_sweep_many, args_)]
            print(json.dumps({"bodies": "shared vs global", "P": P, "C": C, "S": S, "n": n,
                              "identical": bool(torch.equal(xs, xt) and torch.equal(es, et)),
                              "shared_device_ms": [order[0], order[3]],
                              "global_device_ms": [order[1], order[2]]}), flush=True)
            continue
        for d, (fn, _) in variants.items():
            xv, ev = launch(fn, *args_)
            torch.cuda.synchronize()
            order = [timed(fn, args_), timed(this, args_), timed(this, args_), timed(fn, args_)]
            t1 = {"variant": timed(fn, one), "this": timed(this, one)}
            print(json.dumps({
                "variant": d, "P": P, "C": C, "S": S, "n": n,
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
