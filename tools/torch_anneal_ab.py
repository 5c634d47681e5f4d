#!/usr/bin/env python3
"""K1 and K2 of an earlier commit against this tree's, on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/torch_anneal_ab.py --parent build/parent

Builds the earlier checkout's ``src/repro_torch/csrc/sa_sweep.cu`` and
``sqa_sweep.cu`` (K1 takes h, B, x0, u, temps, theta, x, e, P, C, S, n,
lanes, direct, stream; K2 h, B, X0, u, jperps, theta, X, E, P, C, T, S, n,
G, d, temperature, stream: theta is the acceptance thresholds' scratch,
lanes, direct, G and d this tree's rules') into ``build/anneal_ab/``; this
tree's run through ``repro_torch.kernels``.  On problems whose sums round (normal
h and B; and the Ising problems the paper's BBO loop hands its solver,
captured from ``run_bbo_batch`` on shrunk-VGG instance 0 with phase 6's
draws) at every shape ``chip_smoke.py`` times: K1 at the BBO pool's
(10,240, 4, 24, 24) and phase 6's (25 and 4, 10, 64, 24), K2 at the
paper's (25, 10, 8, 64, 24).  Both sides must give the same spins and
energies bit for bit: every field and energy is a rounded sum, so this
holds only if the new kernels keep every addition in the earlier order.
Each shape on normal problems is timed in the order earlier, this, this,
earlier, as device time (CUDA events, median of 10, the L2 overwritten
before each launch and the card kept busy while the host enqueues it).
Prints the card, one JSON line per case, the sums.  Needs one CUDA card and
nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "anneal_ab")
sys.path.insert(0, os.path.join(ROOT, "src"))

SPIN_CYCLES = 200_000      # ~0.1 ms: longer than the host takes to enqueue a launch
SQA_TEMPERATURE = 0.05
# label -> (P, C, S, n, temperature schedule) / (P, C, T, S, n)
K1_SHAPES = {"sq_main_shape": (10240, 4, 24, 24, "const"),
             "sa_phase6_25": (25, 10, 64, 24, "anneal"),
             "sa_phase6_4": (4, 10, 64, 24, "anneal")}
K2_SHAPES = {"paper_shape": (25, 10, 8, 64, 24)}
BBO_ITERS = 3              # BBO iterations whose solver calls are captured


def earlier_entries(parent: str):
    """The earlier checkout's K1 and K2 entry points, built from its sources."""
    from repro_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    fns = {}
    for name, argtypes in (
        ("sa_sweep", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
        ("sqa_sweep", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_void_p]),
    ):
        src = os.path.join(parent, "src", "repro_torch", "csrc", f"{name}.cu")
        lib = os.path.join(OUT, f"lib{name}_earlier.so")
        cmd = [_build._nvcc(), *_build._COMMON, *_build.SOURCES[name], "-o", lib, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
        fn = getattr(ctypes.CDLL(lib), f"{name}_many_f32")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def captured_bbo_calls(torch, dev):
    """The solver calls of the paper's BBO loop (phase 6 of chip_smoke.py):
    nBOCS (K1, 25 runs), nBOCSa (K1, 4 runs) and nBOCSqa (K2, 25 runs) on
    shrunk-VGG instance 0, BBO_ITERS iterations each; every call's inputs."""
    from repro_torch.configs.paper_vgg import CONFIG as paper
    from repro_torch.core import bbo, ising
    from repro_torch.core.decomposition import make_objective
    from repro_torch.core.instances import shrunk_vgg_instance
    from repro_torch.device import generator

    calls = []
    sa_fn, sqa_fn = ising.sa_sweep_many, ising.sqa_sweep_many

    def sa_rec(h, B, x0, rand, temps):
        calls.append(("K1", (h, B, x0, rand, temps)))
        return sa_fn(h, B, x0, rand, temps)

    def sqa_rec(h, B, X0, rand, jperps, temperature=SQA_TEMPERATURE):
        calls.append(("K2", (h, B, X0, rand, jperps, temperature)))
        return sqa_fn(h, B, X0, rand, jperps, temperature)

    W = shrunk_vgg_instance(0, N=paper.N, D=paper.D, device=dev)
    f = make_objective(W, paper.K)
    ising.sa_sweep_many, ising.sqa_sweep_many = sa_rec, sqa_rec
    try:
        for i, (label, opts, runs) in enumerate((
            ("nbocs", {"solver": "sa"}, paper.num_runs),
            ("nbocsa", {"solver": "sa", "augment": True}, 4),
            ("nbocsqa", {"solver": "qa"}, paper.num_runs),
        )):
            cfg = bbo.BBOConfig(n=paper.n, N=paper.N, K=paper.K, iters=BBO_ITERS,
                                init_points=paper.init_points, num_reads=paper.num_reads,
                                algo="nbocs", **opts)
            start = len(calls)
            bbo.run_bbo_batch(cfg, f, runs, generator(dev, 0, i))
            calls[start:] = [(k, a, label) for k, a in calls[start:]]
    finally:
        ising.sa_sweep_many, ising.sqa_sweep_many = sa_fn, sqa_fn
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout (git archive) of the earlier commit")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_anneal_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import ising
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.kernels import sqa_sweep as sqa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    earlier = earlier_entries(os.path.abspath(args.parent))
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def timed(fn, reps=10):
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def k1_pair(h, B, x0, u, temps):
        P, C, n = x0.shape
        x = torch.empty_like(x0)
        e = torch.empty((P, C), dtype=torch.float32, device=dev)

        lanes = sa.lanes_per_chain(P, C, n) if sa.shared_body(n, C) else 32
        direct = sa.direct_acceptance(P, C)
        theta = torch.empty_like(u)

        def run_earlier():
            err = earlier["sa_sweep"](h.data_ptr(), B.data_ptr(), x0.data_ptr(), u.data_ptr(),
                                      temps.data_ptr(), theta.data_ptr(), x.data_ptr(),
                                      e.data_ptr(), P, C, u.shape[2], n, lanes, int(direct),
                                      stream)
            if err:
                raise RuntimeError(f"earlier K1 launch returned {err}")
            return x, e
        return run_earlier, lambda: sa.sa_sweep_many(h, B, x0, u, temps)

    def k2_pair(h, B, X0, u, jp, temperature):
        P, C, T, n = X0.shape
        X = torch.empty_like(X0)
        E = torch.empty((P, C, T), dtype=torch.float32, device=dev)

        G, d = sqa.wavefront_schedule(T, n)
        theta = torch.empty_like(u)

        def run_earlier():
            err = earlier["sqa_sweep"](h.data_ptr(), B.data_ptr(), X0.data_ptr(), u.data_ptr(),
                                       jp.data_ptr(), theta.data_ptr(), X.data_ptr(),
                                       E.data_ptr(), P, C, T, jp.shape[0], n, G, d,
                                       temperature, stream)
            if err:
                raise RuntimeError(f"earlier K2 launch returned {err}")
            return X, E
        return run_earlier, lambda: sqa.sqa_sweep_many(h, B, X0, u, jp, temperature)

    def compare(kernel, label, problems, pair, x0):
        run_earlier, run_this = pair
        xa, ea = (t.clone() for t in run_earlier())
        xb, eb = run_this()
        torch.cuda.synchronize()
        same = torch.equal(xa, xb) and torch.equal(ea, eb)
        row = {"kernel": kernel, "shape": label, "problems": problems,
               "dims": list(x0.shape), "identical": same,
               "flipped": float((xa != x0).float().mean())}
        if not same:
            row["spins_differ"] = int((xa != xb).sum())
            row["energies_differ"] = int((ea != eb).sum())
        return row

    g = torch.Generator(device=dev).manual_seed(0)
    sums, ok = {}, True
    for kernel, shapes in (("K1", K1_SHAPES), ("K2", K2_SHAPES)):
        for label, shape in shapes.items():
            if kernel == "K1":
                P, C, S, n, schedule = shape
                h, B = ising.random_problems(g, P, n)
                x0 = 2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0
                u = torch.rand((P, C, S, n), generator=g, device=dev)
                temps = (torch.full((P, S), 0.1, device=dev) if schedule == "const"
                         else ising._temperature_schedule(h, B, S).float().contiguous())
                x0 = x0.contiguous()
                pair = k1_pair(h.contiguous(), B.contiguous(), x0, u, temps)
            else:
                P, C, T, S, n = shape
                h, B = ising.random_problems(g, P, n)
                X0 = 2.0 * torch.randint(0, 2, (P, C, T, n), generator=g, device=dev) - 1.0
                u = torch.rand((P, C, S, T, n), generator=g, device=dev)
                jp = ising.sqa_jperps(S, T, SQA_TEMPERATURE, 3.0, dev).contiguous()
                x0 = X0.contiguous()
                pair = k2_pair(h.contiguous(), B.contiguous(), x0, u, jp, SQA_TEMPERATURE)
            row = compare(kernel, label, "normal", pair, x0)
            e1, t1, t2, e2 = (timed(pair[0]), timed(pair[1]), timed(pair[1]), timed(pair[0]))
            row.update(earlier_device_ms=[e1, e2], this_device_ms=[t1, t2])
            ok &= row["identical"]
            print(json.dumps(row), flush=True)
            sums[f"{kernel}/{label}"] = {"earlier_device_ms": (e1 + e2) / 2,
                                         "this_device_ms": (t1 + t2) / 2}
    for kernel, inputs, label in captured_bbo_calls(torch, dev):
        pair = k1_pair(*inputs) if kernel == "K1" else k2_pair(*inputs)
        row = compare(kernel, label, "bbo", pair, inputs[2])
        ok &= row["identical"]
        print(json.dumps(row), flush=True)
    print(json.dumps({"sums": sums, "all_identical": bool(ok)}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
