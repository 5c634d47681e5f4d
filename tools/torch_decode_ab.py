#!/usr/bin/env python3
"""The K3/K4 decode kernel of an earlier commit against this tree's, on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/torch_decode_ab.py --parent build/parent

Builds the earlier checkout's ``src/repro_torch/csrc/bitlinear_decode.cu``
into ``build/decode_ab/``, and this tree's through
``repro_torch.kernels._build``.  Both run the decode schedule on
``chip_smoke.py``'s T = 4 decode calls (bf16 x and C, bitplane): qwen3-32b's
eight compressed tensors (K3; tile 32 x 128, K = 4, the BBO attn/w[kv] at
8 x 128, K = 3), granite-moe-1b-a400m's three expert stacks (K4, 32
experts), zamba2-1.2b's in_proj (64 x 64 tiles of 32 x 131) and out_proj
(128 x 16 of 32 x 128), mamba2-130m's in_proj (24 x 8 of 32 x 419), and a
K4 call at td 131 (4 experts of 32 x 8 tiles).  Both are called through
their C entry points (the decode kernel's own, ``clusters``,
``smem_budget``, ``stream``) at the rule's cluster size
(``bitlinear.decode_cluster_size``), and timed in the order earlier, this,
this, earlier, as device time (CUDA events, median of 20, the L2
overwritten before each launch and the card kept busy while the host
enqueues it, so neither side's host time counts).
Each output is held against the plain version within 2e-2 of max|y|, and
``identical`` says whether the two sides gave the same bits.  Prints the
card, one JSON line per call and the sums per kernel.  Needs one CUDA card
and nvcc; imports nothing of JAX.
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
OUT = os.path.join(ROOT, "build", "decode_ab")
sys.path.insert(0, os.path.join(ROOT, "src"))

T = 4
# name -> (E, d_in, d_out, tn, K, td); the sums group the calls by the
# name's prefix
SHAPES = {"k3/head": (1, 5120, 151936, 32, 4, 128), "k3/wq": (1, 5120, 8192, 32, 4, 128),
          "k3/wk": (1, 5120, 1024, 8, 3, 128), "k3/wv": (1, 5120, 1024, 8, 3, 128),
          "k3/wo": (1, 8192, 5120, 32, 4, 128), "k3/gate": (1, 5120, 25600, 32, 4, 128),
          "k3/up": (1, 5120, 25600, 32, 4, 128), "k3/down": (1, 25600, 5120, 32, 4, 128),
          "k4/gate": (32, 1024, 512, 32, 4, 128), "k4/up": (32, 1024, 512, 32, 4, 128),
          "k4/down": (32, 512, 1024, 32, 4, 128),
          "zamba2/in_proj": (1, 2048, 8384, 32, 4, 131),
          "zamba2/out_proj": (1, 4096, 2048, 32, 4, 128),
          "mamba2/in_proj": (1, 768, 3352, 32, 4, 419),
          "k4_odd/td131": (4, 1024, 1048, 32, 4, 131)}
SPIN_CYCLES = 200_000      # ~0.1 ms: longer than the host takes to enqueue a launch


def earlier_entry(parent: str):
    """The earlier checkout's decode entry point, built from its sources."""
    from repro_torch.kernels import _build

    src = os.path.join(parent, "src", "repro_torch", "csrc", "bitlinear_decode.cu")
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libdecode_earlier.so")
    cmd = [_build._nvcc(), *_build._COMMON, *_build.SOURCES["bitlinear_decode"], "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    fn = ctypes.CDLL(lib).bitlinear_decode
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout (git archive) of the earlier commit")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    earlier = earlier_entry(os.path.abspath(args.parent))
    this = bl._lib("decode")
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def timed(fn, reps=20):
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

    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    budget = bl.device_smem_budget(dev)
    sms = bl.device_sms(dev)
    sums = {}
    for name, (E, d_in, d_out, tn, K, td) in SHAPES.items():
        n_r, n_c = d_in // tn, d_out // td
        mp = torch.randint(0, 256, (E, n_r, n_c, tn, 1), generator=g, device=dev,
                           dtype=torch.uint8)
        C = (torch.randn(E, n_r, n_c, K, td, generator=g, device=dev) * 0.2).bfloat16()
        x = torch.randn(E, T, d_in, generator=g, device=dev).bfloat16()
        y = torch.empty(E, T, d_out, dtype=torch.bfloat16, device=dev)
        S = bl.decode_cluster_size(E * n_c, n_r, sms)
        head = (x.data_ptr(), mp.data_ptr(), C.data_ptr(), y.data_ptr(), E, T, n_r, n_c, tn, 1, K,
                td, 1, 1, 1)

        def run_earlier():
            err = earlier(*head, S, budget, stream)
            if err:
                raise RuntimeError(f"{name}: earlier launch returned {err}")

        def run_this():
            err = this(*head, S, budget, stream)
            if err:
                raise RuntimeError(f"{name}: launch returned {err}")

        want = ref.bitlinear_grouped_ref(x, mp, C, "bitplane").float()
        scale = float(want.abs().max())
        errs, outs = {}, {}
        for side, fn in (("earlier", run_earlier), ("this", run_this)):
            y.zero_()
            fn()
            torch.cuda.synchronize()
            outs[side] = y.clone()
            errs[side] = float((y.float() - want).abs().max()) / scale
            if errs[side] > 2e-2:
                raise RuntimeError(f"{name}: {side} kernel off by {errs[side]:.3g} of max|y|")
        e1, t1, t2, e2 = timed(run_earlier), timed(run_this), timed(run_this), timed(run_earlier)
        layout = bl.built_decode_layout(T=T, tn=tn, K=K, td=td, x_itemsize=2, c_itemsize=2)
        print(json.dumps({"call": name, "S": S, "c": layout["c"], "groups": layout["groups"],
                          "earlier_ms": [e1, e2], "this_ms": [t1, t2],
                          "rel_err": errs,
                          "identical": torch.equal(outs["earlier"], outs["this"])}), flush=True)
        tot = sums.setdefault(name.split("/")[0], {"earlier_ms": 0.0, "this_ms": 0.0})
        tot["earlier_ms"] += (e1 + e2) / 2
        tot["this_ms"] += (t1 + t2) / 2
    print(json.dumps({"sums": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
