#!/usr/bin/env python3
"""The K3 stream kernel of an earlier commit against this tree's, on one GPU.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/torch_stream_ab.py --parent build/parent

Builds the earlier checkout's ``src/repro_torch/csrc/bitlinear_stream.cu``
(the stream body of ``bitlinear_kernel``, before it became a kernel of its
own: its C entry point takes the grid's arguments, ``block_t``,
``r_chunk``, ``smem_budget``, ``small_t`` and an ``int*``) into
``build/stream_ab/``; this tree's stream runs through
``repro_torch.kernels.bitlinear.bitlinear(mode="stream")``.  Both run on
``chip_smoke.py``'s T = 4 calls (bf16 x and C): qwen3-32b's eight
compressed tensors (tile 32 x 128, K = 4; the BBO attn/w[kv] at 8 x 128,
K = 3) and granite-moe-1b-a400m's four K3 tensors (attn/wq, wk, wv, wo;
tile 32 x 128, K = 4), at r_chunk 1, 2, 4 and 8, in both bit algebras.
Each pair is timed in the order earlier, this, this, earlier, as device
time (CUDA events, median of 20, the L2 overwritten before each launch and
the card kept busy while the host enqueues it, so neither side's host time
counts).  Each output is held against the plain version within 2e-2 of
max|y|; a side whose block needs more shared memory than the card has (the
earlier kernel's two slots per warp at r_chunk 8) is reported with the
bytes it asked for and not timed.  Prints the card, one JSON line per call
(with GB/s: M, C, x and y each once over the device time, beside the
card's 3,350) and the sums per model, r_chunk and bit algebra.  Needs one CUDA card and nvcc;
imports nothing of JAX.
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
OUT = os.path.join(ROOT, "build", "stream_ab")
sys.path.insert(0, os.path.join(ROOT, "src"))

T, TD = 4, 128
HBM_GB_PER_S = 3350.0
R_CHUNKS = (1, 2, 4, 8)
MATHS = ("unpack", "bitplane")
# name -> (d_in, d_out, tn, K)
SHAPES = {"qwen/head": (5120, 151936, 32, 4), "qwen/wq": (5120, 8192, 32, 4),
          "qwen/wk": (5120, 1024, 8, 3), "qwen/wv": (5120, 1024, 8, 3),
          "qwen/wo": (8192, 5120, 32, 4), "qwen/gate": (5120, 25600, 32, 4),
          "qwen/up": (5120, 25600, 32, 4), "qwen/down": (25600, 5120, 32, 4),
          "granite/wq": (1024, 1024, 32, 4), "granite/wk": (1024, 512, 32, 4),
          "granite/wv": (1024, 512, 32, 4), "granite/wo": (1024, 1024, 32, 4)}
SPIN_CYCLES = 200_000      # ~0.1 ms: longer than the host takes to enqueue a launch
SMALL_T = 4                # the earlier entry point's small_t argument


def earlier_entry(parent: str):
    """The earlier checkout's stream entry point, built from its sources."""
    from repro_torch.kernels import _build

    src = os.path.join(parent, "src", "repro_torch", "csrc", "bitlinear_stream.cu")
    os.makedirs(OUT, exist_ok=True)
    lib = os.path.join(OUT, "libstream_earlier.so")
    cmd = [_build._nvcc(), *_build._COMMON, *_build.SOURCES["bitlinear_stream"], "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    fn = ctypes.CDLL(lib).bitlinear_stream
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="a checkout (git archive) of the earlier commit")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_stream_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    earlier = earlier_entry(os.path.abspath(args.parent))
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
    sums = {}
    for name, (d_in, d_out, tn, K) in SHAPES.items():
        n_r, n_c = d_in // tn, d_out // TD
        mp = torch.randint(0, 256, (n_r, n_c, tn, 1), generator=g, device=dev,
                           dtype=torch.uint8)
        C = (torch.randn(n_r, n_c, K, TD, generator=g, device=dev) * 0.2).bfloat16()
        x = torch.randn(T, d_in, generator=g, device=dev).bfloat16()
        y = torch.empty(T, d_out, dtype=torch.bfloat16, device=dev)
        nbytes = mp.numel() + C.numel() * 2 + x.numel() * 2 + y.numel() * 2
        ran = ctypes.c_int(0)
        for math in MATHS:
            want = ref.bitlinear_ref(x, mp, C, math).float()
            scale = float(want.abs().max())
            for rc in R_CHUNKS:
                rc = bl.resolve_r_chunk(n_r, rc)
                head = (x.data_ptr(), mp.data_ptr(), C.data_ptr(), y.data_ptr(), 1, T, n_r, n_c,
                        tn, 1, K, TD, 1, 1, int(math == "bitplane"), 128, rc, budget, SMALL_T)

                def run_earlier():
                    err = earlier(*head, stream, ctypes.byref(ran))
                    if err:
                        raise RuntimeError(f"{name}: earlier launch returned {err}")
                    return y

                def run_this():
                    return bl.bitlinear(x, mp, C, mode="stream", math=math, r_chunk=rc)

                # minus the bytes a block over the budget asks for (nothing launched)
                need = {"earlier": earlier(*head, stream, ctypes.byref(ran)),
                        "this": -bl.smem_bytes("stream", T=T, n_r=n_r, tn=tn, K=K, td=TD,
                                               x_itemsize=2, c_itemsize=2, r_chunk=rc)}
                if -need["this"] <= budget:
                    need["this"] = 0
                run = {side: fn for side, fn in (("earlier", run_earlier), ("this", run_this))
                       if need[side] >= 0}
                errs = {}
                for side, fn in run.items():
                    y.zero_()
                    out = fn()
                    torch.cuda.synchronize()
                    errs[side] = float((out.float() - want).abs().max()) / scale
                    if errs[side] > 2e-2:
                        raise RuntimeError(f"{name} {math} r_chunk {rc}: {side} kernel off by "
                                           f"{errs[side]:.3g} of max|y|")
                # earlier, this, this, earlier (a refused side not timed)
                order = [s for s in ("earlier", "this", "this", "earlier") if s in run]
                times = {}
                for side in order:
                    times.setdefault(side, []).append(timed(run[side]))
                row = {"call": name, "math": math, "r_chunk": rc}
                key = f"{name.split('/')[0]}/{math}/r_chunk={rc}"
                tot = sums.setdefault(key, {"calls": 0, "earlier_ms": 0.0, "this_ms": 0.0,
                                            "earlier_refused": 0, "this_refused": 0})
                tot["calls"] += 1
                for side in ("earlier", "this"):
                    if side in times:
                        ms = sum(times[side]) / 2
                        row[f"{side}_ms"] = times[side]
                        row[f"{side}_GBps"] = nbytes / ms / 1e6
                        tot[f"{side}_ms"] += ms
                    else:
                        row[f"{side}_smem_needed"] = -need[side]
                        tot[f"{side}_refused"] += 1
                print(json.dumps({**row, "GBps_card": HBM_GB_PER_S, "rel_err": errs}), flush=True)
        del mp, C, x, y
    print(json.dumps({"sums": sums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
