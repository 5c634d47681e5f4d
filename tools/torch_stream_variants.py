#!/usr/bin/env python3
"""Where the K3 stream kernel's time goes, on one GPU.

    python3 tools/torch_stream_variants.py

Builds ``src/repro_torch/csrc/bitlinear_stream.cu`` once per variant under
``build/stream_variants/`` (one ``nvcc`` each, all started together), each
variant a set of ``-D`` switches that ``csrc/bitlinear_stream.cuh`` defines,
and times the stream launch (bf16 x and C, bitplane, T = 4) at r_chunk 1,
2, 4 and 8 on ``chip_smoke.py``'s shapes: qwen3-32b's head, gate, down
(tile 32 x 128, K = 4) and wk (the BBO tile 8 x 128, K = 3), and
granite-moe-1b-a400m's attn/wq (32 x 128, K = 4):

  * ``as_built``: no switch, at the rule's cluster size S
    (``bitlinear.stream_cluster_size``), and at every S of 1, 2, 4, 8, 16
    up to the chunks (above 8 a non-portable cluster);
  * ``copies_only``: the producer's tensor-map copies alone, each stage
    released unread (``BITLINEAR_STREAM_VARIANT=1``; y is 0, not checked);
  * ``body_only``: the consumers' work on the ring's first stages, no later
    copies (``=2``; y is wrong, not checked);
  * ``z_only`` and ``zc_only``: the body without z @ C, or without z (``=3``,
    ``=4``; not checked);
  * other block shapes: a ring of at most 4 or 16 stages (as built 8), a
    ring of up to 96 KiB (as built 48 KiB), eight consumer warps, a
    register budget for two or four resident blocks per SM (as built three
    at T <= 4).

Each checked variant is held against the plain version within 2e-2 of
max|y|.  Times are device times (CUDA events, median of 20, the L2 cache
overwritten before each launch and the card kept busy while the host
enqueues it); ``host_ms`` is the as-built launch through
``bitlinear.bitlinear`` timed as ``chip_smoke.py`` times it (no busy wait);
``enqueue_us`` is the host's time per launch of the as-built C entry point
alone (which encodes x's tensor map per call), over 200 launches.  GB/s is
each call's bytes (M, C, x and y, each once) over its device time, beside
the card's 3,350.  Prints the card, each variant's registers and spills of
``bitlinear_stream_kernel`` (-Xptxas -v), then one JSON line per tensor and
r_chunk.  Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "stream_variants")
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_GB_PER_S = 3350.0
T, TD = 4, 128
# name -> (d_in, d_out, tn, K)
SHAPES = {"qwen_head": (5120, 151936, 32, 4), "qwen_gate": (5120, 25600, 32, 4),
          "qwen_down": (25600, 5120, 32, 4), "qwen_wk": (5120, 1024, 8, 3),
          "granite_wq": (1024, 1024, 32, 4)}
R_CHUNKS = (1, 2, 4, 8)
CLUSTERS = (1, 2, 4, 8, 16)
SPIN_CYCLES = 200_000      # ~0.1 ms: longer than the host takes to enqueue a launch


def variants() -> dict:
    """name -> (-D flags, output checked)."""
    return {"as_built": ([], True),
            "copies_only": (["-DBITLINEAR_STREAM_VARIANT=1"], False),
            "body_only": (["-DBITLINEAR_STREAM_VARIANT=2"], False),
            "z_only": (["-DBITLINEAR_STREAM_VARIANT=3"], False),
            "zc_only": (["-DBITLINEAR_STREAM_VARIANT=4"], False),
            "stages4": (["-DBITLINEAR_STREAM_STAGES=4"], True),
            "ring96k": (["-DBITLINEAR_STREAM_RING_BYTES=98304"], True),
            "stages16": (["-DBITLINEAR_STREAM_STAGES=16", "-DBITLINEAR_STREAM_RING_BYTES=196608"],
                         True),
            "warps8": (["-DBITLINEAR_STREAM_WARPS=8", "-DBITLINEAR_STREAM_STAGES=16",
                        "-DBITLINEAR_STREAM_MIN_BLOCKS=2"], True),
            "min_blocks2": (["-DBITLINEAR_STREAM_MIN_BLOCKS=2"], True),
            "min_blocks4": (["-DBITLINEAR_STREAM_MIN_BLOCKS=4"], True)}


# the instance the timed calls run: bf16 x and C, 4-row groups, 4 columns
# per lane, bitplane (mangled template arguments)
MAIN_INSTANCE = "13__nv_bfloat16S1_Li4ELi4ELb1E"


def ptxas(log: str) -> dict:
    """Most registers and the spilled bytes over bitlinear_stream_kernel's
    instances, and the registers and spills of MAIN_INSTANCE."""
    regs, spills, cur, main = 0, 0, None, {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln if "bitlinear_stream_kernel" in ln else None
        elif cur:
            m = re.search(r"(\d+) bytes spill stores", ln)
            spills += int(m.group(1)) if m else 0
            if m and MAIN_INSTANCE in cur:
                main["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", ln)
            regs = max(regs, int(m.group(1))) if m else regs
            if m and MAIN_INSTANCE in cur:
                main["registers"] = int(m.group(1))
    return {"registers": regs, "spill_store_bytes": spills, "main_instance": main}


def build(named: dict) -> tuple[dict, dict]:
    """Compile every variant in parallel; (name -> (entry point, smem
    query), name -> ptxas)."""
    from repro_torch.kernels import _build

    procs = {}
    for name, (flags, _) in named.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        cmd = _build.command("bitlinear_stream", os.path.join(d, "libstream.so"), flags)
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs, regs = {}, {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err[-4000:]}")
        regs[name] = ptxas(out + err)
        lib = ctypes.CDLL(os.path.join(OUT, name, "libstream.so"))
        fn = lib.bitlinear_stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        smem = lib.bitlinear_stream_smem_bytes
        smem.argtypes = [ctypes.c_int] * 8
        smem.restype = ctypes.c_longlong
        libs[name] = (fn, smem)
    return libs, regs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_stream_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    named = variants()
    libs, regs = build(named)
    print(json.dumps({"ptxas_bitlinear_stream_kernel": regs}), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def timed(fn, spin, reps=20):
        fn()
        times = []
        for _ in range(reps):
            flush.zero_()
            if spin:
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
    sms, sm_smem = bl.device_sms(dev), bl.device_sm_smem(dev)
    maps = ctypes.c_int(0)
    for tensor, (d_in, d_out, tn, K) in SHAPES.items():
        n_r, n_c = d_in // tn, d_out // TD
        mp = torch.randint(0, 256, (n_r, n_c, tn, 1), generator=g, device=dev,
                           dtype=torch.uint8)
        C = (torch.randn(n_r, n_c, K, TD, generator=g, device=dev) * 0.2).bfloat16()
        x = torch.randn(T, d_in, generator=g, device=dev).bfloat16()
        y = torch.empty(T, d_out, dtype=torch.bfloat16, device=dev)
        want = ref.bitlinear_ref(x, mp, C, "bitplane").float()
        scale = float(want.abs().max())
        nbytes = mp.numel() + C.numel() * 2 + x.numel() * 2 + y.numel() * 2
        for rc in R_CHUNKS:
            rc = bl.resolve_r_chunk(n_r, rc)
            geo = bl.stream_geometry(T=T, tn=tn, K=K, td=TD, x_itemsize=2, c_itemsize=2,
                                     r_chunk=rc)
            blocks = n_c * geo["col_chunks"] * geo["row_blocks"]

            def rule_s(name):
                smem = libs[name][1](T, tn, 1, K, TD, 1, 1, rc)
                return bl.stream_cluster_size(blocks, n_r, rc, sms,
                                              bl.stream_blocks_per_sm(geo["bt"], smem, sm_smem))

            def launch(name, S):
                err = libs[name][0](x.data_ptr(), mp.data_ptr(), C.data_ptr(), y.data_ptr(), T,
                                    n_r, n_c, tn, 1, K, TD, 1, 1, 1, rc, S, budget, stream,
                                    ctypes.byref(maps))
                if err:
                    raise RuntimeError(f"{tensor} {name} r_chunk {rc} S={S}: launch returned "
                                       f"{err}")

            def held(name, S):
                y.zero_()
                launch(name, S)
                torch.cuda.synchronize()
                diff = float((y.float() - want).abs().max())
                if diff > 2e-2 * scale:
                    raise RuntimeError(f"{tensor} {name} r_chunk {rc} S={S}: off by {diff:.3g}"
                                       f" (max|y| {scale:.3g})")

            S0 = rule_s("as_built")
            row = {"tensor": tensor, "T": T, "r_chunk": rc, "shape": [n_r, n_c, tn, K, TD],
                   "bytes": nbytes, "rule_S": S0, "blocks": blocks * S0,
                   "stages": geo["stages"], "maps": geo["maps"],
                   "host_ms": timed(lambda: bl.bitlinear(x, mp, C, mode="stream",
                                                         math="bitplane", r_chunk=rc), False)}
            held("as_built", S0)
            row["as_built"] = timed(lambda: launch("as_built", S0), True)
            row["by_S"] = {}
            for S in CLUSTERS:
                if S <= -(-n_r // rc):
                    held("as_built", S)
                    row["by_S"][S] = timed(lambda: launch("as_built", S), True)
            for name, (_, checked) in named.items():
                if name == "as_built":
                    continue
                S = rule_s(name)
                if libs[name][1](T, tn, 1, K, TD, 1, 1, rc) > budget:
                    row[name] = None
                    continue
                if checked:
                    held(name, S)
                row[name] = timed(lambda: launch(name, S), True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                launch("as_built", S0)
            row["enqueue_us"] = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            row["GBps"] = {k: nbytes / v / 1e6 for k, v in row.items()
                           if k in named and v is not None}
            row["GBps_card"] = HBM_GB_PER_S
            print(json.dumps(row), flush=True)
        del mp, C, x, y
    return 0


if __name__ == "__main__":
    sys.exit(main())
