#!/usr/bin/env python3
"""Where the K3/K4 decode kernel's time goes, on one GPU.

    python3 tools/torch_decode_variants.py

Builds ``src/repro_torch/csrc/bitlinear_decode.cu`` once per variant under
``build/decode_variants/`` (one ``nvcc`` each, all started together), each
variant a set of ``-D`` switches that ``csrc/bitlinear_decode.cuh`` defines,
and times the decode launch (bf16 x and C, bitplane, T = 4) on
``chip_smoke.py``'s decode shapes: qwen3-32b's head, gate, down (tile
32 x 128, K = 4) and wk (the BBO tile 8 x 128, K = 3), and
granite-moe-1b-a400m's three expert stacks (32 experts, 4 rows each):

  * ``as_built``: no switch, at the rule's cluster size S
    (``bitlinear.decode_cluster_size``), and at every S of 1, 2, 4, 8, 16
    up to n_r (above 8 a non-portable cluster);
  * ``copies_only``: the producer's copies alone, each stage released
    unread (``BITLINEAR_DECODE_VARIANT=1``; y is 0, not checked);
  * ``body_only``: the consumers' work on the ring's first stages, no later
    copies (``=2``; y is wrong, not checked);
  * ``z_only`` and ``zc_only``: the body without z @ C, or without z (``=3``,
    ``=4``; not checked);
  * other block shapes: stages of at most 12 or 48 KiB (as built 24 KiB),
    three stages in the ring (as built two), a register budget for two or
    four resident blocks per SM (as built three at T <= 4).

Each checked variant is held against the plain version within 2e-2 of
max|y|.  Times are device times (CUDA events, median of 20, the L2 cache
overwritten before each launch and the card kept busy while the host
enqueues it, so no host time is counted); ``host_ms`` is the as-built
launch through ``bitlinear.bitlinear`` timed as ``chip_smoke.py`` times it
(no busy wait: a host slower than the L2 flush shows up in it).  GB/s is
each call's bytes (M, C, x and y, each once) over its device time, beside
the card's 3,350.  Prints the card, each variant's registers and spills of
``bitlinear_decode_kernel`` (-Xptxas -v), then one JSON line per tensor.
Needs one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "decode_variants")
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_GB_PER_S = 3350.0
T = 4
# name -> (E, d_in, d_out, tn, K)
SHAPES = {"qwen_head": (1, 5120, 151936, 32, 4), "qwen_gate": (1, 5120, 25600, 32, 4),
          "qwen_down": (1, 25600, 5120, 32, 4), "qwen_wk": (1, 5120, 1024, 8, 3),
          "granite_gate": (32, 1024, 512, 32, 4), "granite_up": (32, 1024, 512, 32, 4),
          "granite_down": (32, 512, 1024, 32, 4)}
TD = 128
CLUSTERS = (1, 2, 4, 8, 16)
SPIN_CYCLES = 200_000      # ~0.1 ms: longer than the host takes to enqueue a launch


def variants() -> dict:
    """name -> (-D flags, output checked)."""
    return {"as_built": ([], True),
            "copies_only": (["-DBITLINEAR_DECODE_VARIANT=1"], False),
            "body_only": (["-DBITLINEAR_DECODE_VARIANT=2"], False),
            "z_only": (["-DBITLINEAR_DECODE_VARIANT=3"], False),
            "zc_only": (["-DBITLINEAR_DECODE_VARIANT=4"], False),
            "stage12k": (["-DBITLINEAR_DECODE_STAGE_BYTES=12288"], True),
            "stage48k": (["-DBITLINEAR_DECODE_STAGE_BYTES=49152"], True),
            "stages3": (["-DBITLINEAR_DECODE_STAGES=3"], True),
            "min_blocks2": (["-DBITLINEAR_DECODE_MIN_BLOCKS=2"], True),
            "min_blocks4": (["-DBITLINEAR_DECODE_MIN_BLOCKS=4"], True)}


# the instance the timed calls run: bf16 x and C, 4-row groups, 4 columns
# per lane, bitplane (mangled template arguments)
MAIN_INSTANCE = "13__nv_bfloat16S1_Li4ELi4ELb1E"


def ptxas(log: str) -> dict:
    """Most registers and the spilled bytes over bitlinear_decode_kernel's
    instances, and the registers and spills of MAIN_INSTANCE."""
    regs, spills, cur, main = 0, 0, None, {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = ln if "bitlinear_decode_kernel" in ln else None
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
    """Compile every variant in parallel; (name -> entry point, name -> ptxas)."""
    from repro_torch.kernels import _build

    procs = {}
    for name, (flags, _) in named.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        cmd = _build.command("bitlinear_decode", os.path.join(d, "libdecode.so"), flags)
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    fns, regs = {}, {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err[-4000:]}")
        regs[name] = ptxas(out + err)
        fn = ctypes.CDLL(os.path.join(OUT, name, "libdecode.so")).bitlinear_decode
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_decode_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import quantized
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    named = variants()
    fns, regs = build(named)
    print(json.dumps({"ptxas_bitlinear_decode_kernel": regs}), flush=True)
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
    sms = bl.device_sms(dev)
    for tensor, (E, d_in, d_out, tn, K) in SHAPES.items():
        n_r, n_c = d_in // tn, d_out // TD
        mp = torch.randint(0, 256, (E, n_r, n_c, tn, 1), generator=g, device=dev,
                           dtype=torch.uint8)
        C = (torch.randn(E, n_r, n_c, K, TD, generator=g, device=dev) * 0.2).bfloat16()
        x = torch.randn(E, T, d_in, generator=g, device=dev).bfloat16()
        y = torch.empty(E, T, d_out, dtype=torch.bfloat16, device=dev)
        want = ref.bitlinear_grouped_ref(x, mp, C, "bitplane")
        nbytes = mp.numel() + C.numel() * 2 + x.numel() * 2 + y.numel() * 2
        rule = bl.decode_cluster_size(E * n_c, n_r, sms)
        dense = quantized.decompress({"m_packed": mp, "C": C}, torch.bfloat16)
        row = {"tensor": tensor, "E": E, "T": T, "shape": [n_r, n_c, tn, K, TD], "bytes": nbytes,
               "rule_S": rule, "blocks": E * n_c * rule,
               "library_ms": timed(lambda: torch.bmm(x, dense), True)}
        del dense
        if E == 1:
            xs, mps, Cs = x[0], mp[0], C[0]
            row["host_ms"] = timed(lambda: bl.bitlinear(xs, mps, Cs, mode="decode",
                                                        math="bitplane"), False)
        else:
            row["host_ms"] = timed(lambda: bl.bitlinear_grouped(x, mp, C, mode="decode",
                                                                math="bitplane"), False)

        def launch(fn, S, math=1):
            err = fn(x.data_ptr(), mp.data_ptr(), C.data_ptr(), y.data_ptr(), E, T, n_r, n_c, tn,
                     1, K, TD, 1, 1, math, S, budget, stream)
            if err:
                raise RuntimeError(f"{tensor} S={S}: launch returned {err}")

        def held(name, S, math="bitplane"):
            launch(fns[name], S, int(math == "bitplane"))
            torch.cuda.synchronize()
            plain = want if math == "bitplane" else ref.bitlinear_grouped_ref(x, mp, C, math)
            diff = float((y.float() - plain.float()).abs().max())
            if diff > 2e-2 * float(plain.float().abs().max()):
                raise RuntimeError(f"variant {name} S={S} {math} on {tensor}: |y - plain| "
                                   f"{diff:.3g}")

        ms = {}
        for name, fn in fns.items():
            if named[name][1]:
                held(name, rule)
            ms[name] = timed(lambda fn=fn: launch(fn, rule), True)
        held("as_built", rule, "unpack")
        ms["as_built_unpack"] = timed(lambda: launch(fns["as_built"], rule, 0), True)
        by_s = {}
        for S in (s for s in CLUSTERS if s <= n_r):
            held("as_built", S)
            by_s[S] = timed(lambda S=S: launch(fns["as_built"], S), True)
        row.update({"ms": ms, "ms_by_S": by_s,
                    "GBps": {k: nbytes / v / 1e6 for k, v in ms.items()},
                    "GBps_by_S": {S: nbytes / v / 1e6 for S, v in by_s.items()},
                    "GBps_card": HBM_GB_PER_S})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
