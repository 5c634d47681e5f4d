#!/usr/bin/env python3
"""What holds back the K3/K4 grid's tensor-core body, on one GPU.

    python3 tools/torch_grid_variants.py [--parent DIR]

Builds ``src/repro_torch/csrc/bitlinear.cu`` once per variant under
``build/grid_variants/`` (one ``nvcc`` each, all started together), each
variant a set of ``-D`` switches that ``csrc/bitlinear.cuh`` defines, and
times each variant's grid launch (bf16 x and C, unpack, block_t 64,
r_chunk 1) at T = 4096 on qwen3-32b's prefill tensors (tile 32 x 128,
K = 4: wq, gate and down), zamba2-1.2b's in_proj (2048 -> 8,384, tile
32 x 131) and mamba2-130m's in_proj (768 -> 3,352, tile 32 x 419) beside a
dense bf16 ``torch.matmul``:

  * ``as_built``: no switch; also at r_chunk 2, 4 and 8
    (``as_built_rc{n}``, the launch's own argument);
  * ``staging_only``: the same copies into shared memory, no mma
    (``BITLINEAR_MMA_VARIANT=1``; its output is not checked);
  * ``mma_only``: the mma work on the first stages' data, no further
    copies (``=2``; not checked);
  * ``no_repack``, ``no_store``: no pass shifting raw C into place (``=4``;
    not checked), no store of y (``=5``; not checked);
  * ``c_span``, ``c_rows``: C at td % 8 != 0 staged raw as each r tile's
    span of the block's column tiles, or as each row's chunk, always
    (``BITLINEAR_MMA_C_STAGING=1``, ``=2``; as built, 0: spans where one
    chunk covers td, else rows); the same kernel as ``as_built`` at td 128;
  * ``chunk{n}``: column chunks of at most 16 n columns
    (``BITLINEAR_MMA_MAX_NTP``; as built 9: 144);
  * ``rows{R}_cols{C}_stages{S}_blocks{B}``: other block shapes, R row
    tiles x C column tiles of warps, S shared-memory stages and B resident
    blocks per SM for the register budget (a shape whose stages do not fit
    the card's shared memory is reported as refused, with the bytes it
    needs).

With ``--parent DIR`` (a ``git archive`` of an earlier commit, e.g. under
the gitignored ``build/parent``) that commit's ``bitlinear.cu`` is built
too, as the variant ``parent``, and timed beside this tree's on the same
calls (a tensor its grid does not put on the tensor cores is timed all the
same, on whatever body it runs).

Each checked variant is held against the plain version within 2e-2 of
max|y|.  Prints the card, each variant's registers and spills of
``bitlinear_mma_kernel`` (-Xptxas -v), then one JSON line per tensor: ms
per variant (device time: CUDA events around the launch with the card kept
busy while the host enqueues it, median of 5, L2 overwritten before each)
and the matmul's.  Needs one CUDA card and nvcc; imports nothing of JAX.
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
OUT = os.path.join(ROOT, "build", "grid_variants")
sys.path.insert(0, os.path.join(ROOT, "src"))

# tensor -> (d_in, d_out, tile_n, K, tile_d)
SHAPES = {"qwen_wq": (5120, 8192, 32, 4, 128), "qwen_gate": (5120, 25600, 32, 4, 128),
          "qwen_down": (25600, 5120, 32, 4, 128), "zamba2_in_proj": (2048, 8384, 32, 4, 131),
          "mamba2_in_proj": (768, 3352, 32, 4, 419)}
T = 4096
R_CHUNKS = (2, 4, 8)
OTHER_SHAPES = ((4, 2, 2, 2), (4, 4, 3, 1), (8, 2, 2, 1), (2, 4, 2, 2))
SPIN_CYCLES = 200_000   # ~0.1 ms of the card's clock, longer than the host's enqueue


def shape_flags(rows, cols, stages, blocks) -> list:
    return [f"-DBITLINEAR_MMA_ROW_TILES={rows}", f"-DBITLINEAR_MMA_NCB={cols}",
            f"-DBITLINEAR_MMA_STAGES={stages}", f"-DBITLINEAR_MMA_MIN_BLOCKS={blocks}"]


def variants() -> dict:
    """name -> (-D flags, output checked)."""
    out = {"as_built": ([], True),
           "staging_only": (["-DBITLINEAR_MMA_VARIANT=1"], False),
           "mma_only": (["-DBITLINEAR_MMA_VARIANT=2"], False),
           "no_repack": (["-DBITLINEAR_MMA_VARIANT=4"], False),
           "no_store": (["-DBITLINEAR_MMA_VARIANT=5"], False),
           "c_span": (["-DBITLINEAR_MMA_C_STAGING=1"], True),
           "c_rows": (["-DBITLINEAR_MMA_C_STAGING=2"], True),
           "chunk128": (["-DBITLINEAR_MMA_MAX_NTP=8"], True),
           "chunk64": (["-DBITLINEAR_MMA_MAX_NTP=4"], True)}
    for shape in OTHER_SHAPES:
        out["rows{}_cols{}_stages{}_blocks{}".format(*shape)] = (shape_flags(*shape), True)
    return out


def ptxas(log: str) -> dict:
    """Most registers and the spilled bytes over bitlinear_mma_kernel's instances."""
    regs, spills, cur = 0, 0, False
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = "bitlinear_mma_kernel" in ln
        elif cur:
            m = re.search(r"(\d+) bytes spill stores", ln)
            spills += int(m.group(1)) if m else 0
            m = re.search(r"Used (\d+) registers", ln)
            regs = max(regs, int(m.group(1))) if m else regs
    return {"registers": regs, "spill_store_bytes": spills}


def build(named: dict, parent: str | None = None) -> tuple[dict, dict]:
    """Compile every variant in parallel, and the ``parent`` tree's
    ``bitlinear.cu`` as the variant "parent"; (name -> entry point, name ->
    ptxas)."""
    from repro_torch.kernels import _build

    procs = {}
    for name, (flags, _) in named.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        cmd = _build.command("bitlinear", os.path.join(d, "libgrid.so"), flags)
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    if parent:
        d = os.path.join(OUT, "parent")
        os.makedirs(d, exist_ok=True)
        cmd = _build.command("bitlinear", os.path.join(d, "libgrid.so"))
        cmd[-1] = os.path.join(os.path.abspath(parent), "src", "repro_torch", "csrc",
                               "bitlinear.cu")
        procs["parent"] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True)
    fns, regs = {}, {}
    for name, p in procs.items():
        out, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{err[-4000:]}")
        regs[name] = ptxas(out + err)
        fn = ctypes.CDLL(os.path.join(OUT, name, "libgrid.so")).bitlinear_grid
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main(argv=None) -> int:
    import argparse

    import torch

    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--parent", help="a git archive of an earlier commit to time beside")
    args = args.parse_args(argv)

    if not torch.cuda.is_available():
        print("torch_grid_variants: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import quantized
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    named = variants()
    fns, regs = build(named, args.parent)
    print(json.dumps({"ptxas_bitlinear_mma_kernel": regs}), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn, reps=5):
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
    for tensor, (d_in, d_out, tn, K, td) in SHAPES.items():
        n_r, n_c = d_in // tn, d_out // td
        mp = torch.randint(0, 256, (n_r, n_c, tn, 1), generator=g, device=dev, dtype=torch.uint8)
        C = (torch.randn(n_r, n_c, K, td, generator=g, device=dev) * 0.2).bfloat16()
        x = torch.randn(T, d_in, generator=g, device=dev).bfloat16()
        y = torch.empty(T, d_out, dtype=torch.bfloat16, device=dev)
        want = ref.bitlinear_ref(x, mp, C)
        dense = quantized.decompress({"m_packed": mp, "C": C}, torch.bfloat16)
        row = {"tensor": tensor, "T": T, "shape": [n_r, n_c, tn, K, td],
               "mma_chunk": list(bl.grid_mma_chunk(td)),
               "matmul_ms": device_ms(lambda: torch.matmul(x, dense))}
        # parent and this tree in turns: parent, as built, ..., as built, parent
        order = (["parent"] if "parent" in fns else []) + [n for n in fns if n != "parent"]
        runs = [(name, fns[name], 1) for name in order]
        runs += [(f"as_built_rc{rc}", fns["as_built"], rc) for rc in R_CHUNKS]
        if "parent" in fns:
            runs += [("as_built_again", fns["as_built"], 1), ("parent_again", fns["parent"], 1)]
        for name, fn, rc in runs:
            ran = ctypes.c_int(0)

            def call(fn=fn, ran=ran, rc=rc):
                return fn(x.data_ptr(), mp.data_ptr(), C.data_ptr(), y.data_ptr(), 1, T, n_r,
                          n_c, tn, 1, K, td, 1, 1, 0, 64, rc, budget, bl.SMALL_T, stream,
                          ctypes.byref(ran))

            y.fill_(float("nan"))
            err = call()
            torch.cuda.synchronize()
            if err < 0:
                row[f"{name}_ms"] = None
                row[f"{name}_refused_smem_bytes"] = -err
                continue
            if err or not (ran.value or name.startswith("parent")):
                raise RuntimeError(f"variant {name}: launch returned {err}, tensor cores "
                                   f"{ran.value}")
            if name == "parent":
                row["parent_tensor_cores"] = bool(ran.value)
            if named.get(name.split("_rc")[0].removesuffix("_again"), ([], True))[1]:
                diff = float((y.float() - want.float()).abs().max())
                if not diff <= 2e-2 * float(want.float().abs().max()):
                    raise RuntimeError(f"variant {name} on {tensor}: |y - plain| {diff:.3g}")
            row[f"{name}_ms"] = device_ms(call)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
