#!/usr/bin/env python3
"""K1's lanes and decision modes, and K2 by replicas and by part, timed on one GPU.

    python3 tools/torch_anneal_variants.py

K1 (``csrc/sa_sweep.cu``) through its C entry point at ``chip_smoke.py``'s
timed shapes (the BBO pool's and phase 6's) at every lanes per chain (4, 8,
16, 32) x decision (thresholds found before the sweeps, or each step's own
division and ``expf``), each held bit-identical to the wrapper's launch:
the data behind ``sa_sweep.lanes_per_chain`` and ``direct_acceptance``.
K2 (``csrc/sqa_sweep.cu``) at the paper's 25 runs x 10 reads x 64 sweeps
x 24 spins for T = 1, 2, 4, 8, 16 replicas (G = min(T, 8) warps a chain),
and at T = 8 built from copies of its source with one part of the step
taken out (``variants()``: the block barrier, the neighbour reads, the
shuffle) into ``build/anneal_variants/``: what each part costs (their
results differ; timing only).  Device time (CUDA events, median of 10, the
L2 overwritten before each launch and the card kept busy while the host
enqueues it).  Prints the card, then one JSON line per measurement.  Needs
one CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "anneal_variants")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

K2_T = (1, 2, 4, 8, 16)
K2_SHAPE = (25, 10, 64, 24)        # P, C, S, n
SQA_TEMPERATURE = 0.05


def variants() -> dict:
    """name -> text substitutions (old, new) of csrc/sqa_sweep.cu; each old
    text must occur in the source exactly once."""
    return {
        "as_built": [],
        "no_barrier": [("      __syncthreads();\n      sync = d;", "      sync = d;")],
        "no_neighbours": [(
            "const float nb = __fadd_rn(anneal::lds(ap + ai), anneal::lds(am + ai));",
            "const float nb = 0.f;")],
        "no_shuffle": [("const float delta = __shfl_sync(0xffffffffu, dl, o);",
                        "const float delta = dl;")],
    }


def build_variant(name: str, subs) -> str:
    """The library of csrc/sqa_sweep.cu with ``subs`` applied, built as
    the port builds it."""
    from repro_torch.kernels import _build

    csrc = os.path.join(ROOT, "src", "repro_torch", "csrc")
    code = open(os.path.join(csrc, "sqa_sweep.cu")).read()
    for old, new in subs:
        if code.count(old) != 1:
            raise RuntimeError(f"{name}: the substituted text is not in sqa_sweep.cu once")
        code = code.replace(old, new)
    out = os.path.join(OUT, name)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "sqa_sweep.cu"), "w") as f:
        f.write(code)
    shutil.copy(os.path.join(csrc, "anneal_step.cuh"), out)
    lib = os.path.join(out, "libsqa_sweep.so")
    cmd = [_build._nvcc(), *_build._COMMON, *_build.SOURCES["sqa_sweep"], "-o", lib,
           os.path.join(out, "sqa_sweep.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr[-4000:]}")
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_anneal_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import ising
    from repro_torch.kernels import _build
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.kernels import sqa_sweep as sqa

    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    k1 = _build.load("sa_sweep").sa_sweep_many_f32
    k1.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    k1.restype = ctypes.c_int
    for label, (P, C, S, n, schedule) in cs.K1_FIXTURES.items():
        if label == "sa_geometric":
            continue
        h, B = cs.dyadic_problems(torch, g, P, n, dev)
        x0 = (2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, n), generator=g, device=dev)
        temps = (torch.full((P, S), 0.1, device=dev) if schedule == "const"
                 else ising._temperature_schedule(h, B, S).float().contiguous())
        want = sa.sa_sweep_many(h, B, x0, u, temps)
        theta, x = torch.empty_like(u), torch.empty_like(x0)
        e = torch.empty((P, C), device=dev)
        for lanes in (4, 8, 16, 32):
            for direct in (0, 1):
                def run():
                    err = k1(h.data_ptr(), B.data_ptr(), x0.data_ptr(), u.data_ptr(),
                             temps.data_ptr(), theta.data_ptr(), x.data_ptr(), e.data_ptr(),
                             P, C, S, n, lanes, direct, stream, None)
                    if err:
                        raise RuntimeError(f"K1 {label}: launch returned {err}")
                run()
                torch.cuda.synchronize()
                if not (torch.equal(x, want[0]) and torch.equal(e, want[1])):
                    raise RuntimeError(f"K1 {label} at {lanes} lanes, direct {direct}: "
                                       "not the wrapper's bits")
                print(json.dumps({"kernel": "K1", "shape": label, "lanes": lanes,
                                  "direct": bool(direct),
                                  "device_ms": cs.cuda_ms(torch, run, 10, flush, busy=True)}),
                      flush=True)

    P, C, S, n = K2_SHAPE

    def k2_inputs(T):
        h, B = cs.dyadic_problems(torch, g, P, n, dev)
        X0 = (2.0 * torch.randint(0, 2, (P, C, T, n), generator=g, device=dev) - 1.0)
        u = torch.rand((P, C, S, T, n), generator=g, device=dev)
        jp = ising.sqa_jperps(S, T, SQA_TEMPERATURE, 3.0, dev).contiguous()
        return h, B, X0.contiguous(), u, jp

    for T in K2_T:
        h, B, X0, u, jp = k2_inputs(T)
        G, d = sqa.wavefront_schedule(T, n)
        ms = cs.cuda_ms(torch, lambda: sqa.sqa_sweep_many(h, B, X0, u, jp, SQA_TEMPERATURE), 10,
                        flush, busy=True)
        steps = d * (S * T - 1) + n
        print(json.dumps({"kernel": "K2", "T": T, "groups": G, "skew": d,
                          "wavefront_steps": steps, "device_ms": ms,
                          "ns_per_wavefront_step": ms * 1e6 / steps}), flush=True)

    T = 8
    h, B, X0, u, jp = k2_inputs(T)
    G, d = sqa.wavefront_schedule(T, n)
    want, _ = sqa.sqa_sweep_many(h, B, X0, u, jp, SQA_TEMPERATURE)
    theta, X = torch.empty_like(u), torch.empty_like(X0)
    E = torch.empty((P, C, T), device=dev)
    for name, subs in variants().items():
        fn = ctypes.CDLL(build_variant(name, subs)).sqa_sweep_many_f32
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def run():
            err = fn(h.data_ptr(), B.data_ptr(), X0.data_ptr(), u.data_ptr(), jp.data_ptr(),
                     theta.data_ptr(), X.data_ptr(), E.data_ptr(), P, C, T, S, n, G, d,
                     SQA_TEMPERATURE, stream)
            if err:
                raise RuntimeError(f"K2 {name}: launch returned {err}")
        run()
        torch.cuda.synchronize()
        print(json.dumps({"kernel": "K2", "variant": name, "T": T,
                          "device_ms": cs.cuda_ms(torch, run, 10, flush, busy=True),
                          "same_as_built": bool(torch.equal(X, want))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
