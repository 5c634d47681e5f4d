#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, then:

  1. K1 (csrc/sa_sweep.cu) against its plain PyTorch version on dyadic
     fixtures at the BBO pool's shape: spins and energies must be
     bit-identical.
  2. The main path at full width: ``compress_model`` on qwen3-32b's
     published widths with depth cut to one layer, a policy that refines
     ``attn/w[kv]`` with BBO (tn=8, K=3: n=24 spins, 10,240 tiles in one
     lock-step batch) and compresses every other weight with alternating;
     the checkpoint and manifest are saved and restored.  K1's launches
     must equal bbo_iters x chunks, and no BBO tile may end worse than its
     alternating start.
  3. Serving: with the fused hook enabled, ``apply_compressed`` on every
     compressed tensor at T = 1, 16, 512 bf16 tokens; each output is held
     against x @ decompress(w), and K3 (csrc/bitlinear.cu) must have been
     launched once per call.  Then K3 is held against its plain version on
     the same inputs and timed beside its bound and a dense bf16 matmul.

Prints JSON lines along the way, the card's ``nvidia-smi`` name and power
limit, a ``kernels`` line, and last ``{"ok": true, "device": ...}``.  Any
failure exits non-zero without that line.  Needs one card; exits non-zero
when CUDA is unavailable or when run outside the repository.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_FLOPS = 67e12               # H100 SXM float32, outside the tensor cores
BF16_FLOPS = 989e12             # H100 SXM bf16 tensor cores, dense

SEED = 0
BBO_ITERS = 32
SERVE_T = (1, 16, 512)
BF16_TOL = 2e-2                 # of max|y|: z is rounded to bf16 before z @ C


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def cuda_ms(torch, fn, reps: int, flush) -> float:
    """Median device time of ``fn`` over ``reps`` launches, each after the
    L2 cache was overwritten (a serving step finds its weights cold)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dyadic_problems(torch, g, P, n, dev):
    """h, B on the grid k/64, |.| <= 4: every field and energy is an exact
    float32 sum, so any summation order gives the same bits."""
    h = torch.randint(-256, 257, (P, n), generator=g, device=dev) / 64.0
    B = torch.triu(torch.randint(-256, 257, (P, n, n), generator=g, device=dev) / 64.0, 1)
    return h.float().contiguous(), (B + B.transpose(1, 2)).float().contiguous()


def phase_k1(torch, dev, flush):
    from repro_torch.kernels import ref
    from repro_torch.kernels.sa_sweep import sa_sweep_many

    g = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    # the BBO pool's solve: P tiles x 4 reads x 24 sweeps at T=0.1, n=24
    for label, (P, C, S, n, schedule) in {
        "sq_main_shape": (10240, 4, 24, 24, "const"),
        "sa_geometric": (512, 4, 32, 40, "geom"),
    }.items():
        h, B = dyadic_problems(torch, g, P, n, dev)
        x0 = (2.0 * torch.randint(0, 2, (P, C, n), generator=g, device=dev) - 1.0).contiguous()
        u = torch.rand((P, C, S, n), generator=g, device=dev)
        if schedule == "const":
            temps = torch.full((P, S), 0.1, device=dev)
        else:
            temps = torch.logspace(1.0, -1.5, S, device=dev).expand(P, S).contiguous()
        xk, ek = sa_sweep_many(h, B, x0, u, temps)
        xr, er = ref.sa_sweep_many_ref(h, B, x0, u, temps)
        torch.cuda.synchronize()
        err = max(float((xk - xr).abs().max()), float((ek - er).abs().max()))
        check(torch.equal(xk, xr), f"K1 spins differ from the plain version ({label})")
        check(torch.equal(ek, er), f"K1 energies differ from the plain version ({label})")
        out[label] = {"P": P, "C": C, "S": S, "n": n, "identical": True, "max_abs_err": err}
        if label == "sq_main_shape":
            ms = cuda_ms(torch, lambda: sa_sweep_many(h, B, x0, u, temps), 10, flush)
            plain_ms = cuda_ms(torch, lambda: ref.sa_sweep_many_ref(h, B, x0, u, temps), 2, flush)
            nbytes = 4 * (P * n + P * n * n + P * C * n + P * C * S * n + P * S + P * C * n + P * C)
            # per spin step: field update (n mul-adds) + acceptance (~6 ops);
            # per chain: initial field and final energy (2 n^2 mul-adds each)
            ops = P * C * (S * n * (2 * n + 6) + 4 * 2 * n * n)
            b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
            out["timing"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_bytes, b_ops),
                "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                "bytes": nbytes, "operations": ops,
            }
    return out


def full_width_config():
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-32b")
    return cfg, dataclasses.replace(cfg, num_layers=1)


def policy():
    from repro_torch.compression import CompressionPolicy, CompressionRule

    return CompressionPolicy(
        method="alternating", tile_n=32, tile_d=128, rank_ratio=0.125,
        rules=(CompressionRule(pattern=r"attn/w[kv]", method="bbo",
                               rank_ratio=0.375, bbo_iters=BBO_ITERS),),
    )


def leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def phase_compress(torch, dev, out_dir):
    from repro_torch.checkpoint import checkpointer
    from repro_torch.compression import CompressionArtifact
    from repro_torch.compression.execute import _tensor_signs, _tensor_tiles
    from repro_torch.compression.plan import plan_compression
    from repro_torch.core import decomposition as dec
    from repro_torch.core.compress import compress_tile_batch
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import sa_sweep as sa
    from repro_torch.launch.compress import compress_model
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    full, cfg = full_width_config()
    emit({"reduced": {"arch": cfg.name, "num_layers": [full.num_layers, cfg.num_layers],
                      "widths": "published (d_model 5120, 64x128 q heads, 8 kv heads, "
                                "d_ff 25600, vocab 151936, bf16)"}})
    pol = policy()
    values, _ = split(init_model(cfg, seed=SEED, device=dev))
    torch.cuda.synchronize()

    sa.sa_sweep_many.launches = 0
    bl.bitlinear.launches = 0
    t0 = time.time()
    cvalues, artifact = compress_model(cfg, pol, out_dir, seed=SEED, device=dev,
                                       max_pool_tiles=10240, values=values)
    torch.cuda.synchronize()
    wall = time.time() - t0
    k1_launches = sa.sa_sweep_many.launches
    check(bl.bitlinear.launches == 0, "compression launched the serving kernel")

    bbo_pools = [p for p in artifact.manifest["pools"] if p["method"] == "bbo"]
    check(len(bbo_pools) == 1, f"expected one BBO pool, got {len(bbo_pools)}")
    pool = bbo_pools[0]
    check(pool["chunks"] == 1, f"BBO pool of {pool['num_tiles']} tiles in {pool['chunks']} chunks")
    check(k1_launches == pool["bbo_iters"] * pool["chunks"],
          f"K1 launched {k1_launches} times, want {pool['bbo_iters']} x {pool['chunks']}")

    # no BBO tile ends worse than its alternating start (same draws)
    plan = plan_compression(values, pol)
    worst, err_sums, n_tiles = 0.0, [0.0, 0.0], 0
    for t in plan.tensors:
        if t.method != "bbo":
            continue
        tiles = _tensor_tiles(leaf(values, t.path), t, dev).float()
        M_alt, _, err_alt = compress_tile_batch(tiles, _tensor_signs(SEED, t, dev), t.K,
                                                "alternating")
        w = leaf(cvalues, t.path)
        M = dec.unpack_bits(w["m_packed"].reshape(-1, t.tile_n, w["m_packed"].shape[-1]), t.K)
        err = torch.sqrt(torch.clamp_min(dec.objective(M, tiles), 0.0)) / \
            torch.linalg.vector_norm(tiles, dim=(-2, -1)).clamp_min(1e-30)
        worst = max(worst, float((err - err_alt).max()))
        err_sums[0] += float(err_alt.sum())
        err_sums[1] += float(err.sum())
        n_tiles += err.numel()
    check(worst <= 1e-5, f"a BBO tile ended {worst:.3g} above its alternating start")

    # the checkpoint and manifest restore to what was computed
    art = CompressionArtifact.load(out_dir)
    restored = checkpointer.restore(out_dir, 0, {"params": art.restore_template(values)},
                                    device=dev)["params"]
    check(art.validate_params(restored) == [], "restored params disagree with the manifest")
    for path in artifact.manifest["tensors"]:
        for k, v in leaf(cvalues, path).items():
            check(torch.equal(leaf(restored, path)[k], v), f"restored {path}/{k} differs")
    tensors = {
        p: {"method": e["method"], "tile": [e["tile_n"], e["tile_d"]], "K": e["K"],
            "tiles": e["num_tiles"], "rel_err": e["rel_err"],
            "ratio": e["orig_bytes"] / e["new_bytes"]}
        for p, e in artifact.manifest["tensors"].items()
    }
    emit({"compress": {"wall_s": wall, "k1_launches": k1_launches, "tensors": tensors,
                       "pools": [{k: p[k] for k in ("method", "tile_n", "tile_d", "K",
                                                    "num_tiles", "chunks", "solver_calls")}
                                 for p in artifact.manifest["pools"]],
                       "totals": artifact.manifest["totals"],
                       "bbo_tiles": {"n": n_tiles,
                                     "mean_rel_err_alternating": err_sums[0] / n_tiles,
                                     "mean_rel_err_bbo": err_sums[1] / n_tiles,
                                     "worst_increase": worst}}})
    return restored, artifact, k1_launches


def phase_serve(torch, dev, params, artifact, flush):
    from repro_torch.core import quantized
    from repro_torch.kernels import bitlinear as bl
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    weights = {}
    for path, e in artifact.manifest["tensors"].items():
        w = leaf(params, path)
        weights[path] = {k: v[0] if e["group_dims"] else v for k, v in w.items()}
    inputs = {
        (path, T): torch.randn((T, w["m_packed"].shape[0] * w["m_packed"].shape[2]),
                               generator=g, device=dev).to(torch.bfloat16)
        for path, w in weights.items() for T in SERVE_T
    }
    ops.enable_kernels()
    torch.cuda.synchronize()
    bl.bitlinear.launches = 0
    t0 = time.time()
    outputs = {key: quantized.apply_compressed(x, weights[key[0]]) for key, x in inputs.items()}
    torch.cuda.synchronize()
    wall = time.time() - t0
    k3_launches = bl.bitlinear.launches
    ops.disable_kernels()
    check(k3_launches == len(weights) * len(SERVE_T),
          f"K3 launched {k3_launches} times, want {len(weights)} x {len(SERVE_T)}")

    rows = []
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "bytes_ms": 0.0, "ops_ms": 0.0}
    max_err = 0.0
    for (path, T), x in inputs.items():
        w = weights[path]
        y = outputs[(path, T)]
        dense = quantized.decompress(w, torch.float32)
        want = x.float() @ dense
        scale = float(want.abs().max())
        err = float((y.float() - want).abs().max())
        check(torch.isfinite(y).all() and tuple(y.shape) == tuple(want.shape),
              f"{path} T={T}: bad output")
        check(err <= BF16_TOL * scale, f"{path} T={T}: |y - x@W_hat| {err:.3g} > tol")
        mp, C = w["m_packed"], w["C"]
        yk = bl.bitlinear(x, mp, C)
        yp = ref.bitlinear_ref(x, mp, C)
        kerr = float((yk.float() - yp.float()).abs().max())
        check(kerr <= BF16_TOL * float(yp.float().abs().max()),
              f"{path} T={T}: kernel vs plain {kerr:.3g}")
        max_err = max(max_err, kerr)
        w_dense = dense.to(torch.bfloat16)
        del dense
        n_r, n_c, tn, kb = mp.shape
        K, td = C.shape[2], C.shape[3]
        ms = cuda_ms(torch, lambda: bl.bitlinear(x, mp, C), 5, flush)
        plain_ms = cuda_ms(torch, lambda: ref.bitlinear_ref(x, mp, C), 2, flush)
        library_ms = cuda_ms(torch, lambda: torch.matmul(x, w_dense), 5, flush)
        nbytes = mp.numel() + C.numel() * C.element_size() + x.numel() * 2 + y.numel() * 2
        ops_ = 2 * T * (n_r * tn * n_c * K + n_r * n_c * K * td)
        b_bytes, b_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops_ / BF16_FLOPS * 1e3
        rows.append({"tensor": path, "T": T, "shape": [n_r, n_c, tn, K, td], "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": max(b_bytes, b_ops),
                     "bound_by": "bytes" if b_bytes >= b_ops else "operations",
                     "max_abs_err": kerr})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                     ("bound_ms", max(b_bytes, b_ops)), ("bytes_ms", b_bytes),
                     ("ops_ms", b_ops)):
            totals[k] += v
        del w_dense
    emit({"serve": {"wall_s": wall, "k3_launches": k3_launches, "calls": rows}})
    return k3_launches, max_err, totals


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    phases = {}
    t = time.time()
    _build.build_all()
    phases["build_s"] = time.time() - t
    regs = {name: [ln.strip() for ln in _build.build_log(name).splitlines() if "registers" in ln]
            for name in _build.SOURCES}
    emit({"build": {"seconds": phases["build_s"], "ptxas": regs}})

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    t = time.time()
    k1 = phase_k1(torch, dev, flush)
    phases["k1_check_s"] = time.time() - t
    emit({"k1_check": k1})

    out_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        t = time.time()
        params, artifact, k1_launches = phase_compress(torch, dev, out_dir)
        phases["compress_s"] = time.time() - t
        t = time.time()
        k3_launches, k3_err, k3 = phase_serve(torch, dev, params, artifact, flush)
        phases["serve_s"] = time.time() - t
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    emit({"phase_s": phases})
    emit({"kernels": [
        {"name": "sa_sweep_many", "route": "cuda",
         "source": "src/repro_torch/csrc/sa_sweep.cu",
         "replaces": "src/repro/kernels/sa_sweep.py:114",
         "launches": k1_launches,
         "max_abs_err": max(v["max_abs_err"] for v in k1.values() if "max_abs_err" in v),
         "ms": k1["timing"]["ms"], "plain_ms": k1["timing"]["plain_ms"],
         "bound_ms": k1["timing"]["bound_ms"], "bound_by": k1["timing"]["bound_by"],
         "library_ms": None},
        {"name": "bitlinear", "route": "cuda",
         "source": "src/repro_torch/csrc/bitlinear.cu",
         "replaces": "src/repro/kernels/bitlinear.py:438",
         "launches": k3_launches, "max_abs_err": k3_err,
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": "bytes" if k3["bytes_ms"] >= k3["ops_ms"] else "operations",
         "library_ms": k3["library_ms"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
