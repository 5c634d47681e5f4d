"""Config-zoo sweep on the PyTorch/CUDA port: plan -> execute -> artifact
roundtrip -> serve parity across every frontend family in the zoo.

For each config it asserts, on the reduced-for-smoke shape (or, with
``--full-width``, the published one):

  1. the policy plans a non-empty tensor set,
  2. ``compress_model`` runs and the artifact and checkpoint survive a
     save/load roundtrip (the same tensor set; ``validate_params`` clean
     against the restored tree, every leaf equal to the compressed one),
  3. the compressed forward agrees between the plain serving path (kernel
     hooks off: unpack + einsum, plain attention) and the kernel hooks on
     (``kernels.ops.enable_kernels``: K3 and K5 on the card, their plain
     versions on the CPU), on a deterministic calibration batch drawn
     through the arch's own frontend (token ids, frame embeddings or patch
     stubs).

Reduced configs run in float32 and must be argmax-identical.  At full
width (bf16, the default ``CompressionPolicy()``) the logits must agree
within LOGIT_TOL (5e-2) of max|logit|, and the argmax mismatches are
reported: bf16 rounding flips near-tied choices.  ``chip_smoke.py`` phase
14a runs ``compress_and_restore`` and ``check_logits`` on musicgen-medium,
internvl2-2b and command-r-plus-104b at full width, and serves them.

Covers the mamba2 (SSM), zamba2 (hybrid), internvl2 (VLM) and musicgen
(audio) families by default.

    PYTHONPATH=src python tools/torch_config_zoo_smoke.py --device cpu
    PYTHONPATH=src python tools/torch_config_zoo_smoke.py --archs mamba2-130m
    PYTHONPATH=src python tools/torch_config_zoo_smoke.py --full-width     # on the GPU
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

ARCHS = ("mamba2-130m", "zamba2-1.2b", "internvl2-2b", "musicgen-medium")
# kernel hooks on vs off, of max|logit|, in bf16: z is rounded to bf16 in K3,
# and the plain attention forms its scores in bf16 where K5 keeps them in f32
# (chip_smoke.py holds every phase's logits to this one limit)
LOGIT_TOL = 5e-2


def smoke_policy():
    """The reduced sweep's policy (the reference sweep's)."""
    from repro_torch.compression import CompressionPolicy

    return CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                             min_size=4096)


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def compress_and_restore(cfg, policy, values, work_dir, *, seed: int = 0, device=None):
    """``compress_model`` of ``values`` into ``work_dir`` (checkpoint step 0
    and the manifest), then both read back: the artifact's tensor set
    unchanged, ``validate_params`` clean on the restored tree and every
    restored leaf equal to the compressed one.  Raises AssertionError on a
    failed check.  Returns (restored params, loaded artifact, {"compress_s",
    "restore_s"})."""
    import torch

    from repro_torch.checkpoint import checkpointer
    from repro_torch.compression import CompressionArtifact
    from repro_torch.compression.plan import tree_paths
    from repro_torch.device import resolve_device
    from repro_torch.launch.compress import compress_model
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    dev = resolve_device(device)
    t = time.time()
    cvals, artifact = compress_model(cfg, policy, work_dir, seed=seed, device=dev, values=values,
                                     verbose=False)
    _sync(dev)
    walls = {"compress_s": time.time() - t}
    t = time.time()
    loaded = CompressionArtifact.load(work_dir)
    template = {"params": loaded.restore_template(split(init_model(cfg, device="meta"))[0])}
    params = checkpointer.restore(work_dir, 0, template, device=dev)["params"]
    _sync(dev)
    walls["restore_s"] = time.time() - t
    if loaded.manifest["tensors"].keys() != artifact.manifest["tensors"].keys():
        raise AssertionError(f"{cfg.name}: artifact roundtrip changed tensor set")
    problems = loaded.validate_params(params)
    if problems:
        raise AssertionError(f"{cfg.name}: validate_params: {problems}")
    restored, compressed = dict(tree_paths(params)), dict(tree_paths(cvals))
    if restored.keys() != compressed.keys() or not all(
            torch.equal(restored[p], compressed[p]) for p in compressed):
        raise AssertionError(f"{cfg.name}: a restored leaf differs from the compressed one")
    return params, loaded, walls


def logits_agreement(plain, kernels):
    """(max|kernels - plain| / max|plain|, argmax mismatches) of two logits
    tensors (..., V), in f32 a slice of rows at a time."""
    a2, b2 = plain.reshape(-1, plain.shape[-1]), kernels.reshape(-1, kernels.shape[-1])
    diff = scale = 0.0
    mismatch = 0
    for i in range(0, a2.shape[0], 256):
        a, b = a2[i:i + 256].float(), b2[i:i + 256].float()
        diff = max(diff, float((a - b).abs().max()))
        scale = max(scale, float(a.abs().max()))
        mismatch += int((a.argmax(-1) != b.argmax(-1)).sum())
    return diff / scale, mismatch


def check_logits(label, plain, kernels, exact: bool):
    """Kernel hooks off against on: finite logits of one shape; with
    ``exact`` (float32) argmax-identical, else (bf16) within LOGIT_TOL of
    max|logit|, the argmax mismatches only reported (bf16 rounding flips
    near-tied choices).  Raises AssertionError; returns (max|delta| /
    max|logit|, argmax mismatches)."""
    import torch

    if plain.shape != kernels.shape:
        raise AssertionError(f"{label}: logits shape {tuple(plain.shape)} != "
                             f"{tuple(kernels.shape)}")
    if not (bool(torch.isfinite(plain).all()) and bool(torch.isfinite(kernels).all())):
        raise AssertionError(f"{label}: non-finite logits")
    rel, mismatch = logits_agreement(plain, kernels)
    if exact and mismatch:
        raise AssertionError(
            f"{label}: plain-vs-kernels argmax parity failed at {mismatch}/"
            f"{plain.numel() // plain.shape[-1]} positions (max |delta| / max|logit| "
            f"{rel:.3e})")
    if not exact and rel > LOGIT_TOL:
        raise AssertionError(f"{label}: logits differ by {rel:.3e} of max|logit| "
                             f"(limit {LOGIT_TOL})")
    return rel, mismatch


def run_arch(arch: str, *, batch: int = 2, seq_len: int = 16, device=None,
             full_width: bool = False) -> dict:
    """One arch through the cycle; raises AssertionError on a failed check.
    Returns the plan (its JSON and skipped list), the compressed bytes, the
    logits' shape, the argmax mismatches and max|delta| / max|logit|."""
    import torch

    from repro_torch import compression as comp
    from repro_torch.compression.autotune import calibration_inputs
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models import forward, init_model
    from repro_torch.models.params import split

    dev = resolve_device(device)
    cfg = get_config(arch) if full_width else reduced_for_smoke(get_config(arch))
    vals, _ = split(init_model(cfg, seed=0, device=dev))

    policy = comp.CompressionPolicy() if full_width else smoke_policy()
    plan = comp.plan_compression(vals, policy)
    if not plan.tensors:
        raise AssertionError(f"{arch}: the policy planned no tensors")

    with tempfile.TemporaryDirectory() as tmp:
        cvals, artifact, _ = compress_and_restore(cfg, policy, vals, tmp, seed=0, device=dev)
    del vals
    if artifact.manifest["tensors"].keys() != {t.path for t in plan.tensors}:
        raise AssertionError(f"{arch}: the artifact's tensors are not the plan's")

    inputs = calibration_inputs(cfg, batch=batch, seq_len=seq_len, seed=0, device=dev)
    # the plain path, then the kernels; the caller's hooks restored after
    with ops.kernels_off(), torch.inference_mode():
        y_plain, _, _ = forward(cvals, inputs, cfg)
        ops.enable_kernels()
        y_kernels, _, _ = forward(cvals, inputs, cfg)

    rel, mismatch = check_logits(arch, y_plain, y_kernels, exact=cfg.dtype == "float32")
    return {
        "tensors": len(plan.tensors),
        "plan_json": plan.to_json(),
        "skipped": [list(s) for s in plan.skipped],
        "compressed_bytes": sum(t.pred_bytes for t in plan.tensors),
        "logits": list(y_plain.shape),
        "argmax_mismatch": mismatch,
        "max_rel_err": rel,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--archs", nargs="+", default=list(ARCHS),
                    help="configs to sweep (default: the zoo set)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=16)
    ap.add_argument("--full-width", action="store_true",
                    help="the published config at the default CompressionPolicy(), "
                         "not reduced_for_smoke")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    failures = []
    for arch in args.archs:
        t0 = time.perf_counter()
        try:
            info = run_arch(arch, batch=args.batch, seq_len=args.seq_len, device=args.device,
                            full_width=args.full_width)
        except Exception as exc:  # noqa: BLE001 - sweep reports, then fails
            failures.append((arch, exc))
            print(f"[zoo] {arch}: FAIL ({exc})")
            continue
        print(
            f"[zoo] {arch}: OK, {info['tensors']} tensors, "
            f"{info['compressed_bytes'] / 1024:.0f} KiB compressed, "
            f"{len(info['skipped'])} skipped, logits {info['logits']}, "
            f"argmax mismatches {info['argmax_mismatch']}, max |delta| / max|logit| "
            f"{info['max_rel_err']:.3e} ({time.perf_counter() - t0:.1f}s)"
        )
    if failures:
        print(f"[zoo] {len(failures)}/{len(args.archs)} archs failed")
        return 1
    print(f"[zoo] all {len(args.archs)} archs passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
