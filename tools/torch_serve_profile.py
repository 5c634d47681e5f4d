#!/usr/bin/env python3
"""Where the time of the PyTorch/CUDA port's serving path goes, on one GPU.

    python3 tools/torch_serve_profile.py [--arch qwen3-32b | granite-moe-1b-a400m |
                                          zamba2-1.2b]

Serves one of ``chip_smoke.py``'s serving configurations.  qwen3-32b (the
default) is phase 4's: phase 2 compresses qwen3-32b at its published widths
with depth cut to one layer (random weights from seed 0, chip_smoke's
policy).  granite-moe-1b-a400m is phase 5's and zamba2-1.2b phase 7's: the
whole model at its published widths and depth, compressed with the default
policy.
``serve_model`` restores that checkpoint and generates for chip_smoke's
prompts (which also warms up).
Then ``Engine.generate`` itself runs twice under ``torch.profiler``: with
one step (prefill and the first pick) and with all the steps.  The prefill
is read from the first run; the decode loop's launches and device times
are the differences of the two, per kernel name.
Prints one JSON line with, for each, the host wall time (the engine's own
``last_timing``, profiler on), the device busy time (the sum of kernel
times: one stream), the idle share, and device time and launches per
kernel name, largest first.  Needs one CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traced_generate(torch, eng, prompts, steps):
    """(device ms, launches) per kernel name of ``eng.generate(prompts,
    steps)``, and the engine's timing of that call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.generate(prompts, steps)
    times, counts = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            times[e.name] += e.time_range.elapsed_us() / 1e3
            counts[e.name] += 1
    if not times:
        raise RuntimeError("the profiler recorded no device events")
    return times, counts, dict(eng.last_timing)


def kernel_table(times, counts, wall_ms: float) -> dict:
    busy = sum(times.values())
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
        "launches": sum(counts.values()),
        "kernels": [{"name": n[:120], "ms": t, "launches": counts[n], "share": t / busy}
                    for n, t in times.most_common()],
    }


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b",
                    choices=["qwen3-32b", "granite-moe-1b-a400m", "zamba2-1.2b"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.launch.serve import serve_model

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    dev = torch.device("cuda")
    compress, cfg = {
        cs.MOE_ARCH: (cs.phase_moe_compress, cs.moe_config()),
        cs.ZAMBA_ARCH: (cs.phase_zamba_compress, cs.zamba_config()),
    }.get(args.arch, (cs.phase_compress, cs.full_width_config()[1]))
    out_dir = os.path.join(ROOT, "build", "torch_serve_profile_ckpt")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        compress(torch, dev, out_dir)
        res = serve_model(cfg, ckpt_dir=out_dir, batch=cs.GEN_BATCH, prompt_len=cs.GEN_PROMPT,
                          steps=cs.GEN_STEPS, eos_id=cfg.vocab_size, seed=cs.SEED, device=dev,
                          verbose=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    eng = res.engine
    t1, c1, timing1 = traced_generate(torch, eng, res.prompts, 1)
    tn, cn, timing = traced_generate(torch, eng, res.prompts, cs.GEN_STEPS)
    prefill = kernel_table(t1, c1, 1e3 * timing1["prefill_s"])
    dc = cn - c1                      # kernel names launched more often with all steps
    decode = kernel_table(collections.Counter({n: tn[n] - t1[n] for n in dc}), dc,
                          1e3 * timing["decode_s"])
    decode["launches_per_step"] = decode["launches"] / timing["decode_steps"]
    print(json.dumps({"profile": {
        "gpu": smi, "arch": cfg.name, "num_layers": cfg.num_layers, "batch": cs.GEN_BATCH,
        "prompt_len": cs.GEN_PROMPT, "steps": cs.GEN_STEPS,
        "decode_steps": timing["decode_steps"], "compression": eng.compression,
        "prefill": prefill, "decode": decode}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
