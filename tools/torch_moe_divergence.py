#!/usr/bin/env python3
"""How far the kernel path and the plain path of the MoE forward drift apart,
and why: rounding, or a fault.

    python3 tools/torch_moe_divergence.py

Compresses ``chip_smoke.py``'s phase 5 model (granite-moe-1b-a400m at its
published widths and depth, random weights from seed 0, the default
policy), restores it through ``serve_model`` and runs the 4 x 1024-token
prefill three ways:

  kernels     ``enable_kernels()``: K3, K4 and K5 on the card;
  plain       ``disable_kernels()``: the einsum forms and the plain attention
              (bf16 scores);
  kernel_ref  the kernels' own arithmetic in plain PyTorch on the card
              (``ref.bitlinear_ref``, ``ref.bitlinear_grouped_ref``, and
              attention with f32 scores and p rounded to v's dtype), which
              differs from ``kernels`` only in the order of f32 sums.

in bf16 and with the checkpoint cast to f32.  For each pair it prints the
last-position logits' distance and, per layer, the tokens whose top-k
expert set differs.  Then, teacher-forced (every layer fed the kernel
path's input), each layer's kernels-vs-plain difference relative to that
layer's update, and its expert-set flips.  Needs one card; imports nothing
of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_moe_divergence: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.core import quantized
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers, moe
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    cfg = cs.moe_config()
    out_dir = os.path.join(ROOT, "build", "torch_moe_divergence_ckpt")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        cs.phase_moe_compress(torch, dev, out_dir)
        res = serve_model(cfg, ckpt_dir=out_dir, batch=cs.GEN_BATCH, prompt_len=cs.GEN_PROMPT,
                          steps=1, eos_id=cfg.vocab_size, seed=cs.SEED, device=dev,
                          verbose=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    prompts = res.prompts

    def kernel_ref():
        ops.disable_kernels()

        def k3(x, w):
            y = ref.bitlinear_ref(x.reshape(-1, x.shape[-1]), w["m_packed"], w["C"])
            return y.reshape(*x.shape[:-1], -1)

        def k4(x, w):
            E = w["C"].shape[0]
            y = ref.bitlinear_grouped_ref(x.reshape(E, -1, x.shape[-1]), w["m_packed"], w["C"])
            return y.reshape(*x.shape[:-1], -1)

        def k5(qh, k, v, window):
            B, S, KV, rep, hd = qh.shape
            q = qh.reshape(B, S, KV * rep, hd).transpose(1, 2)
            o = cs.attention_f32_scores(torch, q, k.transpose(1, 2), v.transpose(1, 2),
                                        window)[0].to(v.dtype)
            return o.transpose(1, 2).reshape(B, S, KV, rep, hd)

        quantized.register_bitlinear_fused(k3)
        quantized.register_bitlinear_grouped(k4)
        attn_lib.register_flash(k5)

    sets, block = [], moe.moe_block

    def tap(h, p, c):
        sets.append(cs._expert_sets(torch, h, p["router"], c.experts_per_token))
        return block(h, p, c)

    def teacher_forced(c, params):
        """Each layer fed the kernel path's input: kernels vs plain, relative
        to the layer's update, and the layer's expert-set flips."""
        p = tf._values(params)
        h = layers.embed_lookup(prompts, p["embed"]).to(tf.model_dtype(c))
        out = []
        moe.moe_block = tap
        try:
            with torch.inference_mode():
                for g in range(c.num_groups):
                    gp, step = tf._index(p["groups"], g), {}
                    for name, setup in (("kernels", ops.enable_kernels),
                                        ("plain", ops.disable_kernels)):
                        setup()
                        sets.clear()
                        step[name] = (tf._apply_group(h, gp, c, cache=None, pos_offset=0,
                                                      window=0)[0], sets[0])
                    (hk, sk), (hp, sp) = step["kernels"], step["plain"]
                    diff, upd = (hk.float() - hp.float()).abs(), (hp.float() - h.float()).abs()
                    out.append({"mean_diff_over_mean_update": float(diff.mean() / upd.mean()),
                                "max_diff_over_max_update": float(diff.max() / upd.max()),
                                "expert_sets_differ": int((sk != sp).any(-1).sum())})
                    h = hk
        finally:
            moe.moe_block = block
        return out

    paths = {"kernels": ops.enable_kernels, "plain": ops.disable_kernels,
             "kernel_ref": kernel_ref}

    def flips(a, b):
        return [int((x != y).any(-1).sum()) for x, y in zip(a, b)]

    try:
        for label, (c, params) in {
            "bf16": (cfg, res.engine.params),
            "f32": (dataclasses.replace(cfg, dtype="float32"), cs._to_f32(res.engine.params)),
        }.items():
            runs = {name: cs.moe_prefill(torch, c, params, prompts, dev, setup)[:2]
                    for name, setup in paths.items()}
            row = {}
            for a, b in (("kernels", "plain"), ("kernels", "kernel_ref"),
                         ("kernel_ref", "plain")):
                row[f"{a}_vs_{b}"] = {
                    "max_abs_diff": float((runs[a][0] - runs[b][0]).abs().max()),
                    "max_abs_logit": float(runs[b][0].abs().max()),
                    "expert_sets_differ": flips(runs[a][1], runs[b][1])}
            row["teacher_forced"] = teacher_forced(c, params)
            print(json.dumps({label: row}), flush=True)
    finally:
        ops.disable_kernels()
    return 0


if __name__ == "__main__":
    sys.exit(main())
