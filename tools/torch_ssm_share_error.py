#!/usr/bin/env python3
"""How far the f32 rank shares of zamba2's ``ssm_attn`` layer, and the whole
f32 layer, lie from the same layer in f64, and which of the shares' sums
moves them.

    PYTHONPATH=src python3 tools/torch_ssm_share_error.py [--device cpu]
        [--widths full reduced] [--models 4 16] [--batch 4] [--seq 1024]

Builds zamba2-1.2b's last block (``ssm_attn``: the SSM, then the shared
attention block) in f32 on random weights from seed 0, at its published
width (``full``: d_model 2,048) and at the reduced width of
``configs.reduced_for_smoke`` (``reduced``: d_model 64), with a random
input of ``batch`` x ``seq`` tokens, and runs it on the plain path (kernel
hooks cleared) three ways:

  whole    the layer in f32;
  shares   each rank's share for ``model`` = m, the ranks one after another
           (``distributed/local_ranks.run_in_turns``, as ``chip_smoke.py``
           phase 12c computes them), joined;
  f64      the layer whole in f64 (weights and input cast), the reference.

Then again with one of the three sums the tensor-parallel SSM block adds
done in f64 (its inputs cast up, its result cast back to f32), in the whole
layer and in the shares alike:

  in_proj   ``models/ssm._in_proj``: the fused projection (the rank's
            columns moved by ``model_all_to_all``), a sum over d_model;
  norm      ``models/ssm._gated_norm``: the gated RMSNorm, whose statistic
            is summed over ``model`` from each rank's d_inner box;
  out_proj  the row-parallel ``out_proj``: each rank's partial product over
            its d_inner box and their sum over ``model``;
  all       the three at once;
  shared    the shared attention block's products (``attention`` and
            ``mlp``), among them the row-parallel ``wo`` and ``down`` and
            their sums over ``model``;
  all_shared  the SSM's three and the shared block's.

Each error is max|y - y64| / max|y64 - x| over the layer's output y.  A
line of JSON a (width, m, variant), then a summary a (width, m): the gap
``shares_vs_whole`` and, for each variant, the part of it that the sum in
f64 removes (1 - its gap / the f32 gap).  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch

VARIANTS = ("f32", "in_proj", "norm", "out_proj", "all", "shared", "all_shared")


def config(width: str):
    """zamba2-1.2b at its published width, or reduced, in f32."""
    from repro_torch.configs import get_config, reduced_for_smoke

    cfg = get_config("zamba2-1.2b")
    if width == "reduced":
        cfg = reduced_for_smoke(cfg)
    return dataclasses.replace(cfg, dtype="float32")


def build(cfg, device, batch: int, seq: int, seed: int = 0) -> dict:
    """The layer's values and axes, the shared block's, and an input x, in
    f32 from ``seed``."""
    from repro_torch.models import transformer as tr
    from repro_torch.models.params import split

    g = torch.Generator(device=device).manual_seed(seed)
    values, axes = split(tr._init_block(g, "ssm_attn", cfg, torch.float32))
    shared, shared_axes = split(tr._init_shared_attn(g, cfg, torch.float32))
    x = torch.randn((batch, seq, cfg.d_model), generator=g, device=device)
    return {"values": values, "axes": axes, "shared": shared, "shared_axes": shared_axes,
            "x": x}


def wider(tree):
    """Every floating tensor of ``tree`` in f64, keeping its placement mark
    along ``model`` (``sharding.mark_tp``)."""
    from repro_torch.distributed import sharding as shd

    if isinstance(tree, dict):
        return {k: wider(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        out = tree.to(torch.float64)
        if hasattr(tree, "_tp_dim"):
            shd.mark_tp(out, tree._tp_dim)
        return out
    return tree


def whole(cfg, layer: dict):
    """The layer's output, whole, on the plain path, in the dtype of
    ``layer``'s tensors."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    with torch.no_grad(), ops.kernels_off():
        y, _, _ = tr._apply_block(layer["x"], layer["values"], "ssm_attn", cfg,
                                  layer["shared"], cache=None, pos_offset=0,
                                  window=cfg.sliding_window)
    return y


def shares(cfg, layer: dict, m: int):
    """The ranks' shares of the layer along ``model`` = m on the plain path,
    one rank after another, joined: (output, passes of the ranks)."""
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.local_ranks import RankMesh, local_boxes, run_in_turns
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tr

    x = layer["x"]
    d = cfg.d_model // m
    rules = shd.make_rules(ParallelConfig(mesh_shape=(1, m), mesh_axes=("data", "model")))
    boxes = []
    for r in range(m):
        mesh = RankMesh(m, r, x.device.type)
        sh = {"block": shd.param_shardings(layer["axes"], layer["values"], rules, mesh),
              "shared": shd.param_shardings(layer["shared_axes"], layer["shared"], rules,
                                            mesh)}
        boxes.append(({k: local_boxes(layer["values" if k == "block" else k], sh[k])
                       for k in sh}, sh))

    def share(r, grp):
        local, sh = boxes[r]
        with shd.gathering(sh, None, (), x.dtype), shd.model_parallel((grp, m, r)):
            p = shd.gather_params(local["block"], "block")
            sp = shd.gather_params(local["shared"], "shared")
            y, _, _ = tr._apply_block(x[..., r * d:(r + 1) * d], p, "ssm_attn", cfg, sp,
                                      cache=None, pos_offset=0, window=cfg.sliding_window)
        return y

    with torch.no_grad(), ops.kernels_off():
        outs, passes, _ = run_in_turns(share, m)
    return torch.cat(outs, -1), passes


@contextlib.contextmanager
def in_f64(variant: str):
    """The sums of ``variant`` (module docstring) done in f64 for the
    block's duration."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import attention as attn_lib
    from repro_torch.models import layers, ssm

    saved = (ssm._in_proj, ssm._gated_norm, ssm.ssm_block, layers.apply_dense,
             shd.model_scatter, shd.model_sum, attn_lib.attention, layers.mlp)
    in_proj, gated_norm, block, dense, scatter, total, attention, mlp = saved
    parts = {"all": {"in_proj", "norm", "out_proj"},
             "all_shared": {"in_proj", "norm", "out_proj", "shared"}}.get(variant, {variant})

    def wide(w):
        # a partial product stays f64 through the sum over model (the
        # scatter or sum of ``transformer._add``, cast back after it); a
        # whole one is cast back at once
        return shd.model_size() > 1 and shd.tp_dim(layers._value(w)) == 0

    def dense64(x, q):
        y = dense(x.to(torch.float64), wider(q))
        return y if wide(q["w"]) else y.to(x.dtype)

    def in_proj64(h, p, cfg, nl):
        return in_proj(h.to(torch.float64), wider(p), cfg, nl).to(h.dtype)

    def gated_norm64(y, z, scale, cfg, c0):
        return gated_norm(y.to(torch.float64), z.to(torch.float64), wider(scale), cfg,
                          c0).to(y.dtype)

    def block64(h, p, cfg, **kw):
        # out_proj's product in f64
        target = p["out_proj"]
        layers.apply_dense = lambda x, q: dense64(x, q) if q is target else dense(x, q)
        try:
            return block(h, p, cfg, **kw)
        finally:
            layers.apply_dense = dense

    def all_dense64(fn):
        # every product of ``fn`` in f64
        def run(*a, **k):
            layers.apply_dense = dense64
            try:
                return fn(*a, **k)
            finally:
                layers.apply_dense = dense
        return run

    def back_to_f32(fn):
        def run(x, *a):
            y = fn(x, *a)
            return y.to(torch.float32) if x.dtype == torch.float64 else y
        return run

    if "in_proj" in parts:
        ssm._in_proj = in_proj64
    if "norm" in parts:
        ssm._gated_norm = gated_norm64
    if "out_proj" in parts:
        ssm.ssm_block = block64
    if "shared" in parts:
        attn_lib.attention, layers.mlp = all_dense64(attention), all_dense64(mlp)
    if parts & {"out_proj", "shared"}:
        shd.model_scatter, shd.model_sum = back_to_f32(scatter), back_to_f32(total)
    try:
        yield
    finally:
        (ssm._in_proj, ssm._gated_norm, ssm.ssm_block, layers.apply_dense,
         shd.model_scatter, shd.model_sum, attn_lib.attention, layers.mlp) = saved


def errors(width: str, models, device, batch: int, seq: int, variants=VARIANTS, say=print):
    """The records of one width: one a (m, variant), each with
    ``whole_vs_f64``, ``shares_vs_f64`` and ``shares_vs_whole`` (of
    max|update| in f64), then a summary a m."""
    cfg = config(width)
    layer = build(cfg, device, batch, seq)
    layer64 = {k: wider(v) for k, v in layer.items()}
    y64 = whole(cfg, layer64)
    scale = float((y64 - layer64["x"]).abs().max())

    def err(a, b):
        return float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) / scale

    recs = []
    for variant in variants:
        with in_f64(variant) if variant != "f32" else contextlib.nullcontext():
            t = time.time()
            y = whole(cfg, layer)
            whole_s = time.time() - t
            for m in models:
                t = time.time()
                joined, passes = shares(cfg, layer, m)
                rec = {"width": width, "d_model": cfg.d_model, "d_inner": cfg.d_inner,
                       "m": m, "variant": variant, "whole_vs_f64": err(y, y64),
                       "shares_vs_f64": err(joined, y64), "shares_vs_whole": err(joined, y),
                       "passes": passes, "whole_s": whole_s, "shares_s": time.time() - t}
                say(json.dumps({"ssm_share_error": rec}))
                recs.append(rec)
    for m in models:
        by = {r["variant"]: r for r in recs if r["m"] == m}
        gap = by["f32"]["shares_vs_whole"] if "f32" in by else None
        summary = {"width": width, "m": m, "whole_vs_f64": by.get("f32", {}).get("whole_vs_f64"),
                   "shares_vs_f64": by.get("f32", {}).get("shares_vs_f64"), "gap": gap,
                   "gap_removed_by_f64": {v: (1.0 - r["shares_vs_whole"] / gap) if gap else None
                                          for v, r in by.items() if v != "f32"}}
        say(json.dumps({"ssm_share_summary": summary}))
        recs.append(summary)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--widths", nargs="+", default=["full", "reduced"],
                    choices=["full", "reduced"])
    ap.add_argument("--models", nargs="+", type=int, default=[4, 16])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=VARIANTS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: as set)")
    args = ap.parse_args(argv)
    if args.threads:
        torch.set_num_threads(args.threads)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        print(torch.cuda.get_device_name(0), flush=True)
    for width in args.widths:
        errors(width, args.models, device, args.batch, args.seq, args.variants,
               say=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
