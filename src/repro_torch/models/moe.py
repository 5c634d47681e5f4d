"""Mixture-of-Experts block: top-k routing with per-group capacity.

Counterpart of ``repro/models/moe.py``, same routing semantics: an f32
router and softmax, top-k then renormalised gates, a capacity of
``int(cf * tokens * k / E)`` slots per expert and routing block, slots
assigned in the flattened (S*k) order so earlier tokens are never displaced
by later ones, routing blocks of 1024 tokens (halved until they divide S),
the dense one-hot dispatch/combine (Switch/GShard) in ``h.dtype``, an
optional shared expert and the Switch balance loss.

Ties in the top-k are broken towards the lower expert index, as
``lax.top_k`` does (a stable descending sort, not ``torch.topk``, whose tie
order is unspecified).  Compressed expert stacks ({m_packed, C} with a
leading expert axis) go through ``quantized.apply_compressed``: the grouped
kernel K4 when it is registered, the grouped einsum form otherwise.

Under ``sharding.model_parallel`` the router and the routing are computed
alike on every rank (the capacity and the tie order are the reference's),
and a rank runs its box of the experts: its ``E/m`` experts when the
expert dim is on ``model`` (expert parallelism: it dispatches its rows'
tokens to them and combines their outputs), or every expert with its box
of the ``mlp`` dim when the rules put ``model`` there instead.  Either way
the result is this rank's partial sum; the shared expert is a
tensor-parallel ``mlp``.  The balance loss is unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import quantized
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import dp_mean
from repro_torch.models import layers
from repro_torch.models.params import dense_init

__all__ = ["init_moe", "moe_block", "moe_capacity"]

ROUTE_BLOCK = 1024


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    k = max(cfg.experts_per_token, 1)
    cap = int(cfg.capacity_factor * tokens_per_group * k / max(cfg.num_experts, 1))
    return max(cap, 1)


def init_moe(generator, cfg: ModelConfig, dtype) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(generator, (d, E), ("embed", None), torch.float32),
        "gate": dense_init(generator, (E, d, ff), ("experts", "embed", "mlp"), dtype),
        "up": dense_init(generator, (E, d, ff), ("experts", "embed", "mlp"), dtype),
        "down": dense_init(generator, (E, ff, d), ("experts", "mlp", "embed"), dtype),
    }
    if cfg.moe_shared_expert:
        p["shared"] = layers.init_mlp(generator, d, ff, dtype, cfg.use_bias)
    return p


def _expert_linear(x: torch.Tensor, w) -> torch.Tensor:
    """Per-expert linear over the (E, B, C, d_in) dispatch layout: dense
    stacks (E, d_in, d_out) by einsum, compressed ones through
    ``quantized.apply_compressed`` (grouped), int8 ones through
    ``quantized.apply_intquant``."""
    if quantized.is_compressed(w):
        return quantized.apply_compressed(x, w)
    if quantized.is_intquant(w):
        return quantized.apply_intquant(x, w)
    return torch.einsum("ebcd,edf->ebcf", x, w)


def moe_block(h: torch.Tensor, p: dict, cfg: ModelConfig):
    """h (B, S, d) -> (out (B, S, d), aux_loss scalar f32); ``p`` holds
    tensors (``forward`` strips the Params)."""
    B0, S0, d = h.shape
    blk = min(ROUTE_BLOCK, S0)
    while S0 % blk != 0:
        blk //= 2
    h = h.reshape(B0 * (S0 // blk), blk, d)
    B, S, _ = h.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = moe_capacity(cfg, S)

    logits = h.to(torch.float32) @ p["router"].to(torch.float32)          # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = gate_vals[..., :k], expert_idx[..., :k]       # (B, S, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    # one-hot over experts per routing slot (B, S, k, E); a slot's place in
    # its expert's queue counts over the flattened (S*k) slot order.  The
    # count runs along the last axis (a scan along a strided middle axis
    # was 1.4 ms per layer at 4 x 1024 tokens on an H100); sums of 0/1 in
    # f32 are exact in any order
    onehot = F.one_hot(expert_idx, E).to(torch.float32)
    flat = onehot.reshape(B, S * k, E).transpose(1, 2).contiguous()   # (B, E, S*k)
    pos_in_expert = (torch.cumsum(flat, dim=-1) - flat).transpose(1, 2).reshape(B, S, k, E)
    pos = (pos_in_expert * onehot).sum(-1)                                # (B, S, k)
    keep = pos < C
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # dispatch/combine (B, S, E, C); a dropped slot's one-hot row is zero.
    # combine contracts gate x one-hot first: one (b, s, k, e, c) product
    # would be materialised by a three-operand einsum
    pos_oh = (pos.to(torch.int64)[..., None]
              == torch.arange(C, device=h.device)).to(torch.float32)
    dispatch = torch.einsum("bske,bskc->bsec", onehot, pos_oh)
    combine = torch.einsum("bske,bskc->bsec", onehot * gate_vals[..., None], pos_oh)

    tp = tuple(shd.tp_dim(p[n]) for n in ("gate", "up", "down"))
    if tp == (0, 0, 0):
        # expert parallelism: this rank's experts [e0, e0 + El)
        El = p["gate"].shape[0]
        e0 = shd.model_index() * El
        dispatch, combine = dispatch[:, :, e0:e0 + El], combine[:, :, e0:e0 + El]
    elif tp not in ((2, 2, 1), (None, None, None)):
        raise NotImplementedError(f"expert stacks placed unlike each other along model: {tp}")
    xin = torch.einsum("bsec,bsd->ebcd", dispatch.to(h.dtype), h)        # (E, B, C, d)
    act = F.silu(_expert_linear(xin, p["gate"]))
    act = act * _expert_linear(xin, p["up"])
    xout = _expert_linear(act, p["down"])                                # (E, B, C, d)
    out = torch.einsum("bsec,ebcd->bsd", combine.to(h.dtype), xout)
    if tp == (None, None, None):
        out = shd.model_once(out)

    if "shared" in p:
        out = out + layers.mlp(h, p["shared"])

    # Switch load-balance loss
    routed = onehot[..., 0, :] if k == 1 else onehot.amax(dim=2)
    # means over the whole batch: a sharded train step's other ranks' rows too
    frac_routed = dp_mean(routed, (0, 1))
    mean_prob = dp_mean(probs, (0, 1))
    aux = E * torch.sum(frac_routed * mean_prob)
    return out.reshape(B0, S0, d), aux
