"""Shared layers: counterpart of ``repro/models/layers.py``.

Same tree paths, shapes and dtypes as ``repro``.  ``apply_dense`` takes a
dense weight or a compressed ``{m_packed, C}`` one (through
``quantized.apply_compressed``, hence kernel K3 when the hook is set).
``remat`` is the port's ``jax.checkpoint(..., nothing_saveable)``: under
``torch.utils.checkpoint`` a function saves only its inputs for backward
and recomputes the rest.

Under ``sharding.model_parallel`` the layers compute this rank's part of
each product, as the weights' placements give it (``sharding.tp_dim``):
``apply_dense`` is column-parallel on a weight whose output dim is this
rank's box and row-parallel (a partial sum, the bias added once) on one
whose input dim is; ``mlp`` is gate/up column- and down row-parallel and
returns its partial sum; ``embed_lookup`` on a vocab-sharded table is a
masked local lookup (a partial sum); ``chunked_softmax_cross_entropy``
on a vocab-sharded head reduces its max, sum of exponentials and label
logit over ``model``.  Outside it each is the plain layer.

Where the reference computes in f32 (a norm's statistic, RoPE, attention's
softmax, the SSD's state), the port computes in ``f32_or_wider(x)``: f32
for bf16 and f32 inputs, as the reference, and f64 for f64 ones, so the
same forward on f64 weights and inputs is an f64 reference for measuring
the f32 one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core import quantized
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import dp_sum
from repro_torch.models.params import Param, dense_init, param

__all__ = [
    "f32_or_wider",
    "rms_norm",
    "init_rms_norm",
    "apply_dense",
    "init_dense",
    "init_embedding",
    "embed_lookup",
    "init_mlp",
    "mlp",
    "softmax_cross_entropy",
    "chunked_softmax_cross_entropy",
    "remat",
]


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def remat(fn, *args):
    """``fn(*args)``; while autograd records a graph through ``args`` (nested
    dicts of tensors allowed), under ``torch.utils.checkpoint`` without
    reentry, so backward recomputes ``fn``'s intermediates instead of
    keeping them.  The value is the same either way."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in _tensors(args)):
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _value(p):
    return p.value if isinstance(p, Param) else p


def init_rms_norm(d: int, dtype, device) -> dict:
    return {"scale": param(torch.ones((d,), dtype=torch.float32, device=device), ("embed",))}


def f32_or_wider(x: torch.Tensor) -> torch.dtype:
    """f32, or f64 for an f64 ``x`` (module docstring)."""
    return torch.promote_types(x.dtype, torch.float32)


def rms_norm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in f32 (scale f32), cast back to x's dtype."""
    xf = x.to(f32_or_wider(x))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * _value(p["scale"])).to(x.dtype)


def init_dense(generator, d_in: int, d_out: int, axes, dtype, use_bias: bool = False) -> dict:
    p = {"w": dense_init(generator, (d_in, d_out), axes, dtype)}
    if use_bias:
        p["b"] = param(torch.zeros((d_out,), dtype=dtype, device=generator.device), (axes[1],))
    return p


def apply_dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ w (+ b) for a dense, a compressed ``{m_packed, C}`` or an int8
    ``{q, scale}`` weight.  A row-parallel weight (its input dim this
    rank's box along ``model``) takes this rank's box of x's last dim and
    gives a partial sum, to which the bias is added once."""
    w = _value(p["w"])
    if quantized.is_compressed(w):
        y = quantized.apply_compressed(x, w)
    elif quantized.is_intquant(w):
        y = quantized.apply_intquant(x, w)
    else:
        y = x @ w
    if "b" in p:
        b = _value(p["b"])
        if b.shape[-1] < y.shape[-1]:
            b = shd.model_gather(b, -1)     # a compressed (whole) weight's sharded bias
        y = y + (shd.model_once(b) if shd.tp_dim(w) == 0 else b)
    return y


def init_embedding(generator, vocab: int, d: int, dtype) -> dict:
    v = torch.randn((vocab, d), generator=generator, device=generator.device) * d ** -0.5
    return {"table": param(v.to(dtype), ("vocab", "embed"))}


def embed_lookup(tokens: torch.Tensor, p: dict) -> torch.Tensor:
    """The table's rows at ``tokens``; on a vocab-sharded table this rank's
    term of them (its rows, zeros for tokens outside its box)."""
    table = _value(p["table"])
    if shd.tp_dim(table) != 0:
        return table[tokens]
    V = table.shape[0]
    local = tokens - shd.model_index() * V
    inside = (local >= 0) & (local < V)
    return table[local.clamp(0, V - 1)] * inside[..., None].to(table.dtype)


def init_mlp(generator, d: int, d_ff: int, dtype, use_bias: bool = False) -> dict:
    """SwiGLU MLP (gate, up, down)."""
    return {
        "gate": init_dense(generator, d, d_ff, ("embed", "mlp"), dtype, use_bias),
        "up": init_dense(generator, d, d_ff, ("embed", "mlp"), dtype, use_bias),
        "down": init_dense(generator, d_ff, d, ("mlp", "embed"), dtype, use_bias),
    }


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU on a whole x.  Under ``model_parallel``: gate and up
    column-parallel, down row-parallel, and the result this rank's partial
    sum (a weight whole over ``model`` is computed whole and counted once)."""
    g = apply_dense(x, p["gate"])
    u = apply_dense(x, p["up"])
    a = F.silu(g) * u
    col = shd.tp_dim(_value(p["gate"]["w"])) == 1
    row = shd.tp_dim(_value(p["down"]["w"])) == 0
    if col and not row:
        a = shd.model_gather(a, -1)
    elif row and not col:
        a = shd.model_slice(a, -1)
    y = apply_dense(a, p["down"])
    return y if row else shd.model_once(y)


def _ce_terms(logits: torch.Tensor, labels: torch.Tensor, z_loss: float, softcap: float):
    """Per-token CE (+ z-loss) of f32 logits, after the optional softcap."""
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.take_along_dim(logits, labels[..., None].long(), dim=-1)[..., 0]
    ce = lse - picked
    if z_loss > 0.0:
        ce = ce + z_loss * lse ** 2
    return ce


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor,
                          z_loss: float = 0.0, softcap: float = 0.0) -> torch.Tensor:
    """Mean CE over masked tokens, f32, with optional z-loss and softcap.
    logits (..., V) any float dtype; labels (...) int; mask (...) {0, 1}."""
    ce = _ce_terms(logits.to(torch.float32), labels, z_loss, softcap)
    mask = mask.to(torch.float32)
    return torch.sum(ce * mask) / torch.clamp_min(torch.sum(mask), 1.0)


def _ce_terms_sharded(logits: torch.Tensor, labels: torch.Tensor, z_loss: float,
                      softcap: float, start: int):
    """:func:`_ce_terms` of logits whose last dim is this rank's box of the
    vocabulary (from ``start``): the max (a stabiliser, no gradient), the
    sum of exponentials and the label's logit reduced over ``model``."""
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    V = logits.shape[-1]
    m = shd.model_max(logits.detach().amax(dim=-1, keepdim=True))
    m = torch.where(torch.isfinite(m), m, 0.0)
    lse = m[..., 0] + torch.log(shd.model_sum(torch.sum(torch.exp(logits - m), dim=-1)))
    local = labels.long() - start
    inside = (local >= 0) & (local < V)
    picked = torch.take_along_dim(logits, local.clamp(0, V - 1)[..., None], dim=-1)[..., 0]
    ce = lse - shd.model_sum(picked * inside.to(picked.dtype))
    if z_loss > 0.0:
        ce = ce + z_loss * lse ** 2
    return ce


def chunked_softmax_cross_entropy(h: torch.Tensor, head_w: torch.Tensor, labels: torch.Tensor,
                                  mask: torch.Tensor, z_loss: float = 0.0,
                                  softcap: float = 0.0, chunk: int = 512,
                                  vocab_start: int | None = None) -> torch.Tensor:
    """CE from final hidden states h (B, T, d) and the head (d, V), one
    sequence chunk of logits at a time (the (B, T, V) f32 logits are never
    all alive at once, in backward neither: each chunk is under
    :func:`remat`).  The same value as :func:`softmax_cross_entropy` on
    ``h @ head_w``.  ``vocab_start``: the head is this rank's box of the
    vocabulary from there (vocab-parallel over ``model``)."""
    B, T, _ = h.shape
    ck = min(chunk, T)

    def chunk_sum(hs, w, ls, ms):
        logits = (hs @ w).to(torch.float32)
        if vocab_start is None:
            return torch.sum(_ce_terms(logits, ls, z_loss, softcap) * ms)
        return torch.sum(_ce_terms_sharded(logits, ls, z_loss, softcap, vocab_start) * ms)

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for s in range(0, T, ck):
        ms = mask[:, s:s + ck].to(torch.float32)
        # each chunk under remat, as the reference's scan body
        tot = tot + remat(chunk_sum, h[:, s:s + ck], head_w, labels[:, s:s + ck], ms)
        cnt = cnt + torch.sum(ms)
    # over the whole batch: a sharded train step's other ranks' rows too
    return dp_sum(tot) / torch.clamp_min(dp_sum(cnt), 1.0)
