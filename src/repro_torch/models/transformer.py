"""Decoder backbone: counterpart of ``repro/models/transformer.py``.

``init_model`` builds the same parameter tree as ``repro``'s (group
parameters stacked along a leading ``num_groups`` axis, e.g.
``groups/0/attn/wk/w`` of shape (num_groups, d_model, kv_heads*head_dim)),
with weights drawn from a ``torch.Generator``.  ``forward`` runs the groups
in a Python loop (JAX scans them), slicing each group's parameters and
cache out of the stacked trees; compressed ``{m_packed, C}`` leaves slice
the same way: a compressed expert stack (L, E, ...) slices to the grouped
(E, ...) form that ``models/moe.py`` runs through kernel K4.  Every block
kind of ``repro`` is ported: dense attention (both ``parallel_block``
settings), attention + MoE (``attn_moe``), Mamba2 SSD (``ssm``,
``models/ssm.py``) and the hybrid ``ssm_attn``, which runs the SSM and then
zamba2's *shared* attention block: one parameter tree ``p["shared"]``
reused by every invocation, its KV cache per invocation (window-sized, a
ring, once ``max_len`` reaches ``sliding_window``).

Under ``sharding.model_parallel`` the carry between blocks is this rank's
box of the embed dim (the reference's ``hidden`` rule, P(dp, None,
model)), whole where ``model`` does not divide ``d_model``: a block
gathers it before each norm (``_whole``) and adds its attention's, MLP's,
MoE's or SSM's partial sums by a reduce-scatter (``_add``), as the
reference's GSPMD lowering does.  An SSM layer computes its rank's heads
(``ssm.ssm_block``); with a whole (compressed) ``out_proj`` its output is
whole and the carry keeps its box of it.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import generator as make_generator
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import constrain, gather_params
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers, moe, ssm
from repro_torch.models.params import Param

__all__ = ["init_model", "forward", "train_loss", "init_cache", "model_dtype"]

def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _init_block(generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    d, dev = cfg.d_model, generator.device
    if kind in ("ssm", "ssm_attn"):
        return {"norm1": layers.init_rms_norm(d, dtype, dev),
                "ssm": ssm.init_ssm(generator, cfg, dtype)}
    if kind not in ("attn", "attn_moe"):
        raise ValueError(kind)
    p = {
        "norm1": layers.init_rms_norm(d, dtype, dev),
        "attn": attn_lib.init_attention(generator, cfg, dtype),
        "norm2": layers.init_rms_norm(d, dtype, dev),
    }
    if kind == "attn":
        p["mlp"] = layers.init_mlp(generator, d, cfg.d_ff_dense or cfg.d_ff, dtype, cfg.use_bias)
    else:
        p["moe"] = moe.init_moe(generator, cfg, dtype)
    return p


def _init_shared_attn(generator, cfg: ModelConfig, dtype) -> dict:
    d, dev = cfg.d_model, generator.device
    return {
        "norm1": layers.init_rms_norm(d, dtype, dev),
        "attn": attn_lib.init_attention(generator, cfg, dtype),
        "norm2": layers.init_rms_norm(d, dtype, dev),
        "mlp": layers.init_mlp(generator, d, cfg.d_ff, dtype, cfg.use_bias),
    }


def _whole(h, cfg: ModelConfig):
    """The carry made whole along ``model`` (identity when it is)."""
    return shd.model_gather(h, -1) if h.shape[-1] < cfg.d_model else h


def _add(h, cfg: ModelConfig, *ys):
    """The carry plus the partial sums ``ys`` (whole values outside
    ``model_parallel``), in the carry's placement: a reduce-scatter onto a
    split carry, an all-reduce onto a whole one."""
    if shd.model_size() == 1:
        for y in ys:
            h = h + y
        return h
    y = sum(ys[1:], ys[0])
    return h + (shd.model_scatter(y, -1) if h.shape[-1] < cfg.d_model else shd.model_sum(y))


def _apply_block(h, p, kind: str, cfg: ModelConfig, shared=None, *, cache, pos_offset,
                 window, attend_cache=False, unroll=False):
    """Returns (h, new_cache, aux); aux (the MoE balance loss) is 0.0 for
    every block but ``attn_moe``.  With ``parallel_block`` both attention
    kinds run the dense MLP beside attention, as ``repro`` does.
    ``ssm_attn`` runs the SSM, then the shared attention block with the
    ``shared`` parameters.  ``unroll`` takes the costing twin of attention
    (``models/attention.py``).  ``h`` is the carry (module docstring)."""
    aux = 0.0
    kw = dict(pos_offset=pos_offset, window=window, attend_cache=attend_cache, unroll=unroll)
    if kind in ("ssm", "ssm_attn"):
        sc = cache["ssm"] if cache is not None else None
        s, new_sc = ssm.ssm_block(layers.rms_norm(_whole(h, cfg), p["norm1"], cfg.norm_eps),
                                  p["ssm"], cfg, cache=sc, unroll=unroll)
        if shd.tp_dim(layers._value(p["ssm"]["out_proj"]["w"])) == 0:
            h = _add(h, cfg, s)           # a row-parallel out_proj's partial sum
        else:
            h = h + (shd.model_slice(s, -1) if h.shape[-1] < cfg.d_model else s)
        new_cache = {"ssm": new_sc} if cache is not None else None
        if kind == "ssm_attn":
            kv = cache["kv"] if cache is not None else None
            a, new_kv = attn_lib.attention(
                layers.rms_norm(_whole(h, cfg), shared["norm1"], cfg.norm_eps), shared["attn"],
                cfg, cache=kv, **kw,
            )
            h = _add(h, cfg, a)
            h = _add(h, cfg, layers.mlp(layers.rms_norm(_whole(h, cfg), shared["norm2"],
                                                        cfg.norm_eps), shared["mlp"]))
            if cache is not None:
                new_cache["kv"] = new_kv
        return h, new_cache, aux
    if kind not in ("attn", "attn_moe"):
        raise ValueError(kind)
    kw["cache"] = cache["kv"] if cache is not None else None
    if cfg.parallel_block:
        n = layers.rms_norm(_whole(h, cfg), p["norm1"], cfg.norm_eps)
        a, new_kv = attn_lib.attention(n, p["attn"], cfg, **kw)
        h = _add(h, cfg, a, layers.mlp(n, p["mlp"]))
    else:
        a, new_kv = attn_lib.attention(
            layers.rms_norm(_whole(h, cfg), p["norm1"], cfg.norm_eps), p["attn"], cfg, **kw
        )
        h = _add(h, cfg, a)
        n = layers.rms_norm(_whole(h, cfg), p["norm2"], cfg.norm_eps)
        if kind == "attn":
            h = _add(h, cfg, layers.mlp(n, p["mlp"]))
        else:
            mo, aux = moe.moe_block(n, p["moe"], cfg)
            h = _add(h, cfg, mo)
    return h, ({"kv": new_kv} if cache is not None else None), aux


def _apply_group(h, gp, cfg: ModelConfig, shared=None, *, cache, pos_offset, window,
                 attend_cache=False, unroll=False):
    aux = 0.0
    new_cache = {} if cache is not None else None
    for i, kind in enumerate(cfg.block_pattern):
        key = f"{i}"
        h, nc, a = _apply_block(
            h, gp[key], kind, cfg, shared, cache=None if cache is None else cache[key],
            pos_offset=pos_offset, window=window, attend_cache=attend_cache, unroll=unroll,
        )
        if cache is not None:
            new_cache[key] = nc
        aux = aux + a
    return h, new_cache, aux


# ---------------------------------------------------------------------------
# Model init
# ---------------------------------------------------------------------------

def _stack(trees):
    """Stack identically-structured Param trees along a new leading axis."""
    first = trees[0]
    if isinstance(first, Param):
        return Param(torch.stack([t.value for t in trees]), (None,) + first.axes)
    return {k: _stack([t[k] for t in trees]) for k in first}


def init_model(cfg: ModelConfig, *, seed: int = 0, device=None):
    """A Param tree (values + logical axes; use ``params.split``) on
    ``device`` (default: the GPU)."""
    device = resolve_device(device)
    dtype = model_dtype(cfg)
    g = make_generator(device, seed)
    groups = _stack([
        {f"{i}": _init_block(g, kind, cfg, dtype) for i, kind in enumerate(cfg.block_pattern)}
        for _ in range(cfg.num_groups)
    ])
    p = {
        "embed": layers.init_embedding(g, cfg.vocab_size, cfg.d_model, dtype),
        "groups": groups,
        "final_norm": layers.init_rms_norm(cfg.d_model, dtype, device),
    }
    if cfg.remainder_pattern:
        p["rem"] = {
            f"{i}": _init_block(g, kind, cfg, dtype)
            for i, kind in enumerate(cfg.remainder_pattern)
        }
    if cfg.shared_attn:
        p["shared"] = _init_shared_attn(g, cfg, dtype)
    if not cfg.tie_embeddings:
        p["head"] = layers.init_dense(g, cfg.d_model, cfg.vocab_size, ("embed", "vocab"), dtype)
    return p


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _init_block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    c = {}
    if kind in ("attn", "attn_moe"):
        c["kv"] = attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device)
    if kind in ("ssm", "ssm_attn"):
        c["ssm"] = ssm.init_ssm_cache(cfg, batch, dtype, device)
    if kind == "ssm_attn":
        kv_len = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
        c["kv"] = attn_lib.init_kv_cache(cfg, batch, kv_len, dtype, device)
    return c


def init_cache(cfg: ModelConfig, batch: int, max_len: int, stacked: bool = True, device=None):
    """Decode cache tree on ``device`` (default: the GPU).  ``stacked=True``
    packs the per-group caches into (G, ...) tensors, as the JAX scan
    carries them; ``stacked=False`` keeps a list of per-group caches."""
    device = resolve_device(device)
    dtype = model_dtype(cfg)
    G = cfg.num_groups

    def one(dev):
        return {
            f"{i}": _init_block_cache(kind, cfg, batch, max_len, dtype, dev)
            for i, kind in enumerate(cfg.block_pattern)
        }

    def stack(tree):
        if isinstance(tree, dict):
            return {k: stack(v) for k, v in tree.items()}
        return torch.zeros((G,) + tuple(tree.shape), dtype=tree.dtype, device=device)

    groups = stack(one("meta")) if stacked else [one(device) for _ in range(G)]
    cache = {"groups": groups}
    if cfg.remainder_pattern:
        cache["rem"] = {
            f"{i}": _init_block_cache(kind, cfg, batch, max_len, dtype, device)
            for i, kind in enumerate(cfg.remainder_pattern)
        }
    return cache


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _values(tree):
    if isinstance(tree, Param):
        return tree.value
    if isinstance(tree, dict):
        return {k: _values(v) for k, v in tree.items()}
    return tree


def _index(tree, g: int):
    """Slice index ``g`` of the leading axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def forward(
    params,
    inputs,
    cfg: ModelConfig,
    *,
    cache=None,
    pos_offset=0,
    window: int | None = None,
    last_only: bool = False,
    return_hidden: bool = False,
    attend_cache: bool = False,
    unroll: bool = False,
):
    """inputs: {"tokens": (B, S) int} or {"embeds": (B, S, d)}.
    Returns (logits (B, S, V), new_cache, aux_loss).  ``last_only`` computes
    logits for the final position only; ``return_hidden`` skips the head and
    returns the post-final-norm hidden states.  A given cache is written in
    place (see ``models/attention.py``) and returned; both cache forms of
    ``init_cache`` are accepted.  ``unroll`` runs the costing twins
    (``launch/costing.py``): attention's block loop as the reference's twin
    walks it, under the same remat as the production loop.

    The ``constrain`` points are the reference's but the one after each
    group, where the blocks keep the carry in the ``hidden`` placement: a
    DTensor is redistributed there, and under ``model_parallel`` a whole
    activation is cut to this rank's box (``distributed.sharding.
    constrain``), so there the logits are this rank's box of the vocabulary
    when ``model`` divides it (the ``logits`` rule).  ``gather_params``
    gives a sharded step the weights for its rank's compute, one group at a
    time, and is the identity elsewhere."""
    p = _values(params)
    # a sharded step's weights for this rank (identity elsewhere): the top
    # level's here, each group's and remainder layer's inside its remat
    p = {k: v if k in ("groups", "rem") else gather_params(v, k) for k, v in p.items()}
    dtype = model_dtype(cfg)

    if "tokens" in inputs:
        h = layers.embed_lookup(inputs["tokens"], p["embed"]).to(dtype)
        if shd.tp_dim(p["embed"]["table"]) == 0:
            # a vocab-sharded table gives this rank's term of the embedding
            h = shd.model_scatter(h, -1) if cfg.d_model % shd.model_size() == 0 \
                else shd.model_sum(h)
        else:
            h = constrain(h, "hidden")
    else:
        h = constrain(inputs["embeds"].to(dtype), "hidden")
    window = cfg.sliding_window if window is None else window
    shared = p.get("shared")
    kw = dict(pos_offset=pos_offset, window=window, attend_cache=attend_cache, unroll=unroll)

    # remat per group and per remainder layer, as the reference's
    # jax.checkpoint around its scan body and its remainder blocks
    remat = cfg.remat and cache is None

    def group_fn(h_, gp_, shared_):
        return _apply_group(h_, gather_params(gp_, "groups", stacked=True), cfg, shared_,
                            cache=None, **kw)

    aux_total = 0.0
    gcache = cache["groups"] if cache is not None else None
    cache_is_list = isinstance(gcache, list)
    new_groups = [] if cache is not None else None
    for g in range(cfg.num_groups):
        gp = _index(p["groups"], g)
        if remat:
            h, nc, aux = layers.remat(group_fn, h, gp, shared)
        else:
            gc = None
            if gcache is not None:
                gc = gcache[g] if cache_is_list else _index(gcache, g)
            h, nc, aux = _apply_group(h, gather_params(gp, "groups", stacked=True), cfg,
                                      shared, cache=gc, **kw)
        aux_total = aux_total + aux
        if cache is not None:
            new_groups.append(nc)
    if cache is not None and not cache_is_list:
        new_groups = gcache      # the per-group slices were written in place
    new_cache = {"groups": new_groups} if cache is not None else None

    if cfg.remainder_pattern:
        rcache = cache["rem"] if cache is not None else None
        new_rem = {}
        for i, kind in enumerate(cfg.remainder_pattern):
            if remat:
                h, nc, aux = layers.remat(
                    lambda h_, bp_, sh_, kind=kind, i=i: _apply_block(
                        h_, gather_params(bp_, f"rem/{i}"), kind, cfg, sh_, cache=None, **kw),
                    h, p["rem"][f"{i}"], shared,
                )
            else:
                h, nc, aux = _apply_block(
                    h, gather_params(p["rem"][f"{i}"], f"rem/{i}"), kind, cfg, shared,
                    cache=None if rcache is None else rcache[f"{i}"], **kw,
                )
            aux_total = aux_total + aux
            if nc is not None:
                new_rem[f"{i}"] = nc
        if cache is not None:
            new_cache["rem"] = new_rem

    if last_only:
        h = h[:, -1:]
    h = layers.rms_norm(_whole(h, cfg), p["final_norm"], cfg.norm_eps)
    if return_hidden:
        return h, new_cache, aux_total
    if cfg.tie_embeddings:
        w = p["embed"]["table"]
        logits = h @ w.T
        vocab_box = shd.tp_dim(w) == 0
    else:
        logits = layers.apply_dense(h, p["head"])
        vocab_box = shd.tp_dim(p["head"]["w"]) == 1
    if cfg.logits_softcap > 0:
        logits = cfg.logits_softcap * torch.tanh(logits / cfg.logits_softcap)
    if not vocab_box:
        logits = constrain(logits, "logits")
    return logits, new_cache, aux_total


def train_loss(params, batch, cfg: ModelConfig, *, unroll: bool = False):
    """Next-token CE (+ z-loss) + 0.01 x the MoE balance loss; returns
    (loss, metrics).  The CE is computed from the hidden states one sequence
    chunk at a time (``layers.chunked_softmax_cross_entropy``), so the (B,
    S, V) logits are never all alive.  ``batch`` holds ``tokens`` (targets
    are the next tokens) or ``embeds`` with ``labels``, and an optional
    ``loss_mask``."""
    h, _, aux = forward(params, batch, cfg, return_hidden=True, unroll=unroll)
    p = _values(params)
    if cfg.tie_embeddings:
        w = gather_params(p["embed"], "embed")["table"]
        head_w, vocab_dim = w.T, 0
    else:
        w = head_w = gather_params(p["head"], "head")["w"]
        vocab_dim = 1
    # a vocab-sharded head: this rank's box of the vocabulary
    start = shd.model_index() * head_w.shape[1] if shd.tp_dim(w) == vocab_dim else None
    if "labels" in batch:
        labels, hh = batch["labels"], h
    else:
        labels, hh = batch["tokens"][:, 1:], h[:, :-1]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=h.device)
    elif "labels" not in batch:
        mask = mask[:, 1:]
    ce = layers.chunked_softmax_cross_entropy(hh, head_w, labels, mask, cfg.z_loss,
                                              cfg.logits_softcap, vocab_start=start)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux, "loss": loss}
