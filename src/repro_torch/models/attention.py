"""GQA attention with RoPE, optional qk-norm, sliding window and KV cache.

Counterpart of ``repro/models/attention.py``.  Paths:
  * prefill: with a flash hook registered (``kernels.ops.enable_kernels``)
    the whole causal attention runs through kernel K5 (which has no
    backward, as the Pallas kernel has none); without one, the plain
    chunked online-softmax loop ``_chunked_attention``, under
    ``layers.remat`` while autograd records (training's path, as the
    reference's trainer runs it);
  * decode: one query per row against the cache (plain softmax);
  * chunked prefill (``attend_cache``): a chunk's queries against the full
    cache.

Unlike the JAX layer, the cache is written in place (slice assignment and
``copy_``), so a cache tree passed in is updated; it is still returned.
Flash-decode: under installed activation rules
(``distributed.sharding.activation_rules``) whose ``decode_sp_axis`` has
more than one rank and divides the cache, ``_decode_attention`` computes
each rank's partial softmax statistics over its slice of the cache's
sequence and combines them with all-reduces (MAX, then SUM) over that mesh
axis, as the reference's ``shard_map`` branch does with pmax/psum; plain
torch and collectives, as in JAX no Pallas kernel.  A cache whose k/v
are such DTensors is written in place too: each rank writes the positions
that fall in its slice (``_write_cache``).

Under ``sharding.model_parallel`` (tensor parallelism over ``model``) a
rank computes its own q heads (``wq``'s box) and the kv heads they read:
its box of ``wk``/``wv`` when that box is exactly those heads, else the
whole kv projection gathered over ``model`` (a box smaller than a head, as
qwen3-32b's 8 kv heads on 16 ranks give, or a cache to write, which holds
every kv head) and those heads taken from it.  qk-norm and RoPE act per
head; prefill runs its heads alone (kernel K5 at the rank's heads when
registered); decode gathers q's heads over ``model`` for flash-decode over
the sequence-sharded cache, as the reference's ``shard_map`` branch runs
every head, and keeps its heads after.  ``wo`` is row-parallel: the result
is this rank's partial sum.

The costing twin ``_chunked_attention_unrolled`` (``unroll=True``, taken
before any flash hook, as the reference checks ``unroll`` first) walks the
reference's block pairs: every pair, or with ``CAUSAL_SKIP_UNROLL`` the
causal lower triangle from the twin's own lower bound.  The port's loops
are eager Python, so the twin changes which pairs are visited, not how
they are counted; unlike the reference's twin it runs under the same
``layers.remat`` as the production loop, so a costed train step recomputes
the attention core in backward exactly as the trained one does
(ROADMAP.md Queue 3).
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.params import param

__all__ = ["init_attention", "attention", "init_kv_cache", "register_flash", "clear_flash"]

# Hook set by repro_torch.kernels.ops.enable_kernels():
# fn(q (B, S, KV, rep, hd), k, v (B, S, KV, hd), window) -> (B, S, KV, rep, hd)
_FLASH_IMPL = None

# Costing toggle: False makes the costing twin visit ALL (q, kv) block pairs,
# as the training loop does (masked blocks included); True costs the
# causal-block-skipping variant (launch/costing.py sets it per cell).
CAUSAL_SKIP_UNROLL = False

# q/kv chunk of the plain prefill loop and the twin; the costing overrides
# it at long sequences (launch/costing.py)
Q_CHUNK_DEFAULT = 512


def register_flash(fn) -> None:
    global _FLASH_IMPL
    _FLASH_IMPL = fn


def clear_flash() -> None:
    global _FLASH_IMPL
    _FLASH_IMPL = None


def init_attention(generator, cfg: ModelConfig, dtype) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    p = {
        "wq": layers.init_dense(generator, d, H * hd, ("embed", "heads"), dtype, cfg.use_bias),
        "wk": layers.init_dense(generator, d, KV * hd, ("embed", "kv"), dtype, cfg.use_bias),
        "wv": layers.init_dense(generator, d, KV * hd, ("embed", "kv"), dtype, cfg.use_bias),
        "wo": layers.init_dense(generator, H * hd, d, ("heads", "embed"), dtype, cfg.use_bias),
    }
    if cfg.qk_norm:
        ones = lambda: torch.ones((hd,), dtype=torch.float32, device=generator.device)  # noqa: E731
        p["q_norm"] = {"scale": param(ones(), (None,))}
        p["k_norm"] = {"scale": param(ones(), (None,))}
    return p


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Half-split RoPE in f32.  x (B, S, H, hd), positions (S,) or (B, S)."""
    half = x.shape[-1] // 2
    f = layers.f32_or_wider(x)
    freqs = theta ** (-torch.arange(0, half, dtype=f, device=x.device) / half)
    ang = positions[..., None].to(f) * freqs
    ang = ang[None, :, None, :] if ang.ndim == 2 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(f), x[..., half:].to(f)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _head_rms(x: torch.Tensor, scale, eps: float) -> torch.Tensor:
    return layers.rms_norm(x, {"scale": scale}, eps)


def _chunked_attention(q, k, v, window: int, q_chunk: int, causal_skip: bool = False):
    """Causal (optionally sliding-window) online-softmax attention over
    q/kv chunks.  q (B, S, KV, rep, hd), k/v (B, S, KV, hd).

    ``causal_skip=True`` visits only the kv chunks a query chunk can see
    (from the window's first to the diagonal); otherwise every chunk is
    visited and the masked ones contribute nothing.  Both give the same
    result."""
    B, S, KV, rep, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    nq = max(S // q_chunk, 1)
    qc = S // nq
    ar = torch.arange(qc, device=q.device)
    f = layers.f32_or_wider(q)
    outs = []
    for i in range(nq):
        qb = q[:, i * qc:(i + 1) * qc]
        q_pos = i * qc + ar
        m = torch.full((B, KV, rep, qc), float("-inf"), dtype=f, device=q.device)
        l = torch.zeros((B, KV, rep, qc), dtype=f, device=q.device)
        acc = torch.zeros((B, KV, rep, qc, hd), dtype=f, device=q.device)
        if causal_skip:
            j_lo = 0 if window <= 0 else max((i * qc - (window - 1)) // qc, 0)
            blocks = range(j_lo, i + 1)
        else:
            blocks = range(nq)
        for j in blocks:
            kj, vj = k[:, j * qc:(j + 1) * qc], v[:, j * qc:(j + 1) * qc]
            k_pos = j * qc + ar
            s = torch.einsum("bqgrh,bkgh->bgrqk", qb, kj).to(f) * scale
            mask = q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (m_new = -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p.to(qb.dtype), vj
            ).to(f)
            m = m_new
        outs.append((acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype))
    o = torch.stack(outs)                       # (nq, B, KV, rep, qc, hd)
    return o.permute(1, 0, 4, 2, 3, 5).reshape(B, S, KV, rep, hd)


def _chunked_attention_unrolled(q, k, v, window: int, q_chunk: int):
    """Costing twin of :func:`_chunked_attention` (the reference's, block
    for block): the same math over every (q, kv) block pair, or with
    ``CAUSAL_SKIP_UNROLL`` over the causal lower triangle from the twin's
    lower bound ``(i*qc - (window-1) - qc + 1) // qc``, which is the
    reference twin's, one block below the production loop's."""
    B, S, KV, rep, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    nq = max(S // q_chunk, 1)
    qc = S // nq
    ar = torch.arange(qc, device=q.device)
    outs = []
    for i in range(nq):
        qb = q[:, i * qc:(i + 1) * qc]
        m = torch.full((B, KV, rep, qc), float("-inf"), dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, rep, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, rep, qc, hd), dtype=torch.float32, device=q.device)
        if CAUSAL_SKIP_UNROLL:
            j_lo = 0 if window <= 0 else max(0, (i * qc - (window - 1) - qc + 1) // qc)
            j_range = range(j_lo, i + 1)
        else:
            j_range = range(nq)
        for j in j_range:
            kj, vj = k[:, j * qc:(j + 1) * qc], v[:, j * qc:(j + 1) * qc]
            s = torch.einsum("bqgrh,bkgh->bgrqk", qb, kj).to(torch.float32) * scale
            q_pos = i * qc + ar
            k_pos = j * qc + ar
            mask = q_pos[:, None] >= k_pos[None, :]
            if window > 0:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = s.masked_fill(~mask, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bkgh->bgrqh", p.to(qb.dtype), vj
            ).to(torch.float32)
            m = m_new
        out = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))       # (B, qc, KV, rep, hd)
    return torch.cat(outs, dim=1)


def _mask(s, valid):
    vb = valid[:, None, None, :] if valid.ndim == 2 else valid[None, None, None]
    return s.masked_fill(~vb, float("-inf"))


def _decode_attention(qh, ck, cv, valid, scale: float, out_dtype):
    """One query per row against the cache.  qh (B, KV, rep, hd), ck/cv
    (B, Smax, KV, hd); ``valid`` (Smax,) for one position or (B, Smax) per
    row.

    Flash-decode (module docstring) when the installed rules allow it: the
    cache may then be whole on every rank (each takes its slice) or
    DTensors sequence-sharded over the axis (``serving.engine.
    cache_shardings``), whose rows are this rank's, as are the result's;
    ``qh`` is whole or a DTensor of those rows."""
    axis, dp, mesh = shd.current_rule("decode_sp_axis"), shd.current_rule("dp_axes"), \
        shd.current_mesh()
    B, Smax = ck.shape[0], ck.shape[1]      # the cache's rows: all of them for a DTensor
    if axis is not None and mesh is not None:
        sizes = shd.mesh_shape(mesh)
        ax = sizes.get(axis, 0)
        dp_size = math.prod(sizes.get(a, 1) for a in (dp or ()))
        if ax > 1 and Smax % ax == 0 and B % max(dp_size, 1) == 0:
            return _flash_decode(qh, ck, cv, valid, scale, out_dtype, mesh, axis, ax)
        qh, ck, cv = (shd.full_value(x) for x in (qh, ck, cv))
    if shd.is_dtensor(ck):
        # no flash-decode axis (``dp_includes_model``): this rank's rows of
        # the cache, its sequence gathered
        ck, cv = (shd.rows_whole(x, 0) for x in (ck, cv))
    s = _mask(torch.einsum("bgrh,bkgh->bgrk", qh, ck).to(torch.float32) * scale, valid)
    w = torch.softmax(s, dim=-1).to(out_dtype)
    return torch.einsum("bgrk,bkgh->bgrh", w, cv)


def _flash_decode(qh, ck, cv, valid, scale, out_dtype, mesh, axis, ax):
    import torch.distributed as dist


    idx, _ = shd.axes_index(mesh, (axis,))
    group = shd.axes_group(mesh, (axis,))
    L = ck.shape[1] // ax
    cols = slice(idx * L, (idx + 1) * L)
    if shd.is_dtensor(ck):
        rows, seq = shd.dtensor_box(ck)[:2]
        if seq != cols:
            raise ValueError(f"flash-decode: the cache's shard {seq} is not this rank's "
                             f"slice {cols} of the sequence over {axis!r}")
        k, v = ck.to_local(), cv.to_local()
    else:
        rows = slice(0, ck.shape[0])
        k, v = ck[:, cols], cv[:, cols]
    q = shd.local_value(qh)
    val = valid[rows, cols] if valid.ndim == 2 else valid[cols]

    s = _mask(torch.einsum("bgrh,bkgh->bgrk", q, k).to(torch.float32) * scale, val)
    m = torch.amax(s, dim=-1, keepdim=True)
    g_m = m.clone()
    dist.all_reduce(g_m, op=dist.ReduceOp.MAX, group=group)
    finite = torch.isfinite(m)
    c = torch.where(finite, torch.exp(m - g_m), 0.0)[..., 0]
    p = torch.where(torch.isfinite(s), torch.exp(s - torch.where(finite, m, 0.0)), 0.0)
    num = torch.einsum("bgrk,bkgh->bgrh", p.to(v.dtype), v).to(torch.float32) * c[..., None]
    den = torch.sum(p, dim=-1) * c
    dist.all_reduce(num, group=group)
    dist.all_reduce(den, group=group)
    return (num / torch.clamp_min(den, 1e-30)[..., None]).to(out_dtype)


def _chunk_cache_attention(qh, ck, cv, qpos, window: int, scale: float, out_dtype):
    """A chunk's queries qh (B, S, KV, rep, hd) at absolute positions
    ``qpos`` ((S,) or (B, S)) against the full updated cache (B, Smax, KV,
    hd)."""
    Smax = ck.shape[1]
    s = torch.einsum("bqgrh,bkgh->bgrqk", qh, ck).to(torch.float32) * scale
    kpos = torch.arange(Smax, device=qh.device)
    qp = qpos if qpos.ndim == 2 else qpos[None]
    mask = kpos[None, None, :] <= qp[:, :, None]              # (B|1, S, Smax)
    if window > 0:
        mask &= kpos[None, None, :] > qp[:, :, None] - window
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    w = torch.softmax(s, dim=-1).to(cv.dtype)
    return torch.einsum("bgrqk,bkgh->bqgrh", w, cv).to(out_dtype)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> dict:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
    }


def _slots(pos_offset: int, S: int, cache_len: int, ring: bool) -> list:
    """[(first token, first slot, count)]: the runs of slots that a write of
    S tokens from one start position fills, as ``_write_cache`` places them
    in a whole cache."""
    if not (ring and S >= cache_len):
        wp = pos_offset % cache_len if ring else pos_offset
        return [(0, min(max(wp, 0), cache_len - S), S)]
    # only the last cache_len tokens land: token t in slot (pos + t) % cache_len
    runs, t = [], S - cache_len
    while t < S:
        slot = (pos_offset + t) % cache_len
        n = min(S - t, cache_len - slot)
        runs.append((t, slot, n))
        t += n
    return runs


def _write_sharded_cache(ck, cv, k, v, pos_offset: int, ring: bool):
    """A DTensor cache sharded over its rows and sequence: this rank writes
    the positions of its rows that fall in its sequence slice."""

    rows, seq = shd.dtensor_box(ck)[:2]
    if k.shape[0] != rows.stop - rows.start:
        raise ValueError(f"cache write: {k.shape[0]} rows of k for this rank's {rows} of the "
                         "cache")
    lk, lv = ck.to_local(), cv.to_local()
    for t, slot, n in _slots(pos_offset, k.shape[1], ck.shape[1], ring):
        lo, hi = max(slot, seq.start), min(slot + n, seq.stop)
        if lo < hi:
            src = slice(t + lo - slot, t + hi - slot)
            lk[:, lo - seq.start:hi - seq.start] = k[:, src]
            lv[:, lo - seq.start:hi - seq.start] = v[:, src]
    return {"k": ck, "v": cv}


def _write_cache(cache, k, v, pos_offset, pos_is_vec: bool, ring: bool):
    """Write this call's k/v into the cache in place (JAX writes a new one);
    start positions clamp so the slice fits, as dynamic_update_slice does."""

    ck, cv = cache["k"], cache["v"]
    B, S = k.shape[:2]
    cache_len = ck.shape[1]
    if shd.is_dtensor(ck):
        if pos_is_vec:
            raise NotImplementedError("a sharded cache takes one start position for all rows")
        return _write_sharded_cache(ck, cv, k, v, pos_offset, ring)
    if pos_is_vec:
        if ring and S > 1:
            raise NotImplementedError(
                "vector pos_offset with a ring (window-sized) cache is decode-only (S == 1)"
            )
        wp = torch.remainder(pos_offset, cache_len) if ring else pos_offset
        idx = wp.clamp(0, cache_len - S)[:, None] + torch.arange(S, device=k.device)
        rows = torch.arange(B, device=k.device)[:, None]
        ck[rows, idx] = k
        cv[rows, idx] = v
    elif ring and S >= cache_len:
        # only the last `window` tokens matter: token pos_offset + t lands in
        # ring slot (pos_offset + t) % window
        roll = (pos_offset + (S - cache_len)) % cache_len
        ck.copy_(torch.roll(k[:, -cache_len:], roll, dims=1))
        cv.copy_(torch.roll(v[:, -cache_len:], roll, dims=1))
    else:
        wp = pos_offset % cache_len if ring else pos_offset
        wp = min(max(wp, 0), cache_len - S)
        ck[:, wp:wp + S] = k
        cv[:, wp:wp + S] = v
    return {"k": ck, "v": cv}


def attention(
    h: torch.Tensor,
    p: dict,
    cfg: ModelConfig,
    *,
    pos_offset=0,
    cache: dict | None = None,
    window: int | None = None,
    q_chunk: int | None = None,
    attend_cache: bool = False,
    unroll: bool = False,
):
    """Returns (out, new_cache).  Modes:
      cache is None              -> prefill without a cache
      cache given, S == 1        -> decode step at position pos_offset
      cache given, S > 1         -> prefill writing the cache; with
                                    ``attend_cache=True`` the chunk's queries
                                    attend to the full cache (continuation
                                    chunks of a chunked prefill), otherwise
                                    chunk-local causal attention

    ``pos_offset`` is an int (every row at the same position) or a (B,)
    tensor of per-row positions.  A cache exactly ``window`` long on a
    sliding-window layer is a ring buffer.  ``unroll`` runs the costing
    twin in place of the prefill loop and of any flash hook."""
    B, S, _ = h.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rep = H // KV
    window = cfg.sliding_window if window is None else window
    q_chunk = Q_CHUNK_DEFAULT if q_chunk is None else q_chunk
    scale = 1.0 / math.sqrt(hd)

    # this rank's q heads [h0, h0 + Hl) and the kv heads they read; a box of
    # wq that splits a head (24 heads of 64 on 16 ranks) computes every head
    q = layers.apply_dense(h, p["wq"])
    if q.shape[-1] % hd:
        q = shd.model_gather(q, -1)
    Hl = q.shape[-1] // hd
    h0 = shd.model_index() * Hl if Hl < H else 0
    kv0, nkv, kv_idx = _kv_heads(h0, Hl, rep)
    k = layers.apply_dense(h, p["wk"])
    v = layers.apply_dense(h, p["wv"])
    if k.shape[-1] < KV * hd:
        own = k.shape[-1] // hd
        exact = k.shape[-1] % hd == 0 and kv_idx is None and own == nkv \
            and shd.model_index() * own == kv0
        if cache is not None or not exact:
            k, v = shd.model_gather(k, -1), shd.model_gather(v, -1)
    q = q.reshape(B, S, Hl, hd)
    k = k.reshape(B, S, k.shape[-1] // hd, hd)
    v = v.reshape(B, S, v.shape[-1] // hd, hd)
    if cfg.qk_norm:
        q = _head_rms(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = _head_rms(k, p["k_norm"]["scale"], cfg.norm_eps)

    pos_is_vec = isinstance(pos_offset, torch.Tensor) and pos_offset.ndim == 1
    ar = torch.arange(S, device=h.device)
    if pos_is_vec:
        positions = pos_offset[:, None] + ar                  # (B, S)
    else:
        pos_offset = int(pos_offset)
        positions = pos_offset + ar                           # (S,)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)

    cache_len = cache["k"].shape[1] if cache is not None else 0
    ring = cache is not None and window > 0 and cache_len == window
    new_cache = cache
    if cache is not None:
        new_cache = _write_cache(cache, k, v, pos_offset, pos_is_vec, ring)

    def mine(x):
        """The kv heads this rank's q heads read, of a whole (all-head) x."""
        if x.shape[2] == nkv and kv_idx is None:
            return x
        return x[:, :, kv0:kv0 + nkv] if kv_idx is None else x[:, :, kv_idx.to(x.device)]

    rep_l = Hl // nkv
    if S == 1 and cache is not None:
        ck, cv = new_cache["k"], new_cache["v"]
        kpos = torch.arange(ck.shape[1], device=h.device)
        pb = pos_offset[:, None] if pos_is_vec else pos_offset
        valid = kpos <= pb
        if ring:
            # entries are the last `window` tokens by construction; only the
            # not-yet-written slots (pos < cache_len) are invalid
            valid = valid | (pb >= cache_len)
        elif window > 0:
            valid &= kpos > pb - window
        # every head, as the cache holds them: flash-decode combines over
        # the cache's sequence slices
        qa = shd.model_gather(q.reshape(B, Hl * hd), -1) if Hl < H else q.reshape(B, H * hd)
        o = _decode_attention(qa.reshape(B, KV, rep, hd), ck, cv, valid, scale, h.dtype)
        o = o.reshape(B, 1, H * hd)
        if Hl < H:
            o = shd.model_slice(o, -1)
    elif cache is not None and attend_cache:
        o = _chunk_cache_attention(
            q.reshape(B, S, nkv, rep_l, hd), mine(new_cache["k"]), mine(new_cache["v"]),
            positions, window, scale, h.dtype,
        )
        o = o.reshape(B, S, Hl * hd)
    else:
        qh = q.reshape(B, S, nkv, rep_l, hd)
        k, v = mine(k), mine(v)
        if unroll:
            o = layers.remat(functools.partial(
                _chunked_attention_unrolled, window=window, q_chunk=q_chunk), qh, k, v)
        elif _FLASH_IMPL is not None:
            o = _FLASH_IMPL(qh, k, v, window)
        else:
            # under remat while autograd records, as the reference checkpoints
            # it: backward recomputes each chunk's f32 scores
            o = layers.remat(functools.partial(
                _chunked_attention, window=window, q_chunk=q_chunk, causal_skip=cache is not None,
            ), qh, k, v)
        o = o.reshape(B, S, Hl * hd)
    return _out_proj(o, p["wo"], H * hd), new_cache


def _kv_heads(h0: int, Hl: int, rep: int):
    """(first kv head, count, index or None) read by q heads [h0, h0 + Hl):
    a contiguous run of kv heads, each read by Hl / count consecutive q
    heads, or else ``index`` (one kv head per q head, as a tensor)."""
    first, last = h0 // rep, (h0 + Hl - 1) // rep
    n = last - first + 1
    if n == 1 or (h0 % rep == 0 and Hl % rep == 0):
        return first, n, None
    if Hl % n == 0 and all((h0 + j) // rep - first == j // (Hl // n) for j in range(Hl)):
        return first, n, None
    return first, Hl, torch.tensor([(h0 + j) // rep for j in range(Hl)])


def _out_proj(o, wo: dict, width: int):
    """``o @ wo``: row-parallel (a partial sum) when ``wo``'s input dim is
    this rank's box along ``model``; a whole product counted once else."""
    row = shd.tp_dim(layers._value(wo["w"])) == 0
    if row and o.shape[-1] == width:
        o = shd.model_slice(o, -1)
    elif not row and o.shape[-1] < width:
        o = shd.model_gather(o, -1)
    y = layers.apply_dense(o, wo)
    return y if row else shd.model_once(y)
