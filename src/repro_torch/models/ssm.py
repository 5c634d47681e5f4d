"""Mamba2 / SSD (state-space duality) sequence-mixing block.

Counterpart of ``repro/models/ssm.py``: the same parameter tree (paths
``.../ssm/in_proj/w``, ``conv_w``, ``conv_b``, ``A_log``, ``D``,
``dt_bias``, ``norm/scale``, ``out_proj/w``), shapes and dtypes, and the
same arithmetic with every cast of the reference kept, since in bf16 each
one changes bits.  The chunked SSD: the sequence splits into chunks of
length L; within a chunk the recurrence is a masked attention-like product,
across chunks one per-head state (B, nh, hp, ds) is carried.  Decode carries
(conv window, SSD state) and is O(1) per token.

The SSD contractions are plain PyTorch (``einsum``): the JAX package
computes them outside any Pallas kernel.  The compressed ``in_proj`` and
``out_proj`` go through ``layers.apply_dense`` (kernel K3 when the hook is
set).  Unlike the JAX block, a given cache is written in place (``copy_``)
and returned, as ``models/attention.py`` does with its KV cache, so both
cache forms of ``transformer.init_cache`` carry the state from one call to
the next.  JAX's ``jax.checkpoint`` around the SSD is ``layers.remat``
here, which applies only while autograd records.

Under ``sharding.model_parallel`` (``ssm_in`` over ``model``, as the
reference's rules put it) a rank computes its own heads (``rank_heads``):
of the fused ``in_proj`` output it needs its heads' z, x and dt columns and
the whole B and C, which lie mostly in other ranks' boxes of ``in_proj``'s
columns, so ``sharding.model_all_to_all`` moves them: the product's columns
when the rank's rows are at most ``d_model`` (decode), else the weight's
columns before the product.  A whole ``in_proj`` (compressed, int8, or a
fused dim that ``model`` does not divide) is computed whole and the
columns taken from it.  The conv weights (a few KiB) are made whole over
``model`` and the rank's channels taken; the SSD and the decode step run on
the rank's heads (its slices of ``A_log``, ``D``, ``dt_bias``, its box of
the state); the gated RMSNorm sums its statistic over ``model``; and the
row-parallel ``out_proj`` gives this rank's partial sum.  Heads that
``model`` does not divide are all computed on every rank, and the rank's
channel box taken for the norm's scale and ``out_proj``'s rows.  A cache's
conv window holds every channel: the rank's new window is gathered over
``model`` before it is written.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.params import param

__all__ = ["init_ssm", "ssm_block", "init_ssm_cache", "rank_heads"]


def init_ssm(generator, cfg: ModelConfig, dtype) -> dict:
    d, di, ds, ng, nh = (
        cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads,
    )
    dev = generator.device
    conv_dim = di + 2 * ng * ds
    d_in_proj = 2 * di + 2 * ng * ds + nh
    # dt_bias: softplus^-1 of dt ~ loguniform[1e-3, 1e-1]
    u = torch.rand((nh,), generator=generator, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt + torch.log(-torch.expm1(-dt))
    a_init = 1.0 + 15.0 * torch.rand((nh,), generator=generator, device=dev)
    conv_w = 0.1 * torch.randn((cfg.ssm_dconv, conv_dim), generator=generator, device=dev)
    return {
        "in_proj": layers.init_dense(generator, d, d_in_proj, ("embed", "ssm_in"), dtype),
        "conv_w": param(conv_w.to(dtype), (None, "ssm_in")),
        "conv_b": param(torch.zeros((conv_dim,), dtype=dtype, device=dev), ("ssm_in",)),
        "A_log": param(torch.log(a_init), (None,)),
        "D": param(torch.ones((nh,), dtype=torch.float32, device=dev), (None,)),
        "dt_bias": param(dt_bias, (None,)),
        "norm": {"scale": param(torch.ones((di,), dtype=torch.float32, device=dev),
                                ("ssm_in",))},
        "out_proj": layers.init_dense(generator, di, d, ("ssm_in", "embed"), dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state=None):
    """Depthwise causal conv, width dconv.  x (B, S, ch), w (dconv, ch).
    Returns (silu(y), new_state) with state = the last (dconv - 1) inputs.
    Summed as the reference does, from ``b`` upwards one tap at a time (a
    library convolution adds in another order, which changes bf16 bits)."""
    B, S, ch = x.shape
    dconv = w.shape[0]
    if state is None:
        state = torch.zeros((B, dconv - 1, ch), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = b
    for i in range(dconv):
        y = y + w[i] * xp[:, i:i + S]
    new_state = xp[:, S:] if S >= dconv - 1 else xp[:, -(dconv - 1):]
    return F.silu(y), new_state


def _ssd_chunk(u, dA_cum, Bm, Cm, S_prev, rep: int):
    """One chunk of the SSD recurrence.

    u (B, L, nh, hp); dA_cum (B, L, nh) inclusive cumsum of log-decay;
    Bm/Cm (B, L, g, ds); S_prev (B, nh, hp, ds).  Returns (y, S_new)."""
    decay = torch.exp(dA_cum[:, :, None, :] - dA_cum[:, None, :, :])    # (B, L, L, nh)
    L = u.shape[1]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=u.device))
    decay = torch.where(causal[None, :, :, None], decay, 0.0)
    CB = torch.einsum("blgn,bsgn->blsg", Cm, Bm)                       # (B, L, L, g)
    CB = CB.repeat_interleave(rep, dim=-1)                              # g -> nh
    scores = (CB * decay).to(u.dtype)
    y_intra = torch.einsum("blsh,bshp->blhp", scores, u)

    last = dA_cum[:, -1:, :]                                            # (B, 1, nh)
    Ch = Cm.repeat_interleave(rep, dim=2)                               # (B, L, nh, ds)
    f = layers.f32_or_wider(u)
    y_inter = torch.einsum("blhn,bhpn->blhp", Ch.to(f), S_prev.to(f))
    y_inter = y_inter * torch.exp(dA_cum)[..., None]

    w_state = torch.exp(last - dA_cum)                                  # (B, L, nh)
    Bh = Bm.repeat_interleave(rep, dim=2)                               # (B, L, nh, ds)
    S_chunk = torch.einsum("blh,blhn,blhp->bhpn", w_state.to(f), Bh.to(f), u.to(f))
    S_new = S_prev * torch.exp(last[:, 0, :])[:, :, None, None] + S_chunk
    return y_intra + y_inter.to(u.dtype), S_new


def _ssd(u, dA, Bm, Cm, chunk: int, S0):
    """Full-sequence SSD.  u (B, S, nh, hp), dA (B, S, nh) log-decay per
    step, Bm/Cm (B, S, g, ds).  Returns (y, S_final).

    The chunks follow the reference's rule, nc = max(S // chunk, 1) chunks
    of L = S // nc steps (the boundaries set the f32 rounding), and a length
    that rule does not cover (nc * L != S, e.g. S = 37 at chunk 16) is
    refused, as the reference's reshape refuses it."""
    B, S, nh, hp = u.shape
    g = Bm.shape[2]
    rep = nh // g
    nc = max(S // chunk, 1)
    L = S // nc
    if nc * L != S:
        raise ValueError(
            f"SSD: sequence length {S} is not nc * L for nc = max(S // chunk, 1) = {nc} "
            f"chunks of L = S // nc = {L} steps (chunk {chunk}); the reference refuses it too"
        )
    uc, dAc, Bc, Cc = (a.reshape(B, nc, L, *a.shape[2:]) for a in (u, dA, Bm, Cm))
    dA_cum = torch.cumsum(dAc, dim=2)                                   # (B, nc, L, nh)
    ys = []
    Sst = S0
    for c in range(nc):
        y, Sst = _ssd_chunk(uc[:, c], dA_cum[:, c], Bc[:, c], Cc[:, c], Sst, rep)
        ys.append(y)
    return torch.cat(ys, dim=1).reshape(B, S, nh, hp), Sst


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    di, ds, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * cfg.ssm_ngroups * ds
    return {
        "conv": torch.zeros((batch, cfg.ssm_dconv - 1, conv_dim), dtype=dtype, device=device),
        "state": torch.zeros((batch, nh, cfg.ssm_headdim, ds), dtype=torch.float32,
                             device=device),
    }


def rank_heads(cfg: ModelConfig, m: int) -> int:
    """The SSM heads that each of ``m`` ranks along ``model`` computes: nh /
    m where ``m`` divides the heads and a rank's heads read whole groups of
    B and C (or one group), else every head."""
    nh, rep = cfg.ssm_nheads, cfg.ssm_nheads // cfg.ssm_ngroups
    if m > 1 and nh % m == 0 and ((nh // m) % rep == 0 or rep % (nh // m) == 0):
        return nh // m
    return nh


def _fused_columns(cfg: ModelConfig, m: int, t: int, nl: int) -> tuple:
    """The columns of the fused ``in_proj`` output that rank t computes with,
    ascending: its heads' z, x, the whole B and C, its heads' dt (every
    column when it computes every head)."""
    di, bc, nh = cfg.d_inner, 2 * cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_nheads
    if nl == nh:
        return (range(2 * di + bc + nh),)
    c = nl * cfg.ssm_headdim
    return (range(t * c, (t + 1) * c), range(di + t * c, di + (t + 1) * c),
            range(2 * di, 2 * di + bc), range(2 * di + bc + t * nl, 2 * di + bc + (t + 1) * nl))


@functools.lru_cache(maxsize=64)
def _moves(cfg: ModelConfig, m: int, r: int, nl: int, width: int) -> tuple:
    """(send, recv) of ``model_all_to_all`` for rank r: the indices of its
    box of ``width`` fused columns that each rank needs, and how many of its
    own it receives from each rank."""
    def part(cols, s):
        lo, hi = s * width, (s + 1) * width
        return [i - lo for c in cols for i in range(max(c.start, lo), min(c.stop, hi))]

    mine = _fused_columns(cfg, m, r, nl)
    send = tuple(tuple(part(_fused_columns(cfg, m, t, nl), r)) for t in range(m))
    recv = tuple(len(part(mine, s)) for s in range(m))
    return send, recv


def _in_proj(h, p: dict, cfg: ModelConfig, nl: int):
    """The fused ``in_proj`` columns this rank computes with
    (``_fused_columns``), from its box of the columns moved over ``model``
    (module docstring) or from a whole weight."""
    w = layers._value(p["w"])
    m, r = shd.model_size(), shd.model_index()
    if shd.tp_dim(w) != 1:
        zx = layers.apply_dense(h, p)
        if nl == cfg.ssm_nheads:
            return zx
        return torch.cat([zx[..., c.start:c.stop] for c in _fused_columns(cfg, m, r, nl)], -1)
    send, recv = _moves(cfg, m, r, nl, w.shape[1])
    if h.numel() // h.shape[-1] <= h.shape[-1]:
        return shd.model_all_to_all(h @ w, send, recv, -1)
    return h @ shd.model_all_to_all(w, send, recv, -1)


def _gated_norm(y, z, scale, cfg: ModelConfig, c0: int):
    """``layers.rms_norm(y * silu(z))`` over the whole ``d_inner``, for a
    rank's channels [c0, c0 + width) of y and z: the statistic's partial
    sums added over ``model``.  A norm scale that is the rank's box of
    whole y's channels cuts the result to that box."""
    x = y * F.silu(z)
    di = cfg.d_inner
    if x.shape[-1] == di and scale.shape[-1] == di:
        return layers.rms_norm(x, {"scale": scale}, cfg.norm_eps)
    xf = x.to(layers.f32_or_wider(x))
    if x.shape[-1] < di:
        var = shd.model_sum(torch.sum(xf * xf, dim=-1, keepdim=True)) / di
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    n = xf * torch.rsqrt(var + cfg.norm_eps)
    if scale.shape[-1] < n.shape[-1]:
        n = shd.model_slice(n, -1)
    elif scale.shape[-1] > n.shape[-1]:
        scale = scale[c0:c0 + n.shape[-1]]
    return (n * scale).to(x.dtype)


def ssm_block(h: torch.Tensor, p: dict, cfg: ModelConfig, *, cache: dict | None = None,
              unroll: bool = False):
    """Returns (out (B, S, d), cache); ``p`` holds tensors (``forward``
    strips the Params).  With a cache, S == 1 is an O(1) decode step and
    S > 1 a prefill continuing from the cache's state; the new conv window
    and state are copied into the cache, which is returned.  Without one,
    the state starts at zero and None is returned.  ``unroll`` (the
    reference's costing twin of the SSD's chunk scan) is accepted and
    changes nothing: the port's chunk loop is already eager Python, and
    every chunk is counted as it runs.

    Under ``model_parallel`` (module docstring) ``h`` is whole, ``out`` is
    this rank's partial sum when ``out_proj`` is row-parallel (its input
    dim this rank's box) and whole otherwise, and the cache's state is the
    rank's heads or every head (a view of the rank's heads is taken)."""
    B, S, d = h.shape
    di, ds, ng, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    hp = cfg.ssm_headdim
    nl = rank_heads(cfg, shd.model_size())
    h0 = shd.model_index() * nl if nl < nh else 0
    c, c0 = nl * hp, h0 * hp                     # the rank's channels of x, z, y
    rep = nh // ng
    g0, g1 = h0 // rep, (h0 + nl - 1) // rep + 1  # the groups of B, C its heads read

    zxbcdt = _in_proj(h, p["in_proj"], cfg, nl)
    z = zxbcdt[..., :c]
    xBC = zxbcdt[..., c:2 * c + 2 * ng * ds]
    dt_raw = zxbcdt[..., 2 * c + 2 * ng * ds:]                          # (B, S, nl)

    conv_w, conv_b = shd.whole_over_model(p["conv_w"]), shd.whole_over_model(p["conv_b"])
    conv_state = cache["conv"] if cache is not None else None
    if nl < nh:
        def mine(t):
            return torch.cat([t[..., c0:c0 + c], t[..., di:]], -1)
        conv_w, conv_b = mine(conv_w), mine(conv_b)
        conv_state = None if conv_state is None else mine(conv_state)
    xBC, new_conv = _causal_conv(xBC, conv_w, conv_b, conv_state)

    x = xBC[..., :c].reshape(B, S, nl, hp)
    Bm = xBC[..., c + g0 * ds:c + g1 * ds].reshape(B, S, g1 - g0, ds)
    Cm = xBC[..., c + (ng + g0) * ds:c + (ng + g1) * ds].reshape(B, S, g1 - g0, ds)

    dt_bias, A_log, Dp = p["dt_bias"], p["A_log"], p["D"]
    if nl < nh:
        dt_bias, A_log, Dp = (t[h0:h0 + nl] for t in (dt_bias, A_log, Dp))
    f = layers.f32_or_wider(h)
    dt = F.softplus(dt_raw.to(f) + dt_bias)
    A = -torch.exp(A_log)                                               # (nl,)
    dA = dt * A                                                         # (B, S, nl) log-decay
    u = x * dt.to(x.dtype)[..., None]

    state = None
    if cache is not None:
        state = cache["state"]
        if state.shape[1] != nl:
            state = state[:, h0:h0 + nl]
    S0 = (state if state is not None
          else torch.zeros((B, nl, hp, ds), dtype=f, device=h.device))
    if S == 1 and cache is not None:
        # ---- O(1) decode step ----
        a = torch.exp(dA[:, 0])                                         # (B, nl)
        rep_l = nl // (g1 - g0)
        Bh = Bm[:, 0].repeat_interleave(rep_l, dim=1)                   # (B, nl, ds)
        Ch = Cm[:, 0].repeat_interleave(rep_l, dim=1)
        S_new = S0 * a[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh.to(f), u[:, 0].to(f)
        )
        y = torch.einsum("bhn,bhpn->bhp", Ch.to(f), S_new)
        y = y[:, None].to(h.dtype)
        S_final = S_new
    else:
        chunk = min(cfg.ssm_chunk, S)
        # under remat while autograd records, as the reference checkpoints the
        # SSD: backward recomputes the per-chunk decay and score tensors
        y, S_final = layers.remat(lambda u_, dA_, B_, C_, S0_: _ssd(u_, dA_, B_, C_, chunk, S0_),
                                  u, dA, Bm, Cm, S0)

    y = y + Dp.to(y.dtype)[None, None, :, None] * x
    y = _gated_norm(y.reshape(B, S, c), z, p["norm"]["scale"], cfg, c0)
    w_out = layers._value(p["out_proj"]["w"])
    if shd.tp_dim(w_out) != 0 and y.shape[-1] < di:
        y = shd.model_gather(y, -1)          # a whole (compressed) out_proj
    out = layers.apply_dense(y, p["out_proj"])

    if cache is not None:
        if nl < nh:
            new_conv = torch.cat([shd.model_gather(new_conv[..., :c], -1), new_conv[..., c:]],
                                 -1)
        cache["conv"].copy_(new_conv)
        state.copy_(S_final)
    return out, cache
