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

Under ``sharding.model_parallel`` the block is not tensor-parallel yet (the
reference's ``ssm_in`` over ``model`` splits the fused ``in_proj`` across
its z/x/B/C/dt parts): ``ssm_block`` makes its weights' boxes along
``model`` whole and every rank computes the whole block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers
from repro_torch.models.params import param

__all__ = ["init_ssm", "ssm_block", "init_ssm_cache"]


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
    y_inter = torch.einsum("blhn,bhpn->blhp", Ch.float(), S_prev.float())
    y_inter = y_inter * torch.exp(dA_cum)[..., None]

    w_state = torch.exp(last - dA_cum)                                  # (B, L, nh)
    Bh = Bm.repeat_interleave(rep, dim=2)                               # (B, L, nh, ds)
    S_chunk = torch.einsum("blh,blhn,blhp->bhpn", w_state.float(), Bh.float(), u.float())
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


def _whole_over_model(p):
    """The block's weights whole along ``model`` (module docstring)."""
    if isinstance(p, dict):
        return {k: _whole_over_model(v) for k, v in p.items()}
    return shd.whole_over_model(p)


def ssm_block(h: torch.Tensor, p: dict, cfg: ModelConfig, *, cache: dict | None = None,
              unroll: bool = False):
    """Returns (out (B, S, d), cache); ``p`` holds tensors (``forward``
    strips the Params).  With a cache, S == 1 is an O(1) decode step and
    S > 1 a prefill continuing from the cache's state; the new conv window
    and state are copied into the cache, which is returned.  Without one,
    the state starts at zero and None is returned.  ``unroll`` (the
    reference's costing twin of the SSD's chunk scan) is accepted and
    changes nothing: the port's chunk loop is already eager Python, and
    every chunk is counted as it runs."""
    B, S, d = h.shape
    di, ds, ng, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    hp = cfg.ssm_headdim
    p = _whole_over_model(p)

    zxbcdt = layers.apply_dense(h, p["in_proj"])
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:2 * di + 2 * ng * ds]
    dt_raw = zxbcdt[..., 2 * di + 2 * ng * ds:]                         # (B, S, nh)

    conv_state = cache["conv"] if cache is not None else None
    xBC, new_conv = _causal_conv(xBC, p["conv_w"], p["conv_b"], conv_state)

    x = xBC[..., :di].reshape(B, S, nh, hp)
    Bm = xBC[..., di:di + ng * ds].reshape(B, S, ng, ds)
    Cm = xBC[..., di + ng * ds:].reshape(B, S, ng, ds)

    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                                    # (nh,)
    dA = dt * A                                                         # (B, S, nh) log-decay
    u = x * dt.to(x.dtype)[..., None]

    S0 = (cache["state"] if cache is not None
          else torch.zeros((B, nh, hp, ds), dtype=torch.float32, device=h.device))
    if S == 1 and cache is not None:
        # ---- O(1) decode step ----
        a = torch.exp(dA[:, 0])                                         # (B, nh)
        rep = nh // ng
        Bh = Bm[:, 0].repeat_interleave(rep, dim=1)                     # (B, nh, ds)
        Ch = Cm[:, 0].repeat_interleave(rep, dim=1)
        S_new = S0 * a[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh.float(), u[:, 0].float()
        )
        y = torch.einsum("bhn,bhpn->bhp", Ch.float(), S_new)
        y = y[:, None].to(h.dtype)
        S_final = S_new
    else:
        chunk = min(cfg.ssm_chunk, S)
        # under remat while autograd records, as the reference checkpoints the
        # SSD: backward recomputes the per-chunk decay and score tensors
        y, S_final = layers.remat(lambda u_, dA_, B_, C_, S0_: _ssd(u_, dA_, B_, C_, chunk, S0_),
                                  u, dA, Bm, Cm, S0)

    y = y + p["D"].to(y.dtype)[None, None, :, None] * x
    y = y.reshape(B, S, di)
    y = layers.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = layers.apply_dense(y, p["out_proj"])

    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(S_final)
    return out, cache
