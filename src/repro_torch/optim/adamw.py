"""Optimisers: AdamW and Adafactor, counterparts of ``repro/optim/adamw.py``.

Both keep the reference's functional form: ``opt.init(params) -> state``
and ``opt.update(grads, state, params, step, lr) -> (params, state,
grad_norm)``, over nested dicts of tensors (the model's values tree).
AdamW's state is ``{"m": tree, "v": tree}``; Adafactor's is one dict per
parameter, ``{"vr", "vc"}`` (factored second moments) or ``{"v"}``.

The arithmetic is the reference's, in float32 with every cast kept, one
leaf at a time.  Unlike the reference, ``update`` writes the new moments
and parameters into the given tensors (under ``torch.no_grad``) and
returns those same trees: at full width a second copy of the moments
would not fit beside the first.  The reference computes this outside any
Pallas kernel, and so does the port: plain tensor operations.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = ["Optimizer", "adamw", "adafactor", "global_norm", "clip_by_global_norm"]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params, step, lr) -> (params, state, grad_norm)


def _leaves(tree) -> list:
    """Leaves in the reference's flat order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (nested dicts)."""
    if isinstance(trees[0], dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _per_param(tree, params) -> list:
    """``tree``'s subtrees at the leaves of ``params`` (Adafactor's state
    holds one dict per parameter), in the same order as ``_leaves``."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _per_param(tree[k], params[k])]
    return [tree]


def global_norm(tree) -> torch.Tensor:
    sq = [torch.sum(torch.square(x.to(torch.float32))) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to at most ``max_norm`` in global norm, the norm); a
    new tree, as the reference returns."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return _map(lambda g: g * scale.to(g.dtype), grads), norm


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float = 1.0,
) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": _map(zeros, params), "v": _map(zeros, params)}

    @torch.no_grad()
    def update(grads, state, params, step, lr, norm=None):
        """``norm``: the global gradient norm when ``grads`` are shards of
        the gradients (the sharded train step computes it from the whole
        gradients, each element counted once)."""
        gnorm = global_norm(grads) if norm is None else norm
        scale = _clip_scale(gnorm, clip_norm)
        t = torch.as_tensor(step + 1).to(torch.float32)
        bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        for g, m, v, p in zip(_leaves(grads), _leaves(state["m"]), _leaves(state["v"]),
                              _leaves(params)):
            gf = (g * scale.to(g.dtype)).to(torch.float32)      # the clipped gradient
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * gf * gf)
            upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * upd).to(p.dtype))
            del gf, upd
        return params, state, gnorm

    return Optimizer(init, update)


def adafactor(
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    min_dim_factored: int = 128,
) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018) without first moment.

    Tensors whose two trailing dims are both >= ``min_dim_factored`` keep
    factored second moments (rows, columns); every other tensor a full one.
    """

    def factored(p) -> bool:
        return p.ndim >= 2 and p.shape[-1] >= min_dim_factored and p.shape[-2] >= min_dim_factored

    def init(params):
        def one(p):
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32, device=p.device)

            if factored(p):
                return {"vr": zeros(p.shape[:-1]), "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return _map(one, params)

    @torch.no_grad()
    def update(grads, state, params, step, lr):
        t = torch.as_tensor(step + 1).to(torch.float32)
        beta = 1.0 - t ** (-decay)
        for g, s, p in zip(_leaves(grads), _per_param(state, params), _leaves(params)):
            gf = g.to(torch.float32)
            g2 = gf * gf + eps
            if "vr" in s:
                vr, vc = s["vr"], s["vc"]
                vr.copy_(beta * vr + (1 - beta) * torch.mean(g2, dim=-1))
                vc.copy_(beta * vc + (1 - beta) * torch.mean(g2, dim=-2))
                rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
                u = gf / (torch.sqrt(rfac)[..., None] * torch.sqrt(vc)[..., None, :] + 1e-30)
            else:
                v = s["v"]
                v.copy_(beta * v + (1 - beta) * g2)
                u = gf / (torch.sqrt(v) + 1e-30)
            del g2
            # update clipping by RMS
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))
            del gf, u
        return params, state, global_norm(grads)

    return Optimizer(init, update)
