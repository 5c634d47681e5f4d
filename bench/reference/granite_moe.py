"""The plain reference of granite-3.0's mixture-of-experts transformer.

Imports nothing of the program.  Blocks: ``h += attn(norm1(h))``, ``h +=
moe(norm2(h))``; the head is the tied embedding table.  Mixture of experts:
a float32 router and softmax, the top ``k`` experts by a stable descending
sort (ties to the lower index), gates renormalised over the ``k``; each
expert takes at most ``capacity = max(int(cf * L * k / E), 1)`` slots of a
routing group of L tokens, handed out in the group's (token, rank) order,
and a slot past it is dropped.  A prompt of P tokens is routed in groups
of ``min(route_block, P)`` tokens, halved until they divide P; each
generated token is a group of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import Precision, attention, dense, head, index, rms_norm


def routing_groups(prompt_len: int, total: int, route_block: int) -> list:
    """[(start, length)]: the prompt's routing groups, then one a token."""
    blk = min(route_block, prompt_len)
    while prompt_len % blk:
        blk //= 2
    groups = [(s, blk) for s in range(0, prompt_len, blk)]
    return groups + [(s, 1) for s in range(prompt_len, total)]


def moe(x, router, wg, wu, wd, k: int, cf: float, groups: list,
        prec: Precision) -> torch.Tensor:
    """x (N, S, d); router (d, E) float32; wg, wu (E, d, f), wd (E, f, d)."""
    N, S, d = x.shape
    E = router.shape[1]
    probs = torch.softmax(x.float() @ router.float(), dim=-1)            # (N, S, E)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    keep = torch.zeros_like(gates, dtype=torch.bool)
    for start, length in groups:
        cap = max(int(cf * length * k / E), 1)
        oh = F.one_hot(idx[:, start:start + length], E).reshape(N, length * k, E)
        before = torch.cumsum(oh, dim=1) - oh                             # slots ahead
        place = (before * oh).sum(-1).reshape(N, length, k)
        keep[:, start:start + length] = place < cap
    gates = gates * keep
    out = torch.zeros((N, S, d), dtype=torch.float32, device=x.device)
    xf = x.reshape(N * S, d)
    flat_idx, flat_g = idx.reshape(N * S, k), gates.reshape(N * S, k)
    for e in range(E):
        tok, slot = torch.nonzero(flat_idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = xf[tok]
        ye = prec.mm(F.silu(prec.mm(xe, wg[e])) * prec.mm(xe, wu[e]), wd[e])
        out.view(N * S, d).index_add_(0, tok, ye * flat_g[tok, slot, None])
    return out


def logits(cfg: dict, weights: dict, tokens: torch.Tensor, prompt_len: int,
                   positions, prec: Precision, seq_block: int = 4) -> torch.Tensor:
    """Logits (N, len(positions), V) of the MoE transformer over ``tokens``
    (N, S): the prompt is its first ``prompt_len`` tokens, the rest were
    generated one at a time (their routing groups)."""
    N, S = tokens.shape
    eps, L = cfg["rms_norm_eps"], cfg["num_hidden_layers"]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    groups = routing_groups(prompt_len, S, cfg["route_block"])
    h = weights["embed"]["table"][tokens].float()
    g = weights["groups"]["0"]
    for layer in range(L):
        pa = {n: prec.weight(dense(index(g["attn"][n]["w"], layer)))
              for n in ("wq", "wk", "wv", "wo")}
        wg, wu, wd = (prec.weight(dense(index(g["moe"][n], layer)))
                      for n in ("gate", "up", "down"))
        router = g["moe"]["router"][layer]
        n1, n2 = g["norm1"]["scale"][layer], g["norm2"]["scale"][layer]
        for a in range(0, N, seq_block):
            x = h[a:a + seq_block]
            x = x + attention(rms_norm(x, n1, eps), pa, H, KV, hd, cfg["rope_theta"], 0, prec)
            x = x + moe(rms_norm(x, n2, eps), router, wg, wu, wd, cfg["num_experts_per_tok"],
                        cfg["capacity_factor"], groups, prec)
            h[a:a + seq_block] = x
        del pa, wg, wu, wd
    return head(h, weights, cfg, positions)
