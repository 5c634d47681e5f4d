"""Operations of a prefill of granite-3.0's mixture-of-experts transformer,
from the configuration's and the plan's shapes.  Imports nothing of the
program.  A configuration's count is ``work/<reference>.py`` (the key
``reference`` of its file), with ``prefill_ops(sizes, geo, B, P)``."""

from __future__ import annotations

from work.counts import causal_pairs, compressed_ops


def prefill_ops(sizes: dict, geo: dict, B: int, P: int) -> int:
    """Operations of one prefill of B prompts of P tokens through the
    compressed model: the compressed attention and expert products (each
    token through its k experts), causal attention, the router, and the
    head at the last position.  ``geo`` maps a role (``attn/wq``,
    ``moe/gate``, ...) to its tile (tn, K, td)."""
    T = B * P
    d, V = sizes["hidden_size"], sizes["vocab_size"]
    H, KV, hd = sizes["num_attention_heads"], sizes["num_key_value_heads"], sizes["head_dim"]
    L, E, k, f = (sizes["num_hidden_layers"], sizes["num_local_experts"],
                  sizes["num_experts_per_tok"], sizes["intermediate_size"])
    attn = sum(compressed_ops(T, a, b, *geo[f"attn/{n}"])
               for n, a, b in (("wq", d, H * hd), ("wk", d, KV * hd), ("wv", d, KV * hd),
                               ("wo", H * hd, d)))
    core = 4 * B * H * hd * causal_pairs(P)
    experts = sum(compressed_ops(T * k, a, b, *geo[f"moe/{n}"])
                  for n, a, b in (("gate", d, f), ("up", d, f), ("down", f, d)))
    router = 2 * T * d * E
    head = 2 * B * d * V
    return L * (attn + core + experts + router) + head
