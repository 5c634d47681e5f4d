"""Plain PyTorch pieces of the served models' references, from their equations.

This file imports nothing of the program under test.  A reference takes the
weights the benchmark drew (dense leaves, and compressed leaves as packed
sign bits ``m_packed`` and real factors ``C``) and works out every dense
matrix again as ``W = M @ C`` per tile.  It computes in float32 by default:
the caller turns TF32 off.  ``Precision("fp8")`` is the control, the same
forward with every matrix product's operands rounded to float8 e4m3 (a
scale per row of the activations and per output column of the weights).

Equations: RMS norm ``x * rsqrt(mean(x^2) + eps) * scale``; RoPE with the
two halves of a head rotated (``theta ** (-i / (hd / 2))``); softmax
attention with scale ``1 / sqrt(hd)``, causal, over the last ``window``
positions when a window is set; SwiGLU MLP ``down(silu(gate(x)) * up(x))``;
the head is the tied embedding table after the final norm.

A configuration's reference is ``reference/<reference>.py`` (the key
``reference`` of its file), with ``logits(cfg, weights, tokens, prompt_len,
positions, prec)``.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


class Precision:
    """Matrix products in float32 ("f32") or with float8 e4m3 operands
    ("fp8", the control)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"precision {kind!r}")
        self.kind = kind

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (..., d_in, d_out) weight as the products use it."""
        w = w.float()
        if self.kind == "fp8":
            w = _fp8(w, dim=-2)
        return w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.kind == "fp8":
            x = _fp8(x, dim=-1)
        return x @ w


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = amax / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def unpack_signs(m_packed: torch.Tensor, K: int) -> torch.Tensor:
    """uint8 (..., kb) with bit j of byte b for column 8b + j (1 -> +1,
    0 -> -1) -> float32 (..., K)."""
    shifts = torch.arange(8, device=m_packed.device, dtype=torch.uint8)
    bits = (m_packed.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*m_packed.shape[:-1], m_packed.shape[-1] * 8)[..., :K]
    return bits.float() * 2.0 - 1.0


def dense(w) -> torch.Tensor:
    """A dense float32 (..., d_in, d_out) matrix from a dense tensor or a
    compressed ``{"m_packed" (..., r, c, tn, kb), "C" (..., r, c, K, td)}``."""
    if not isinstance(w, dict):
        return w.float()
    C = w["C"].float()
    r, c, K, td = C.shape[-4:]
    M = unpack_signs(w["m_packed"], K)                       # (..., r, c, tn, K)
    tn = M.shape[-2]
    W = torch.einsum("...rctk,...rckd->...rtcd", M, C)
    return W.reshape(*C.shape[:-4], r * tn, c * td)


def leaf(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def index(w, i: int):
    """Slice ``i`` of the leading axis of a dense or compressed leaf."""
    if isinstance(w, dict):
        return {k: v[i] for k, v in w.items()}
    return w[i]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (N, S, H, hd) at positions 0 .. S-1."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, device=x.device, dtype=torch.float32) / half)
    ang = torch.arange(x.shape[1], device=x.device, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(x, p: dict, heads: int, kv_heads: int, hd: int, theta: float, window: int,
              prec: Precision, q_block: int = 512) -> torch.Tensor:
    """Causal GQA attention of x (N, S, d); ``p`` holds dense wq, wk, wv, wo."""
    N, S, _ = x.shape
    q = rope(prec.mm(x, p["wq"]).reshape(N, S, heads, hd), theta)
    k = rope(prec.mm(x, p["wk"]).reshape(N, S, kv_heads, hd), theta)
    v = prec.mm(x, p["wv"]).reshape(N, S, kv_heads, hd)
    rep = heads // kv_heads
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)       # (N, H, S, hd)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=x.device)
    for a in range(0, S, q_block):
        b = min(a + q_block, S)
        s = (q[:, :, a:b] @ k[:, :, :b].transpose(-1, -2)) / math.sqrt(hd)
        qp, kp = pos[a:b, None], pos[None, :b]
        mask = kp <= qp
        if window > 0:
            mask &= qp - kp < window
        s = s.masked_fill(~mask, float("-inf"))
        out[:, :, a:b] = torch.softmax(s, dim=-1) @ v[:, :, :b]
    return prec.mm(out.transpose(1, 2).reshape(N, S, heads * hd), p["wo"])


def head(h, weights, cfg, positions) -> torch.Tensor:
    hf = rms_norm(h[:, positions], weights["final_norm"]["scale"], cfg["rms_norm_eps"])
    return hf @ weights["embed"]["table"].float().T
