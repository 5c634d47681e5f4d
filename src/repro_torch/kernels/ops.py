"""Kernel routing for the model's hot paths.

Counterpart of ``repro/kernels/ops.py``.  ``enable_kernels()`` registers
the flash-attention adapter into :mod:`repro_torch.models.attention` (every
prefill without ``attend_cache`` runs ``kernels.flash_attention``) and the
fused bitlinear hook into :mod:`repro_torch.core.quantized` (every
``apply_compressed`` call runs ``kernels.bitlinear.bitlinear``); each is the
CUDA kernel for CUDA tensors and its plain version for CPU ones.  The
schedule autotuner and the grouped kernel K4 are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from repro_torch.core import quantized
from repro_torch.kernels.bitlinear import bitlinear
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn_lib

__all__ = [
    "enable_kernels",
    "disable_kernels",
    "apply_compressed_fused",
    "flash_attention",
    "flash_attention_model_layout",
]


def flash_attention_model_layout(qh, k, v, window: int):
    """The attention layer's layout: q (B, S, KV, rep, hd), k/v (B, S, KV,
    hd) -> (B, S, KV, rep, hd).  Heads are KV-major, so query head
    h = g * rep + r reads kv head g = h // rep, as the kernel does."""
    B, S, KV, rep, hd = qh.shape
    q = qh.reshape(B, S, KV * rep, hd).transpose(1, 2).contiguous()
    o = flash_attention(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                        window)
    return o.transpose(1, 2).reshape(B, S, KV, rep, hd)


def enable_kernels() -> None:
    """Route attention prefill through K5 and compressed layers through K3.
    The hooks are process-global; ``disable_kernels()`` removes both."""
    attn_lib.register_flash(flash_attention_model_layout)
    quantized.register_bitlinear_fused(apply_compressed_fused)


def disable_kernels() -> None:
    attn_lib.clear_flash()
    quantized.clear_bitlinear()


def apply_compressed_fused(x, w):
    """y = (x @ M) @ C through the bitlinear kernel; x (..., d_in) ->
    (..., d_out) with any leading dims flattened into the kernel's T axis."""
    C = w["C"]
    if C.ndim != 4:
        raise NotImplementedError(
            "grouped compressed weights need kernel K4 (ROADMAP.md)"
        )
    n_c, td = C.shape[1], C.shape[3]
    lead = x.shape[:-1]
    y = bitlinear(x.reshape(-1, x.shape[-1]), w["m_packed"], C)
    return y.reshape(*lead, n_c * td)
