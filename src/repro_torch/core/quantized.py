"""Compressed-weight representation and inference path.

Counterpart of ``repro/core/quantized.py``.  A dense weight W (d_in,
d_out) compressed tile-wise is stored as

    {"m_packed": uint8 (r, c, tn, ceil(K/8)),   # per-tile binary factor M
     "C":        (r, c, K, td) float}           # per-tile real factor C

with d_in = r * tn and d_out = c * td, and ``y = x @ W_hat`` is computed
as z[r, c] = x[r] @ M[r, c], y[c] += z[r, c] @ C[r, c].

``apply_compressed_einsum`` is the oracle.  With a fused hook registered
(``repro_torch.kernels.ops.enable_kernels``), ``apply_compressed`` runs the
whole layer through the bitlinear kernel; its gradient comes from the
einsum form through a ``torch.autograd.Function`` (exact dx and dC, none
for the packed bits).  Grouped (per-expert, 5-D) weights wait for the
grouped kernel K4.  The int8 baseline {"q", "scale"} is served by
dequant-einsum.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import unpack_signs

__all__ = [
    "is_compressed",
    "is_grouped",
    "apply_compressed",
    "apply_compressed_einsum",
    "decompress",
    "compressed_num_bytes",
    "dense_num_bytes",
    "is_intquant",
    "intquant_num_bytes",
    "register_bitlinear_fused",
    "clear_bitlinear",
    "has_fused_bitlinear",
]

_KEYS = frozenset({"m_packed", "C"})
_INT8_KEYS = frozenset({"q", "scale"})

# Whole-layer hook y = (x @ M) @ C, registered by
# repro_torch.kernels.ops.enable_kernels().  Process-global, as in repro.
_BITLINEAR_FUSED_IMPL = None


def register_bitlinear_fused(fn) -> None:
    """Register the fused hook ``fn(x, w) -> y`` for the compressed layer."""
    if fn is None:
        raise ValueError(
            "register_bitlinear_fused(None) would silently disable a kernel; "
            "call clear_bitlinear() to unregister explicitly"
        )
    if not callable(fn):
        raise TypeError(f"register_bitlinear_fused expects a callable, got {type(fn)!r}")
    global _BITLINEAR_FUSED_IMPL
    _BITLINEAR_FUSED_IMPL = fn


def clear_bitlinear() -> None:
    """Unregister the fused hook (back to the einsum form)."""
    global _BITLINEAR_FUSED_IMPL
    _BITLINEAR_FUSED_IMPL = None


def has_fused_bitlinear() -> bool:
    return _BITLINEAR_FUSED_IMPL is not None


def is_compressed(w) -> bool:
    return isinstance(w, dict) and _KEYS.issubset(w.keys())


def is_grouped(w) -> bool:
    """Compressed weight with a leading group (expert) axis."""
    return is_compressed(w) and w["C"].ndim == 5


def is_intquant(w) -> bool:
    return isinstance(w, dict) and _INT8_KEYS.issubset(w.keys())


def decompress(w: dict, dtype=None) -> torch.Tensor:
    """Materialise W_hat = M C; leading stack dims are preserved:
    (..., r, c, K, td) -> (..., r*tn, c*td)."""
    C, mp = w["C"], w["m_packed"]
    dtype = dtype or C.dtype
    r, c, K, td = C.shape[-4:]
    tn = mp.shape[-2]
    M = unpack_signs(mp, K, dtype)                              # (..., r, c, tn, K)
    tiles = torch.einsum("...rcnk,...rckd->...rcnd", M, C.to(dtype))
    lead = C.shape[:-4]
    n = len(lead)
    tiles = tiles.permute(*range(n), n, n + 2, n + 1, n + 3)
    return tiles.reshape(*lead, r * tn, c * td)


def apply_compressed_einsum(x: torch.Tensor, w: dict) -> torch.Tensor:
    """y = x @ W_hat via the two-einsum form (unpack M, z = x @ M,
    y = z @ C).  The autograd-friendly oracle."""
    C = w["C"]
    r, c, K, td = C.shape
    tn = w["m_packed"].shape[2]
    lead = x.shape[:-1]
    xt = x.reshape(*lead, r, tn)
    M = unpack_signs(w["m_packed"], K, x.dtype)                 # (r, c, tn, K)
    z = torch.einsum("...rn,rcnk->...rck", xt, M)
    y = torch.einsum("...rck,rckd->...cd", z, C.to(x.dtype))
    return y.reshape(*lead, c * td)


class _FusedApply(torch.autograd.Function):
    """Forward: the registered fused kernel.  Backward: cotangents of the
    einsum formulation (M recomputed from the packed bits); the packed bits
    are integers and get no gradient."""

    @staticmethod
    def forward(ctx, x, m_packed, C):
        ctx.save_for_backward(x, m_packed, C)
        return _BITLINEAR_FUSED_IMPL(x, {"m_packed": m_packed, "C": C})

    @staticmethod
    def backward(ctx, g):
        x, m_packed, C = ctx.saved_tensors
        r, c, K, td = C.shape
        tn = m_packed.shape[2]
        lead = x.shape[:-1]
        M = unpack_signs(m_packed, K, x.dtype)
        gt = g.reshape(*lead, c, td).to(x.dtype)
        dz = torch.einsum("...cd,rckd->...rck", gt, C.to(x.dtype))
        dx = torch.einsum("...rck,rcnk->...rn", dz, M).reshape(x.shape)
        z = torch.einsum("...rn,rcnk->...rck", x.reshape(*lead, r, tn), M)
        dC = torch.einsum("...rck,...cd->rckd", z, gt).to(C.dtype)
        return dx, None, dC


def apply_compressed(x: torch.Tensor, w: dict) -> torch.Tensor:
    """y = x @ W_hat without materialising W_hat: through the fused kernel
    when one is registered, else the einsum form."""
    if is_grouped(w):
        raise NotImplementedError(
            "grouped (per-expert) compressed weights need the grouped kernel "
            "K4, not ported yet (ROADMAP.md, Queue 2, K4)"
        )
    if _BITLINEAR_FUSED_IMPL is not None:
        return _FusedApply.apply(x, w["m_packed"], w["C"])
    return apply_compressed_einsum(x, w)


def compressed_num_bytes(w: dict) -> int:
    return w["m_packed"].numel() + w["C"].numel() * w["C"].element_size()


def intquant_num_bytes(w: dict) -> int:
    return w["q"].numel() + w["scale"].numel() * w["scale"].element_size()


def dense_num_bytes(w: dict, dense_itemsize: int = 2) -> int:
    C = w["C"]
    r, c, K, td = C.shape[-4:]
    tn = w["m_packed"].shape[-2]
    groups = 1
    for s in C.shape[:-4]:
        groups *= int(s)
    return groups * r * tn * c * td * dense_itemsize
