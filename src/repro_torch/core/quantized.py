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
for the packed bits).  Grouped (per-expert) weights, C (E, r, c, K, td),
take x (E, ..., d_in) and run through the grouped hook (kernel K4) when one
is registered, else the grouped einsum form; their gradient is derived the
same way.  The int8 baseline {"q", "scale"} (per-tile int8 q with a
per-tile scale) is served by dequant-einsum (``apply_intquant``).  The
partial hook ``register_bitlinear`` (z = x @ M per tile inside the einsum
form) is an extension point: nothing in the package registers it, as in
``repro``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ref import unpack_signs

__all__ = [
    "is_compressed",
    "is_grouped",
    "apply_compressed",
    "apply_compressed_einsum",
    "apply_compressed_grouped",
    "apply_compressed_grouped_einsum",
    "decompress",
    "compressed_num_bytes",
    "dense_num_bytes",
    "is_intquant",
    "intquant_num_bytes",
    "dequantize",
    "apply_intquant",
    "register_bitlinear",
    "register_bitlinear_fused",
    "register_bitlinear_grouped",
    "clear_bitlinear",
    "has_fused_bitlinear",
    "has_grouped_bitlinear",
]

_KEYS = frozenset({"m_packed", "C"})
_INT8_KEYS = frozenset({"q", "scale"})

# The partial hook z = x @ M per tile (kept inside the two-einsum form), and
# the whole-layer hooks y = (x @ M) @ C and its grouped form, registered by
# repro_torch.kernels.ops.enable_kernels().  Process-global, as in repro.
_BITLINEAR_IMPL = None
_BITLINEAR_FUSED_IMPL = None
_BITLINEAR_GROUPED_IMPL = None


def _check_impl(fn, name: str) -> None:
    if fn is None:
        raise ValueError(
            f"{name}(None) would silently disable a kernel; "
            "call clear_bitlinear() to unregister explicitly"
        )
    if not callable(fn):
        raise TypeError(f"{name} expects a callable, got {type(fn)!r}")


def register_bitlinear(fn) -> None:
    """Register the partial hook ``fn(xt, m_packed, K) -> z`` computing
    z = x @ M per tile, xt (..., r, tn) -> z (..., r, c, K); the einsum
    form then applies C (and keeps its gradient)."""
    _check_impl(fn, "register_bitlinear")
    global _BITLINEAR_IMPL
    _BITLINEAR_IMPL = fn


def register_bitlinear_fused(fn) -> None:
    """Register the fused hook ``fn(x, w) -> y`` for the compressed layer."""
    _check_impl(fn, "register_bitlinear_fused")
    global _BITLINEAR_FUSED_IMPL
    _BITLINEAR_FUSED_IMPL = fn


def register_bitlinear_grouped(fn) -> None:
    """Register the grouped hook ``fn(x, w) -> y`` computing
    y_e = (x_e @ M_e) @ C_e for x (E, ..., d_in) and a grouped weight
    {"m_packed" (E, r, c, tn, kb), "C" (E, r, c, K, td)}."""
    _check_impl(fn, "register_bitlinear_grouped")
    global _BITLINEAR_GROUPED_IMPL
    _BITLINEAR_GROUPED_IMPL = fn


def clear_bitlinear() -> None:
    """Unregister every bitlinear hook (back to the einsum forms)."""
    global _BITLINEAR_IMPL, _BITLINEAR_FUSED_IMPL, _BITLINEAR_GROUPED_IMPL
    _BITLINEAR_IMPL = None
    _BITLINEAR_FUSED_IMPL = None
    _BITLINEAR_GROUPED_IMPL = None


def has_fused_bitlinear() -> bool:
    return _BITLINEAR_FUSED_IMPL is not None


def has_grouped_bitlinear() -> bool:
    return _BITLINEAR_GROUPED_IMPL is not None


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
    if _BITLINEAR_IMPL is not None:
        z = _BITLINEAR_IMPL(xt, w["m_packed"], K)               # (..., r, c, K)
    else:
        M = unpack_signs(w["m_packed"], K, x.dtype)             # (r, c, tn, K)
        z = torch.einsum("...rn,rcnk->...rck", xt, M)
    y = torch.einsum("...rck,rckd->...cd", z, C.to(x.dtype))
    return y.reshape(*lead, c * td)


def apply_compressed_grouped_einsum(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Grouped oracle: y_e = x_e @ W_hat_e per expert via the two-einsum
    form.  x (E, ..., d_in) with the leading axis matching the weight's
    expert axis (the MoE (E, B, C, d) dispatch layout)."""
    C = w["C"]
    E, r, c, K, td = C.shape
    tn = w["m_packed"].shape[3]
    if x.shape[0] != E:
        raise ValueError(f"grouped apply: x {tuple(x.shape)} vs C {tuple(C.shape)}")
    lead = x.shape[1:-1]
    xt = x.reshape(E, -1, r, tn)
    M = unpack_signs(w["m_packed"], K, x.dtype)                 # (E, r, c, tn, K)
    z = torch.einsum("etrn,ercnk->etrck", xt, M)
    y = torch.einsum("etrck,erckd->etcd", z, C.to(x.dtype))
    return y.reshape(E, *lead, c * td)


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


class _GroupedFusedApply(torch.autograd.Function):
    """The grouped form of ``_FusedApply``: forward through the registered
    grouped kernel, backward from the grouped einsum form with the expert
    axis threaded through (``repro``'s ``_apply_grouped_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, m_packed, C):
        ctx.save_for_backward(x, m_packed, C)
        return _BITLINEAR_GROUPED_IMPL(x, {"m_packed": m_packed, "C": C})

    @staticmethod
    def backward(ctx, g):
        x, m_packed, C = ctx.saved_tensors
        E, r, c, K, td = C.shape
        tn = m_packed.shape[3]
        M = unpack_signs(m_packed, K, x.dtype)
        xt = x.reshape(E, -1, r, tn)
        gt = g.reshape(E, -1, c, td).to(x.dtype)
        dz = torch.einsum("etcd,erckd->etrck", gt, C.to(x.dtype))
        dx = torch.einsum("etrck,ercnk->etrn", dz, M).reshape(x.shape)
        z = torch.einsum("etrn,ercnk->etrck", xt, M)
        dC = torch.einsum("etrck,etcd->erckd", z, gt).to(C.dtype)
        return dx, None, dC


def apply_compressed_grouped(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Per-expert y_e = x_e @ W_hat_e without materialising any W_hat_e:
    all E experts in one grouped kernel launch when the grouped hook is
    registered, else the grouped einsum form."""
    if _BITLINEAR_GROUPED_IMPL is not None:
        return _GroupedFusedApply.apply(x, w["m_packed"], w["C"])
    return apply_compressed_grouped_einsum(x, w)


def apply_compressed(x: torch.Tensor, w: dict) -> torch.Tensor:
    """y = x @ W_hat without materialising W_hat: through the fused kernel
    when one is registered, else the einsum form.  Grouped weights (C with
    a leading expert axis) take the grouped path, where x's leading axis is
    the expert axis."""
    if is_grouped(w):
        return apply_compressed_grouped(x, w)
    if _BITLINEAR_FUSED_IMPL is not None:
        return _FusedApply.apply(x, w["m_packed"], w["C"])
    return apply_compressed_einsum(x, w)


def compressed_num_bytes(w: dict) -> int:
    return w["m_packed"].numel() + w["C"].numel() * w["C"].element_size()


def dequantize(w: dict, dtype=None) -> torch.Tensor:
    """Materialise W_hat = scale * q.  Leading stack dims (grouped expert
    weights) are preserved: (..., r, c, tn, td) -> (..., r*tn, c*td)."""
    q, scale = w["q"], w["scale"]
    dtype = dtype or scale.dtype
    tiles = q.to(torch.float32) * scale                         # (..., r, c, tn, td)
    r, c, tn, td = tiles.shape[-4:]
    lead = tiles.shape[:-4]
    n = len(lead)
    tiles = tiles.permute(*range(n), n, n + 2, n + 1, n + 3)
    return tiles.reshape(*lead, r * tn, c * td).to(dtype)


def apply_intquant(x: torch.Tensor, w: dict) -> torch.Tensor:
    """y = x @ (scale * q) by per-tile dequant-einsum in x's dtype.  4-D
    tiles take the layer path (x (..., d_in)); 5-D grouped stacks take the
    MoE dispatch layout (x (E, ..., d_in)), as ``apply_compressed_grouped``."""
    q, scale = w["q"], w["scale"]
    W = q.to(x.dtype) * scale.to(x.dtype)                       # (..., r, c, tn, td)
    if q.ndim == 5:
        E, r, c, tn, td = q.shape
        if x.shape[0] != E:
            raise ValueError(f"grouped intquant: x {tuple(x.shape)} vs q {tuple(q.shape)}")
        lead = x.shape[1:-1]
        y = torch.einsum("etrn,ercnd->etcd", x.reshape(E, -1, r, tn), W)
        return y.reshape(E, *lead, c * td)
    r, c, tn, td = q.shape
    lead = x.shape[:-1]
    y = torch.einsum("...rn,rcnd->...cd", x.reshape(*lead, r, tn), W)
    return y.reshape(*lead, c * td)


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
