"""Fused compressed linear layer y = (x @ M) @ C (kernel K3).

Counterpart of ``repro/kernels/bitlinear.py::bitlinear``.  For CUDA tensors
``bitlinear`` launches the hand-written kernel ``csrc/bitlinear.cu`` (one
schedule: a (row block, column tile) grid with the r reduction looped
inside the block); for CPU tensors it runs the plain version
``ref.bitlinear_ref``.  Float32 and bfloat16 activations; the int8
activation path and the ``decode``/``stream``/``bitplane`` variants of the
JAX kernel are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitlinear_ref

__all__ = ["bitlinear"]

_FLOATS = (torch.float32, torch.bfloat16)


def _lib():
    fn = _build.load("bitlinear").bitlinear
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bitlinear(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y (T, n_c*td) = x @ decompress(m_packed, C) for x (T, d_in),
    m_packed (n_r, n_c, tn, kb) uint8 and C (n_r, n_c, K, td); any T."""
    if x.ndim != 2 or m_packed.ndim != 4 or C.ndim != 4:
        raise ValueError(
            f"bitlinear: want x (T, d_in), m_packed (r, c, tn, kb), C (r, c, K, td); "
            f"got {tuple(x.shape)}, {tuple(m_packed.shape)}, {tuple(C.shape)}"
        )
    T, d_in = x.shape
    n_r, n_c, tn, kb = m_packed.shape
    K, td = C.shape[2], C.shape[3]
    if n_r * tn != d_in or tuple(C.shape[:2]) != (n_r, n_c) or kb != (K + 7) // 8:
        raise ValueError(
            f"bitlinear: inconsistent shapes x {tuple(x.shape)}, "
            f"m_packed {tuple(m_packed.shape)}, C {tuple(C.shape)}"
        )
    if m_packed.dtype != torch.uint8:
        raise TypeError(f"bitlinear: m_packed must be uint8, got {m_packed.dtype}")
    if x.dtype not in _FLOATS or C.dtype not in _FLOATS:
        raise NotImplementedError(
            f"bitlinear: x {x.dtype} / C {C.dtype}: only float32 and bfloat16 "
            "are ported (int8 activations: ROADMAP.md)"
        )
    if x.device.type == "cpu":
        return bitlinear_ref(x, m_packed, C)
    if x.device.type != "cuda":
        raise ValueError(f"bitlinear: unsupported device {x.device}")
    for name, t in (("m_packed", m_packed), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"bitlinear: {name} on {t.device}, x on {x.device}")
    x = x.contiguous()
    if not (m_packed.is_contiguous() and C.is_contiguous()):
        raise ValueError("bitlinear: m_packed and C must be contiguous")
    y = torch.empty((T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    err = _lib()(
        x.data_ptr(), m_packed.data_ptr(), C.data_ptr(), y.data_ptr(),
        T, n_r, n_c, tn, kb, K, td,
        int(x.dtype == torch.bfloat16), int(C.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"bitlinear: CUDA launch failed (cudaError {err})")
    bitlinear.launches += 1
    return y


bitlinear.launches = 0
