"""Fused compressed linear layer y = (x @ M) @ C (kernel K3) and its grouped
per-expert form (kernel K4).

Counterpart of ``repro/kernels/bitlinear.py::bitlinear`` and
``::bitlinear_grouped``.  For CUDA tensors ``bitlinear`` and
``bitlinear_grouped`` launch the hand-written kernel ``csrc/bitlinear.cu``
(one schedule: a (row block, [expert,] column tile) grid with the r
reduction looped inside the block; the grouped call runs every expert in
one launch); for CPU tensors they run the plain versions
``ref.bitlinear_ref`` and ``ref.bitlinear_grouped_ref``.  Float32 and
bfloat16 activations; the int8 activation path and the
``decode``/``stream``/``bitplane`` variants of the JAX kernels are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitlinear_grouped_ref, bitlinear_ref

__all__ = ["bitlinear", "bitlinear_grouped"]

_FLOATS = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535          # experts x column tiles share blockIdx.y


def _lib(name: str):
    fn = getattr(_build.load("bitlinear"), name)
    n_ints = 9 if name == "bitlinear" else 10
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name, x, m_packed, C, lead: int):
    """Validate shapes and dtypes; ``lead`` is 1 for the grouped form (a
    leading expert axis on all three) and 0 for the plain one."""
    if x.ndim != 2 + lead or m_packed.ndim != 4 + lead or C.ndim != 4 + lead:
        e = "E, " if lead else ""
        raise ValueError(
            f"{name}: want x ({e}T, d_in), m_packed ({e}r, c, tn, kb), C ({e}r, c, K, td); "
            f"got {tuple(x.shape)}, {tuple(m_packed.shape)}, {tuple(C.shape)}"
        )
    n_r, n_c, tn, kb = m_packed.shape[lead:]
    K = C.shape[lead + 2]
    if (n_r * tn != x.shape[-1] or tuple(C.shape[lead:lead + 2]) != (n_r, n_c)
            or kb != (K + 7) // 8
            or (lead and not x.shape[0] == m_packed.shape[0] == C.shape[0])):
        raise ValueError(
            f"{name}: inconsistent shapes x {tuple(x.shape)}, "
            f"m_packed {tuple(m_packed.shape)}, C {tuple(C.shape)}"
        )
    if m_packed.dtype != torch.uint8:
        raise TypeError(f"{name}: m_packed must be uint8, got {m_packed.dtype}")
    if x.dtype not in _FLOATS or C.dtype not in _FLOATS:
        raise NotImplementedError(
            f"{name}: x {x.dtype} / C {C.dtype}: only float32 and bfloat16 "
            "are ported (int8 activations: ROADMAP.md)"
        )


def _launch(name, x, m_packed, C, y, dims) -> None:
    """Launch ``csrc/bitlinear.cu::<name>`` on x's device and stream;
    ``dims`` are its integer shape arguments."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for arg, t in (("m_packed", m_packed), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and m_packed.is_contiguous() and C.is_contiguous()):
        raise ValueError(f"{name}: x, m_packed and C must be contiguous")
    err = _lib(name)(
        x.data_ptr(), m_packed.data_ptr(), C.data_ptr(), y.data_ptr(), *dims,
        int(x.dtype == torch.bfloat16), int(C.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def bitlinear(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y (T, n_c*td) = x @ decompress(m_packed, C) for x (T, d_in),
    m_packed (n_r, n_c, tn, kb) uint8 and C (n_r, n_c, K, td); any T."""
    _check("bitlinear", x, m_packed, C, 0)
    if x.device.type == "cpu":
        return bitlinear_ref(x, m_packed, C)
    T = x.shape[0]
    n_r, n_c, tn, kb = m_packed.shape
    K, td = C.shape[2], C.shape[3]
    x = x.contiguous()
    y = torch.empty((T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    _launch("bitlinear", x, m_packed, C, y, (T, n_r, n_c, tn, kb, K, td))
    bitlinear.launches += 1
    return y


def bitlinear_grouped(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y_e (T, n_c*td) = x_e @ decompress(m_packed_e, C_e) for every expert
    e in one launch: x (E, T, d_in), m_packed (E, n_r, n_c, tn, kb) uint8,
    C (E, n_r, n_c, K, td) -> (E, T, n_c*td); any T (one T for all
    experts), any E >= 1."""
    _check("bitlinear_grouped", x, m_packed, C, 1)
    if x.device.type == "cpu":
        return bitlinear_grouped_ref(x, m_packed, C)
    E, T, _ = x.shape
    _, n_r, n_c, tn, kb = m_packed.shape
    K, td = C.shape[3], C.shape[4]
    if E * n_c > _MAX_GRID_Y:
        raise ValueError(f"bitlinear_grouped: E * n_c = {E * n_c} exceeds {_MAX_GRID_Y}")
    x = x.contiguous()
    y = torch.empty((E, T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0 or E == 0:
        return y
    _launch("bitlinear_grouped", x, m_packed, C, y, (E, T, n_r, n_c, tn, kb, K, td))
    bitlinear_grouped.launches += 1
    return y


bitlinear.launches = 0
bitlinear_grouped.launches = 0
