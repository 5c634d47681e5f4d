"""Causal (optionally sliding-window) GQA flash attention (kernel K5).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention``.  For
CUDA tensors ``flash_attention`` launches the hand-written kernel
``csrc/flash_attention.cu`` (one block per (64-row query tile, head, batch
row), kv tiles from the window's first to the diagonal, f32 online
softmax); for CPU tensors it runs the plain version
``ref.flash_attention_ref``.  Layouts: q (B, H, S, hd), k/v (B, KV, S, hd)
-> o (B, H, S, hd) in q's dtype; query head h reads kv head h // (H // KV).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "HEAD_DIMS"]

_FLOATS = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)


def _lib():
    fn = _build.load("flash_attention").flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int = 0) -> torch.Tensor:
    """o (B, H, S, hd) = causal softmax(q k^T / sqrt(hd)) v, restricted to
    the last ``window`` positions when ``window > 0``; any S."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(
            f"flash_attention: want q (B, H, S, hd), k/v (B, KV, S, hd); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if (tuple(k.shape) != (B, KV, S, hd) or tuple(v.shape) != tuple(k.shape)
            or KV == 0 or H % KV):
        raise ValueError(
            f"flash_attention: inconsistent shapes q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}"
        )
    if q.dtype not in _FLOATS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention: q/k/v must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if hd not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    o = torch.empty_like(q)
    if B == 0 or S == 0:
        return o
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        B, H, KV, S, hd, int(window), 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed (cudaError {err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
