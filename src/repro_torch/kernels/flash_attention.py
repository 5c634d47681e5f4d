"""Causal (optionally sliding-window) GQA flash attention (kernel K5).

Counterpart of ``repro/kernels/flash_attention.py::flash_attention``.  For
CUDA tensors ``flash_attention`` launches the hand-written kernel
``csrc/flash_attention.cu`` (bf16 on the tensor cores with mma.sync, f32 on
the FMA pipes; kv tiles from the window's first to the diagonal, online
softmax in f32); for CPU tensors it runs the plain version
``ref.flash_attention_ref``.  Layouts: q (B, H, S, hd), k/v (B, KV, S, hd)
-> o (B, H, S, hd) in q's dtype; query head h reads kv head h // (H // KV).
The kernel addresses each tensor through its batch, head and sequence
strides, so views of another layout (the model's (B, S, H, hd)) need no
copies, and ``out`` receives o in the caller's layout.

K5 has no backward, and neither has the Pallas kernel it ports: while
autograd records a graph through q, k or v, ``flash_attention`` raises
rather than return an output that would cut the gradient (on the card, the
kernel's output has no ``grad_fn``).  Gradients take the model's plain
attention (``kernels.ops.kernels_off``).
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
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _addressable(t: torch.Tensor) -> bool:
    """The kernel reads t through its (batch, head, sequence) strides with
    hd contiguous; the bf16 body copies 16-byte rows with cp.async, so its
    strides must be multiples of 8 elements and its data 16-byte aligned."""
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        return False
    if t.dtype != torch.bfloat16:
        return True
    return t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """o (B, H, S, hd) = causal softmax(q k^T / sqrt(hd)) v, restricted to
    the last ``window`` positions when ``window > 0``; any S.  q, k and v
    may be strided views; o is written into ``out`` (a (B, H, S, hd) view
    of the caller's buffer) when given, else into a new contiguous tensor,
    and returned."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention: kernel K5 has no backward (nor has the Pallas kernel it "
            "ports), so it refuses q/k/v that require grad; clear the hooks "
            "(kernels.ops.kernels_off / disable_kernels) to differentiate through the "
            "model's plain attention"
        )
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
    if out is not None and (tuple(out.shape) != tuple(q.shape) or out.dtype != q.dtype
                            or out.device != q.device):
        raise ValueError(f"flash_attention: out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}, want q's {tuple(q.shape)} {q.dtype} on {q.device}")
    if q.device.type == "cpu":
        o = flash_attention_ref(q, k, v, window)
        return o if out is None else out.copy_(o)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    q, k, v = (t if _addressable(t) else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    o = torch.empty_like(q, memory_format=torch.contiguous_format) if out is None else out
    if not _addressable(o):
        raise ValueError(f"flash_attention: out strides {o.stride()} are not addressable "
                         "by the kernel (hd contiguous; bf16: multiples of 8, 16-byte aligned)")
    if B == 0 or S == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o) for s in t.stride()[:3]))
    err = _lib()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, KV, S, hd, strides,
        int(window), 1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed (cudaError {err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
