"""The kernels' direct entry points, and kernel routing for the model's hot paths.

Counterpart of ``repro/kernels/ops.py``.  ``bitlinear``,
``bitlinear_grouped``, ``flash_attention``, ``sa_sweep``,
``sa_sweep_many``, ``sq_sweep_many`` and ``sqa_sweep_many`` take the
reference's parameters but ``interpret``, which has no counterpart: the
route is the tensors' device, the CUDA kernel for CUDA tensors and its
plain version for CPU ones.  ``enable_kernels()`` registers
the flash-attention adapter into :mod:`repro_torch.models.attention` (every
prefill without ``attend_cache`` runs ``kernels.flash_attention``) and the
fused bitlinear hooks into :mod:`repro_torch.core.quantized` (every
``apply_compressed`` call runs ``kernels.bitlinear.bitlinear``, or
``kernels.bitlinear.bitlinear_grouped`` for a grouped expert stack); each
is the CUDA kernel for CUDA tensors and its plain version for CPU ones.
Each fused call takes its schedule from ``kernels.autotune`` (a tuned
``kernel_schedules`` entry, else the heuristic), unless the caller pins one.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.core import quantized
from repro_torch.kernels import autotune
from repro_torch.kernels import sa_sweep as _sa
from repro_torch.kernels import sqa_sweep as _sqa
from repro_torch.kernels.bitlinear import bitlinear as _bitlinear
from repro_torch.kernels.bitlinear import bitlinear_grouped as _bitlinear_grouped
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn_lib

__all__ = [
    "bitlinear",
    "bitlinear_grouped",
    "flash_attention",
    "sa_sweep",
    "sa_sweep_many",
    "sq_sweep_many",
    "sqa_sweep_many",
    "enable_kernels",
    "disable_kernels",
    "kernels_off",
    "kernel_hooks",
    "hooks_as",
    "apply_compressed_fused",
    "apply_compressed_grouped_fused",
    "flash_attention_model_layout",
]


def bitlinear(x, m_packed, C, block_t: int = 128, mode: str = "auto", math: str = "unpack",
              r_chunk: int = 1, vmem_budget: int | None = None):
    """y (T, n_c*td) = x @ decompress(m_packed, C): kernel K3
    (``kernels.bitlinear.bitlinear``).  ``vmem_budget``, the reference's
    budget of its schedule, is the shared memory a block may take here (the
    budget of ``default_schedule`` and of the launch; default the card's)."""
    return _bitlinear(x, m_packed, C, block_t=block_t, mode=mode, math=math, r_chunk=r_chunk,
                      smem_budget=vmem_budget)


def bitlinear_grouped(x, m_packed, C, block_t: int = 128, mode: str = "auto",
                      math: str = "unpack", r_chunk: int = 1, vmem_budget: int | None = None):
    """The grouped form, one expert per leading index: kernel K4
    (``kernels.bitlinear.bitlinear_grouped``); ``vmem_budget`` as in
    :func:`bitlinear`."""
    return _bitlinear_grouped(x, m_packed, C, block_t=block_t, mode=mode, math=math,
                              r_chunk=r_chunk, smem_budget=vmem_budget)


def _f32(*ts):
    return tuple(t.to(torch.float32).contiguous() for t in ts)


def sa_sweep_many(h, B, x0, rand, temps, block_p: int | None = None):
    """Batched SA (kernel K1): h (P, n), B (P, n, n), x0 (P, C, n), rand
    (P, C, S, n), temps (P, S) -> (x (P, C, n), energy (P, C)), cast to
    float32 as the reference casts.  ``block_p``, the reference's block of
    problems a Pallas program takes, changes nothing here: the kernel lays
    out its blocks by its own rule (``sa_sweep.lanes_per_chain``)."""
    del block_p
    return _sa.sa_sweep_many(*_f32(h, B, x0, rand, temps))


def sq_sweep_many(h, B, x0, rand, temperature: float = 0.1, block_p: int | None = None):
    """Simulated quench: K1 at one constant temperature (``block_p`` as in
    :func:`sa_sweep_many`)."""
    del block_p
    return _sa.sq_sweep_many(*_f32(h, B, x0, rand), temperature=temperature)


def sa_sweep(h, B, x0, rand, temps):
    """One problem: h (n,), B (n, n), x0 (C, n), rand (C, S, n), temps (S,)
    -> (x (C, n), energy (C,)), cast to float32: ``kernels.sa_sweep.sa_sweep``
    (K1 at P = 1)."""
    return _sa.sa_sweep(*_f32(h, B, x0, rand, temps))


def sqa_sweep_many(h, B, X0, rand, jperps, temperature: float = 0.05):
    """Path-integral SQA over Trotter replicas (kernel K2), cast to float32
    as the reference casts; shapes as ``kernels.sqa_sweep.sqa_sweep_many``."""
    return _sqa.sqa_sweep_many(*_f32(h, B, X0, rand, jperps), temperature=temperature)


def flash_attention_model_layout(qh, k, v, window: int):
    """The attention layer's layout: q (B, S, KV, rep, hd), k/v (B, S, KV,
    hd) -> (B, S, KV, rep, hd).  Heads are KV-major, so query head
    h = g * rep + r reads kv head g = h // rep, as the kernel does.  The
    kernel reads (B, H, S, hd) views of the model's tensors and writes o
    in the model's layout: no copies.  Under autograd it refuses, as
    ``flash_attention`` does (K5 has no backward)."""
    B, S, KV, rep, hd = qh.shape
    q = qh.reshape(B, S, KV * rep, hd)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), window,
                    out=o.transpose(1, 2))
    return o.reshape(B, S, KV, rep, hd)


def enable_kernels() -> None:
    """Route attention prefill through K5, compressed layers through K3 and
    compressed expert stacks through K4.  The hooks are process-global;
    ``disable_kernels()`` removes them all.  A ``serving.Engine`` records
    its setting at construction and applies it only around its own work."""
    attn_lib.register_flash(flash_attention_model_layout)
    quantized.register_bitlinear_fused(apply_compressed_fused)
    quantized.register_bitlinear_grouped(apply_compressed_grouped_fused)


def disable_kernels() -> None:
    attn_lib.clear_flash()
    quantized.clear_bitlinear()


def kernel_hooks() -> tuple:
    """The hooks registered now (flash attention; the partial, fused and
    grouped bitlinear), for ``hooks_as``."""
    return (attn_lib._FLASH_IMPL, quantized._BITLINEAR_IMPL,
            quantized._BITLINEAR_FUSED_IMPL, quantized._BITLINEAR_GROUPED_IMPL)


def _set_hooks(hooks: tuple) -> None:
    (attn_lib._FLASH_IMPL, quantized._BITLINEAR_IMPL,
     quantized._BITLINEAR_FUSED_IMPL, quantized._BITLINEAR_GROUPED_IMPL) = hooks


@contextlib.contextmanager
def hooks_as(hooks: tuple):
    """Register ``hooks`` (a ``kernel_hooks()`` tuple) for the block's
    duration and restore whatever was registered before."""
    saved = kernel_hooks()
    _set_hooks(hooks)
    try:
        yield
    finally:
        _set_hooks(saved)


def kernels_off():
    """Clear the flash-attention and bitlinear hooks for the block's
    duration and restore whatever was registered: the kernels have no
    backward, so gradients (calibration, training) take the plain path."""
    return hooks_as((None, None, None, None))


def _schedule_kwargs(schedule, mode: str, block_t: int, resolve) -> dict:
    """An explicit ``schedule`` pins everything; ``mode="auto"`` resolves
    through the autotuner; any other ``mode`` is taken as given."""
    if schedule is None and mode == "auto":
        schedule = resolve()
    if schedule is not None:
        return schedule.kwargs()
    return {"mode": mode, "block_t": block_t}


def apply_compressed_fused(x, w, block_t: int = 128, mode: str = "auto",
                           schedule: autotune.Schedule | None = None):
    """y = (x @ M) @ C through the bitlinear kernel; x (..., d_in) ->
    (..., d_out) with any leading dims flattened into the kernel's T axis.
    Schedule selection as in ``repro.kernels.ops.apply_compressed_fused``."""
    C = w["C"]
    n_c, td = C.shape[1], C.shape[3]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kw = _schedule_kwargs(schedule, mode, block_t,
                          lambda: autotune.resolve_fused(x2, w["m_packed"], C))
    y = _bitlinear(x2, w["m_packed"], C, **kw)
    return y.reshape(*lead, n_c * td)


def apply_compressed_grouped_fused(x, w, block_t: int = 128, mode: str = "auto",
                                   schedule: autotune.Schedule | None = None):
    """y_e = (x_e @ M_e) @ C_e through the grouped bitlinear kernel; x (E,
    ..., d_in) -> (E, ..., d_out) with the inner lead dims (the MoE (B, C)
    dispatch dims) flattened into the kernel's T axis.  The dispatch
    einsum's output is strided: it is made contiguous here, once.
    Schedule selection as in :func:`apply_compressed_fused`."""
    C = w["C"]
    E, n_c, td = C.shape[0], C.shape[2], C.shape[4]
    lead = x.shape[1:-1]
    x3 = x.reshape(E, -1, x.shape[-1]).contiguous()
    kw = _schedule_kwargs(schedule, mode, block_t,
                          lambda: autotune.resolve_grouped(x3, w["m_packed"], C))
    y = _bitlinear_grouped(x3, w["m_packed"], C, **kw)
    return y.reshape(E, *lead, n_c * td)
