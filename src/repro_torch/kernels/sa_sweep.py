"""Batched simulated-annealing sweeps for Ising solves (kernel K1).

Counterpart of ``repro/kernels/sa_sweep.py``.  ``sa_sweep_many`` launches
the hand-written CUDA kernel ``csrc/sa_sweep.cu`` for CUDA tensors and runs
the plain version (``ref.sa_sweep_many_ref``) for CPU tensors; both consume
the same pre-drawn uniforms and initial spins, so they realise the same
Metropolis chains.  ``sq_sweep_many`` is the constant-temperature path.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sa_sweep_many_ref

__all__ = ["sa_sweep_many", "sq_sweep_many", "max_spins"]

_SMEM_BYTES = 232448      # shared memory one block may use on Hopper
_MAX_WARPS = 8            # chains per block (csrc/sa_sweep.cu kMaxWarps)


def max_spins(chains: int) -> int:
    """Largest n the kernel takes: B (n*n floats) plus one spin row per
    warp in shared memory, and at most 256 spins (8 per lane)."""
    w = min(chains, _MAX_WARPS)
    n = 256
    while 4 * (n * n + w * n) > _SMEM_BYTES:
        n -= 1
    return n


def _lib():
    lib = _build.load("sa_sweep")
    fn = lib.sa_sweep_many_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sa_sweep_many(h, B, x0, rand, temps):
    """Batched SA: h (P, n), B (P, n, n) symmetric zero-diagonal, x0
    (P, C, n) +-1, rand (P, C, S, n) uniforms in [0, 1), temps (P, S) ->
    (x (P, C, n), energy (P, C)), all float32."""
    if h.device.type == "cpu":
        return sa_sweep_many_ref(h, B, x0, rand, temps)
    if h.device.type != "cuda":
        raise ValueError(f"sa_sweep_many: unsupported device {h.device}")
    P, C, n = x0.shape
    S = temps.shape[1]
    for name, t, shape in (
        ("h", h, (P, n)), ("B", B, (P, n, n)), ("x0", x0, (P, C, n)),
        ("rand", rand, (P, C, S, n)), ("temps", temps, (P, S)),
    ):
        if t.device != h.device:
            raise ValueError(f"sa_sweep_many: {name} on {t.device}, h on {h.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"sa_sweep_many: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sa_sweep_many: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"sa_sweep_many: {name} must be contiguous")
    if n > max_spins(C):
        raise ValueError(
            f"sa_sweep_many: n={n} spins exceed the kernel's shared-memory "
            f"limit of {max_spins(C)}"
        )
    x = torch.empty((P, C, n), dtype=torch.float32, device=h.device)
    e = torch.empty((P, C), dtype=torch.float32, device=h.device)
    if P == 0 or C == 0:
        return x, e
    err = _lib()(
        h.data_ptr(), B.data_ptr(), x0.data_ptr(), rand.data_ptr(),
        temps.data_ptr(), x.data_ptr(), e.data_ptr(), P, C, S, n,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sa_sweep_many: CUDA launch failed (cudaError {err})")
    sa_sweep_many.launches += 1
    return x, e


sa_sweep_many.launches = 0


def sq_sweep_many(h, B, x0, rand, temperature: float = 0.1):
    """Simulated quench: the SA kernel at one constant temperature."""
    P, _, S, _ = rand.shape
    temps = torch.full((P, S), temperature, dtype=torch.float32, device=rand.device)
    return sa_sweep_many(h, B, x0, rand, temps)
