"""Batched simulated-quantum-annealing sweeps over Trotter replicas (kernel K2).

Counterpart of ``repro/kernels/sqa_sweep.py``, the quench behind the
paper's "QA" solver.  ``sqa_sweep_many`` launches the hand-written CUDA
kernel ``csrc/sqa_sweep.cu`` for CUDA tensors and runs the plain version
(``ref.sqa_sweep_many_ref``) for CPU tensors; both consume the same initial
replicas, pre-drawn uniforms and couplings, so they realise the same chains.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sqa_sweep_many_ref

__all__ = ["sqa_sweep_many", "max_spins"]

_SMEM_BYTES = 232448      # shared memory one block may use on Hopper
_MAX_WARPS = 8            # chains per block (csrc/sqa_sweep.cu kMaxWarps)


def max_spins(chains: int, n_trotter: int) -> int:
    """Largest n the kernel takes: B (n*n floats) plus each warp's replicas
    and fields (2*T*n floats) in shared memory, and at most 256 spins."""
    w = min(chains, _MAX_WARPS)
    n = 256
    while n > 0 and 4 * (n * n + w * 2 * n_trotter * n) > _SMEM_BYTES:
        n -= 1
    return n


def _lib():
    lib = _build.load("sqa_sweep")
    fn = lib.sqa_sweep_many_f32
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def sqa_sweep_many(h, B, X0, rand, jperps, temperature: float = 0.05):
    """Batched SQA: h (P, n), B (P, n, n) symmetric zero-diagonal, X0
    (P, C, T, n) +-1 replicas, rand (P, C, S, T, n) uniforms in [0, 1),
    jperps (S,) inter-replica couplings -> (X (P, C, T, n), energy
    (P, C, T)), all float32."""
    if h.device.type == "cpu":
        return sqa_sweep_many_ref(h, B, X0, rand, jperps, temperature)
    if h.device.type != "cuda":
        raise ValueError(f"sqa_sweep_many: unsupported device {h.device}")
    P, C, T, n = X0.shape
    S = jperps.shape[0]
    for name, t, shape in (
        ("h", h, (P, n)), ("B", B, (P, n, n)), ("X0", X0, (P, C, T, n)),
        ("rand", rand, (P, C, S, T, n)), ("jperps", jperps, (S,)),
    ):
        if t.device != h.device:
            raise ValueError(f"sqa_sweep_many: {name} on {t.device}, h on {h.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"sqa_sweep_many: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sqa_sweep_many: {name} shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"sqa_sweep_many: {name} must be contiguous")
    if T < 1:
        raise ValueError("sqa_sweep_many: needs at least one Trotter replica")
    if n > max_spins(C, T):
        raise ValueError(
            f"sqa_sweep_many: n={n} spins with {T} replicas exceed the kernel's "
            f"shared-memory limit of {max_spins(C, T)} spins"
        )
    X = torch.empty((P, C, T, n), dtype=torch.float32, device=h.device)
    E = torch.empty((P, C, T), dtype=torch.float32, device=h.device)
    if P == 0 or C == 0:
        return X, E
    err = _lib()(
        h.data_ptr(), B.data_ptr(), X0.data_ptr(), rand.data_ptr(), jperps.data_ptr(),
        X.data_ptr(), E.data_ptr(), P, C, T, S, n, temperature,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sqa_sweep_many: CUDA launch failed (cudaError {err})")
    sqa_sweep_many.launches += 1
    return X, E


sqa_sweep_many.launches = 0
