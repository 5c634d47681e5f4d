"""Batched simulated-quantum-annealing sweeps over Trotter replicas (kernel K2).

Counterpart of ``repro/kernels/sqa_sweep.py``, the quench behind the
paper's "QA" solver.  ``sqa_sweep_many`` launches the hand-written CUDA
kernel ``csrc/sqa_sweep.cu`` for CUDA tensors and runs the plain version
(``ref.sqa_sweep_many_ref``) for CPU tensors; both consume the same initial
replicas, pre-drawn uniforms and couplings, so they realise the same chains.
``wavefront_schedule`` gives the kernel its groups and skew: the rows
(sweep, slice) of a chain run as a wavefront, row r starting spin i at step
d*r + i, which keeps every addition and every neighbour read of the
sequential order.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sqa_sweep_many_ref

__all__ = ["sqa_sweep_many", "max_spins", "wavefront_schedule", "wavefront_skew"]

_SMEM_BYTES = 232448      # shared memory one block may use on Hopper
_MAX_WARPS = 8            # chains per block of the slice-at-a-time kernel (max_spins)
_MAX_GROUPS = 8           # rows in flight per chain (csrc/sqa_sweep.cu kMaxGroups), a warp each


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wavefront_skew(T: int, n: int, G: int) -> int:
    """The least skew d at which row r (= sweep * T + slice) of a chain of
    T slices of n spins may run spin i at step d*r + i on G groups.  Step
    (r, i) needs (r, i - 1), (r - 1, i) and the whole of row r - T, and
    reads X[q + 1, i] as row r - T + 1 left it: d >= ceil(n / T) keeps
    every dependency, and d >= ceil(n / G) lets each group finish a row
    before its next one (row r + G) starts."""
    return max(_cdiv(n, T), _cdiv(n, G))


def wavefront_schedule(T: int, n: int) -> tuple[int, int]:
    """(G, d) for a chain of T slices of n spins: G = min(T, 8) groups (a
    warp each), group g running rows g, g + G, ..., at skew d
    (``wavefront_skew``)."""
    G = min(T, _MAX_GROUPS)
    return G, wavefront_skew(T, n, G)


def max_spins(chains: int, n_trotter: int) -> int:
    """Largest n the kernel takes: B (n*n floats) plus, for min(chains, 8)
    chains, the replicas and fields (2*T*n floats) in shared memory (a
    block holds one chain since the wavefront design: the bound is kept as
    it was), and at most 256 spins."""
    w = min(chains, _MAX_WARPS)
    n = 256
    while n > 0 and 4 * (n * n + w * 2 * n_trotter * n) > _SMEM_BYTES:
        n -= 1
    return n


def _lib():
    lib = _build.load("sqa_sweep")
    fn = lib.sqa_sweep_many_f32
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
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
    G, d = wavefront_schedule(T, n)
    theta = torch.empty_like(rand)      # the acceptance thresholds of the uniforms
    err = _lib()(
        h.data_ptr(), B.data_ptr(), X0.data_ptr(), rand.data_ptr(), jperps.data_ptr(),
        theta.data_ptr(), X.data_ptr(), E.data_ptr(), P, C, T, S, n, G, d, temperature,
        torch.cuda.current_stream(h.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"sqa_sweep_many: CUDA launch failed (cudaError {err})")
    sqa_sweep_many.launches += 1
    return X, E


sqa_sweep_many.launches = 0
