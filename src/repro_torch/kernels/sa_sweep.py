"""Batched simulated-annealing sweeps for Ising solves (kernel K1).

Counterpart of ``repro/kernels/sa_sweep.py``.  ``sa_sweep_many`` launches
the hand-written CUDA kernel ``csrc/sa_sweep.cu`` for CUDA tensors and runs
the plain version (``ref.sa_sweep_many_ref``) for CPU tensors; both consume
the same pre-drawn uniforms and initial spins, so they realise the same
Metropolis chains.  ``sq_sweep_many`` is the constant-temperature path;
``sa_sweep`` is the single-problem wrapper (one problem's chains in one
launch).
``lanes_per_chain`` is the kernel's schedule rule; ``max_spins`` and
``MAX_SPINS`` mirror the rule that picks its body (``shared_body``: B in
shared memory up to ``max_spins(C)`` spins, else read from device memory
up to ``MAX_SPINS``, both in ``csrc/anneal_step.cuh``), and
``global_warps`` the one that splits a chain of the global-memory body over
a block's warps when the chains are few; ``expf_decreases`` counts
on the card the floats at which the kernel's ``expf`` would break the
exactness of its acceptance thresholds (``csrc/anneal_step.cuh``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import sa_sweep_many_ref

__all__ = ["sa_sweep", "sa_sweep_many", "sa_sweep_many_global", "sq_sweep_many", "max_spins",
           "shared_body", "MAX_SPINS", "global_warps", "lanes_per_chain", "direct_acceptance",
           "expf_decreases"]

# csrc/anneal_step.cuh's kSaSmemBytes, kSaMaxWarps, kSaSharedMaxSpins,
# kSaGlobalMaxSpins (tests/test_torch_guards.py holds them to the header)
_SMEM_BYTES = 232448      # shared memory one block may use on Hopper
_MAX_WARPS = 8            # warps per block
_SHARED_MAX_SPINS = 256   # the shared-memory body: 8 spins per lane at 32 lanes
MAX_SPINS = 1024          # the global-memory body: 32 spins per lane
_SPLIT_WARPS = 8          # kSaSplitWarps: warps one chain is split over, at most
_SPLIT_GROUP = 16         # kSaSplitGroup: rows of B a group of the split form's ring
_SM_SMEM_BYTES = 233472   # kSaSmSmemBytes: shared memory of one SM on Hopper
_BLOCK_RESERVED = 1024    # kSaBlockReservedBytes: of it reserved a resident block
_SPLIT_TWO_WAVES = 512    # kSaSplitTwoWaveSpins: spins from which two waves are split
_MAX_SPL = 8              # spins per lane (the shared body's largest template)
_FILL_CHAINS = 4096       # chains from which the card is full at 8 chains per warp


def shared_body(n: int, chains: int) -> bool:
    """Whether a launch of ``chains`` chains of n spins runs the shared-
    memory body: B (n*n floats) plus one spin row per warp (at most 8) fit
    a block's shared memory, and n <= 256.  Else the global-memory body
    runs, up to ``MAX_SPINS``."""
    w = min(chains, _MAX_WARPS)
    return n <= _SHARED_MAX_SPINS and 4 * (n * n + w * n) <= _SMEM_BYTES


def max_spins(chains: int) -> int:
    """Largest n the shared-memory body takes at ``chains`` chains."""
    n = _SHARED_MAX_SPINS
    while not shared_body(n, chains):
        n -= 1
    return n


def split_smem_bytes(n: int) -> int:
    """Shared memory of one block of the global-memory body's split form
    (``csrc/anneal_step.cuh::sa_split_smem_bytes``): 16 bytes a spin, 128
    of mbarriers, and a ring of B's rows (each n + 3 floats rounded up to 4)
    in groups of 16, as many groups as the block's limit holds, 2 to 8."""
    n4, stride = (n + 3) & ~3, (n + 6) & ~3
    fixed = 16 * n4 + 128
    groups = min(8, max(2, (_SMEM_BYTES - fixed) // (4 * _SPLIT_GROUP * stride)))
    return fixed + 4 * _SPLIT_GROUP * groups * stride


def global_warps(chains: int, n: int, sms: int) -> int:
    """Warps one chain takes in the global-memory body (``csrc/
    anneal_step.cuh::sa_global_warps``): split over W = ceil(n / (32 m))
    warps of a block, m = ceil(n / 256) spins a lane, while the ``chains``
    blocks run in one wave on the ``sms`` SMs (as many an SM as their
    shared memory allows: one at every n it serves), or in two from 512
    spins on; else 1, a warp a chain."""
    m = max(1, -(-n // (32 * _SPLIT_WARPS)))
    w = -(-n // (32 * m))
    per_sm = _SM_SMEM_BYTES // (split_smem_bytes(n) + _BLOCK_RESERVED)
    waves = 2 if n >= _SPLIT_TWO_WAVES else 1
    return w if chains <= sms * per_sm * waves else 1


def lanes_per_chain(P: int, C: int, n: int) -> int:
    """Lanes per chain (4, 8, 16 or 32) of a launch of P problems x C chains
    of n spins.  A warp holds chains of one problem.  When the chains fill
    the card (>= _FILL_CHAINS) the kernel is bound by the instructions it
    issues, and packing 32 / L chains per warp makes one acceptance, one
    shuffle and the field updates of each lane serve them all: as few lanes
    as the problem's chains allow.  When chains are few, one chain's
    dependent path sets the time, and 32 lanes keep each step's field
    update to ceil(n / 32) spins per lane.  Never fewer lanes than 8 spins
    per lane allow."""
    lanes = 32
    if P * C >= _FILL_CHAINS:
        per_warp = 1
        while per_warp * 2 <= min(C, 8):
            per_warp *= 2
        lanes = 32 // per_warp
    while lanes < 32 and -(-n // lanes) > _MAX_SPL:
        lanes *= 2
    return lanes


def direct_acceptance(P: int, C: int) -> bool:
    """Whether a launch's steps evaluate the acceptance (a division and
    expf) on their uniforms instead of thresholds found before the sweeps
    (``csrc/anneal_step.cuh``).  When the chains fill the card the kernel is
    bound by what it issues: one step's evaluation serves the 32 / L chains
    of a warp, where the threshold pass evaluates the same two
    multi-function-unit operations ~8 times per uniform.  When chains are
    few, one chain's dependent path sets the time and the threshold takes
    the division and expf off it."""
    return P * C >= _FILL_CHAINS


def _lib():
    lib = _build.load("sa_sweep")
    fn = lib.sa_sweep_many_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def expf_decreases(device, library: str = "sa_sweep") -> int:
    """The number of floats z <= 0 at which ``expf``, as ``csrc/<library>.cu``
    compiles it, decreases: every one of them, counted on the card.  The
    annealers' acceptance thresholds are exact iff it is 0."""
    lib = _build.load(library)
    fn = lib.anneal_expf_decreases
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(1, dtype=torch.int64, device=device)
    err = fn(out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"expf_decreases: CUDA launch failed (cudaError {err})")
    return int(out.item())


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
    if n > MAX_SPINS:
        raise ValueError(
            f"sa_sweep_many: n={n} spins exceed the kernel's limit of {MAX_SPINS} "
            "(its global-memory body)"
        )
    x = torch.empty((P, C, n), dtype=torch.float32, device=h.device)
    e = torch.empty((P, C), dtype=torch.float32, device=h.device)
    if P == 0 or C == 0:
        return x, e
    shared = shared_body(n, C)
    lanes = lanes_per_chain(P, C, n) if shared else 32
    if not shared and B.data_ptr() % 16:
        B = B.clone()            # the global-memory body copies B's rows in 16-byte pieces
    direct = direct_acceptance(P, C)
    # the acceptance thresholds of the uniforms (none where steps decide directly)
    theta = None if direct else torch.empty_like(rand)
    body = ctypes.c_int(-1)      # the body the launch ran, as it reports it
    err = _lib()(
        h.data_ptr(), B.data_ptr(), x0.data_ptr(), rand.data_ptr(),
        temps.data_ptr(), None if theta is None else theta.data_ptr(), x.data_ptr(),
        e.data_ptr(), P, C, S, n, lanes, int(direct),
        torch.cuda.current_stream(h.device).cuda_stream, ctypes.byref(body),
    )
    if err != 0:
        raise RuntimeError(f"sa_sweep_many: CUDA launch failed (cudaError {err})")
    sa_sweep_many.launches += 1
    sa_sweep_many.by_body[_BODIES[body.value]] += 1
    return x, e


# launches, and of them by body, as each launch reports it: the shared-
# memory one, the global-memory one a warp a chain or each chain split over
# a block's warps
_BODIES = ("shared", "global/warp", "global/split")
sa_sweep_many.launches = 0
sa_sweep_many.by_body = {"shared": 0, "global/warp": 0, "global/split": 0}


def sa_sweep_many_global(h, B, x0, rand, temps, split=None):
    """``sa_sweep_many`` through the global-memory body at any n up to
    ``MAX_SPINS``, whichever body the rule picks: CUDA tensors only, for
    holding the two bodies to each other.  ``split`` pins its form (True:
    each chain over a block's warps, False: a warp a chain; None:
    :func:`global_warps`'s rule).  Not counted in ``launches``."""
    P, C, n = x0.shape
    if h.device.type != "cuda" or n > MAX_SPINS:
        raise ValueError(f"sa_sweep_many_global: CUDA tensors of at most {MAX_SPINS} spins")
    lib = _build.load("sa_sweep")
    fn = lib.sa_sweep_many_global_split_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    x = torch.empty((P, C, n), dtype=torch.float32, device=h.device)
    e = torch.empty((P, C), dtype=torch.float32, device=h.device)
    if B.data_ptr() % 16:
        B = B.clone()
    direct = direct_acceptance(P, C)
    theta = None if direct else torch.empty_like(rand)
    err = fn(h.data_ptr(), B.data_ptr(), x0.data_ptr(), rand.data_ptr(), temps.data_ptr(),
             None if theta is None else theta.data_ptr(), x.data_ptr(), e.data_ptr(),
             P, C, temps.shape[1], n, -1 if split is None else int(split), int(direct),
             torch.cuda.current_stream(h.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"sa_sweep_many_global: CUDA launch failed (cudaError {err})")
    return x, e


def sq_sweep_many(h, B, x0, rand, temperature: float = 0.1):
    """Simulated quench: the SA kernel at one constant temperature."""
    P, _, S, _ = rand.shape
    temps = torch.full((P, S), temperature, dtype=torch.float32, device=rand.device)
    return sa_sweep_many(h, B, x0, rand, temps)


def sa_sweep(h, B, x0, rand, temps):
    """Single-problem SA: h (n,), B (n, n) symmetric zero-diagonal, x0
    (chains, n) +-1, rand (chains, sweeps, n) uniforms, temps (sweeps,) ->
    (x (chains, n), energy (chains,)).  ``sa_sweep_many`` on a batch of one
    problem: K1 on CUDA tensors, its plain version on CPU ones."""
    x, e = sa_sweep_many(h[None].contiguous(), B[None].contiguous(), x0[None].contiguous(),
                         rand[None].contiguous(), temps[None].contiguous())
    return x[0], e[0]
