"""Fused compressed linear layer y = (x @ M) @ C (kernel K3) and its
grouped per-expert form (kernel K4).

Counterpart of ``repro/kernels/bitlinear.py::bitlinear`` and
``::bitlinear_grouped``.  For CUDA tensors they launch the hand-written
kernels ``csrc/bitlinear*.cu`` (design in ``csrc/bitlinear.cuh``); for CPU
tensors they run the plain versions ``ref.bitlinear_ref`` and
``ref.bitlinear_grouped_ref`` with the requested bit algebra.

Schedules (``mode``), the names of the JAX kernels' so that a tuned
``kernel_schedules`` table means the same in both packages:

  * grid: blocks of ``block_t`` rows.  bf16 x with bf16 C at T > SMALL_T
    (K <= 8, tn % 8 == 0, td % 16 == 0) runs on the tensor cores: a block
    owns four column tiles, its warps one 16-row tile each, and every step
    stages ``r_chunk`` r tiles (rounded up to whole mma groups) of x, M and
    C in shared memory; z = x @ M and y += z @ C are mma.sync products.
    ``tensor_core_launches`` counts the launches that the library reports
    ran it.  Every other call runs the FMA body: register groups of 8 rows
    x one column chunk, each warp taking ``r_chunk`` r tiles at a time.
  * decode: a kernel of its own.  Each (expert,) column tile's r tiles are
    split across the S blocks of a thread-block cluster (S from
    :func:`decode_cluster_size`); a producer warp streams
    the tiles (C, M and the T rows of x over them) into a ring of
    shared-memory stages, four consumer warps reduce them, and rank 0 adds
    the blocks' partial sums.  Its shared memory grows with T, K and td, not
    with d_in (:func:`decode_path_ok`).  ``decode_clusters`` counts its
    launches by the S passed to the launch.  ``block_t`` and ``r_chunk`` are
    ignored.
  * stream (K3 only, as in JAX): one block per column tile; each warp
    double-buffers its chunks of ``r_chunk`` M and C tiles in shared memory
    with asynchronous copies.  ``block_t`` is ignored.
  * auto: the card's default schedule for the call, :func:`default_schedule`
    (its mode, block_t and r_chunk; the caller's math).  A serve without a
    tuned table resolves the same rule (``autotune.heuristic``).
  * jnp: the plain version; the CPU route.  It is not served on the card:
    a CUDA tensor with ``mode="jnp"`` is refused.

A block's shared memory is defined once, in ``csrc/bitlinear.cuh``
(``block_smem``; decode's in ``csrc/bitlinear_decode.cuh``): the launch
refuses a block over the budget, and :func:`smem_bytes` asks the built
library for the same number.

Bit algebra (``math``): unpack or bitplane (``z = 2 (x @ B) - rowsum(x)``);
"dot" is unpack outside ``jnp``, as in JAX.  Activations are float32,
bfloat16 or int8 (exact int32 z, int8 output truncated toward zero and
saturated); C is float32 or bfloat16.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bitlinear_grouped_ref, bitlinear_ref

__all__ = [
    "bitlinear",
    "bitlinear_grouped",
    "MODES",
    "GROUPED_MODES",
    "MATHS",
    "decode_path_ok",
    "decode_cluster_size",
    "default_schedule",
    "smem_bytes",
    "device_smem_budget",
    "resolve_r_chunk",
    "reset_counts",
]

MODES = ("auto", "grid", "decode", "stream", "jnp")
GROUPED_MODES = ("auto", "grid", "decode", "jnp")
MATHS = ("unpack", "bitplane")

_X_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_KIND_OF_ITEMSIZE = {4: 0, 2: 1, 1: 2}   # x: float32, bfloat16, int8
_C_DTYPES = (torch.float32, torch.bfloat16)
_MAX_GRID_Y = 65535          # experts x column tiles share blockIdx.y
_SOURCES = {"grid": "bitlinear", "decode": "bitlinear_decode", "stream": "bitlinear_stream"}
_MODE_IDS = {"grid": 0, "decode": 1, "stream": 2}
_FNS: dict = {}           # mode -> loaded C entry point
_BUDGETS: dict = {}       # device index -> opt-in shared memory per block
_SMS: dict = {}           # device index -> streaming multiprocessors

# The card's default schedule (default_schedule): up to SMALL_T rows, K3 and
# K4 decode, in the bitplane algebra, while the block fits the budget;
# above, the grid at DEFAULT_GRID_BLOCK_T rows.  Set from the times of each
# schedule at T = 1 ... 64 that chip_smoke.py measures on an H100 (PERF.md,
# small_t_ms's device times, the host's time in the wrapper left out, summed
# over each kernel's main-path tensors): at T = 1, 2 and
# 4 decode took 0.25-0.30 ms for qwen3-32b's 8 K3 tensors against stream's
# 0.46-0.57 and the grid's 0.57-1.04, and 0.036-0.040 ms for granite's 3
# K4 stacks against the grid's 0.046-0.056.  At 8 rows K3's decode still
# led (0.55 against the grid's 0.79) but K4's grid led (0.043 against
# 0.050), and from 16 rows the grid led both, so the cutoff stayed at 4.
# The grid's tensor-core body starts above the same cutoff (every launch
# and layout query passes SMALL_T to the library), so the grid block the
# rule falls back to at T <= SMALL_T is the small FMA one.
SMALL_T = 4
DEFAULT_GRID_BLOCK_T = 64

# The decode launch's split of r (decode_cluster_size): as many blocks as
# the card holds at once, DECODE_BLOCKS_PER_SM per SM (what a decode block's
# registers and shared memory allow at T <= 4), each keeping at least
# DECODE_MIN_TILES r tiles, in clusters of up to the portable 8 blocks, or
# 16 where even 16 fill less than the card (qwen's BBO attn/w[kv]).  Set
# from tools/torch_decode_variants.py's times at every S on an H100
# (PERF.md): a split past one wave of blocks (qwen's gate at S = 2), below
# 32 r tiles a block (granite's stacks at S = 2) or to a non-portable 9
# (qwen's down: 0.046 ms against 0.034 at 8) was slower.
DECODE_BLOCKS_PER_SM = 3
DECODE_MIN_TILES = 32
DECODE_PORTABLE_CLUSTER = 8
DECODE_MAX_CLUSTER = 16


def resolve_r_chunk(n_r: int, r_chunk: int) -> int:
    """Largest divisor of n_r that is <= the requested chunk (JAX's
    ``_resolve_r_chunk``)."""
    rc = max(1, min(int(r_chunk), n_r))
    while n_r % rc:
        rc -= 1
    return rc


def smem_bytes(mode: str, *, T: int, n_r: int, tn: int, K: int, td: int, x_itemsize: int,
               c_itemsize: int, r_chunk: int = 1) -> int:
    """Dynamic shared memory of one block of ``mode`` (grid and stream: the
    warps' z buffers and the block sums, plus each warp's two M/C slots for
    stream; the tensor-core grid's stages of x, M and C and its partial
    sums; decode: its ring of stages, z buffers, partial-y slots and
    barriers, independent of n_r and r_chunk), from the built kernels' own
    layout, ``bitlinear_smem_bytes`` in ``csrc/bitlinear.cu`` (decode:
    ``bitlinear_decode_smem_bytes`` in ``csrc/bitlinear_decode.cu``).  Needs
    the CUDA toolchain: it builds the schedule's library on first use."""
    return _smem_bytes(mode, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk)


@functools.lru_cache(maxsize=4096)
def _smem_bytes(mode, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk) -> int:
    # grid and stream ask the grid library, decode its own
    lib_mode = "decode" if mode == "decode" else "grid"
    key = f"smem/{lib_mode}"
    fn = _FNS.get(key)
    if fn is None:
        lib = _build.load(_SOURCES[lib_mode])
        if lib_mode == "decode":
            fn = lib.bitlinear_decode_smem_bytes
            fn.argtypes = [ctypes.c_int] * 7
        else:
            fn = lib.bitlinear_smem_bytes
            fn.argtypes = [ctypes.c_int] * 11
        fn.restype = ctypes.c_longlong
        _FNS[key] = fn
    kind, c_bf16 = _KIND_OF_ITEMSIZE[x_itemsize], int(c_itemsize == 2)
    if mode == "decode":
        n = fn(T, tn, (K + 7) // 8, K, td, kind, c_bf16)
    else:
        n = fn(_MODE_IDS[mode], T, n_r, tn, (K + 7) // 8, K, td, kind, c_bf16, r_chunk, SMALL_T)
    if n < 0:
        raise ValueError(f"smem_bytes: bad arguments mode {mode!r}, x_itemsize {x_itemsize}, "
                         f"r_chunk {r_chunk}")
    return int(n)


def device_smem_budget(device=None) -> int:
    """The card's opt-in shared memory per block (227 KiB on an H100)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _BUDGETS:
        _BUDGETS[idx] = int(torch.cuda.get_device_properties(idx).shared_memory_per_block_optin)
    return _BUDGETS[idx]


def device_sms(device=None) -> int:
    """The card's streaming multiprocessors (132 on an H100 SXM)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _SMS:
        _SMS[idx] = int(torch.cuda.get_device_properties(idx).multi_processor_count)
    return _SMS[idx]


def decode_cluster_size(blocks: int, n_r: int, sms: int) -> int:
    """S, the blocks of a thread-block cluster that split the n_r r tiles of
    each (expert, column tile) in a decode launch over ``blocks`` = E * n_c
    such pairs: the most whose blocks still run in one wave (blocks * S <=
    DECODE_BLOCKS_PER_SM * sms) and keep ``DECODE_MIN_TILES`` r tiles a
    block, taken from 1 ... ``DECODE_PORTABLE_CLUSTER`` and
    ``DECODE_MAX_CLUSTER``; at least 1.  The one definition of S and its
    caps: the wrapper passes it to every decode launch."""
    S = min(n_r // DECODE_MIN_TILES, DECODE_BLOCKS_PER_SM * sms // max(1, blocks))
    if S >= DECODE_MAX_CLUSTER:
        return DECODE_MAX_CLUSTER
    return max(1, min(DECODE_PORTABLE_CLUSTER, S))


def decode_path_ok(T: int, n_r: int, tn: int, K: int, td: int, x_itemsize: int,
                   budget: int) -> bool:
    """Counterpart of JAX's ``_decode_path_ok``: the decode block keeps its
    ring of stages (the C and M tiles of a few r tiles and the T rows of x
    over them), z buffers and each warp's T rows of partial sums in shared
    memory; it is admissible when that fits ``budget`` bytes (f32 C, the
    larger).  It grows with T, K and td, never with n_r or d_in."""
    return smem_bytes("decode", T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=x_itemsize,
                      c_itemsize=4) <= budget


def default_schedule(*, T: int, n_r: int, tn: int, K: int, td: int, x_itemsize: int,
                     budget: int) -> dict:
    """The card's default schedule of one K3 or K4 call, the port's own cost
    model (not JAX's VMEM one): up to ``SMALL_T`` rows decode in the
    bitplane algebra, while its block fits ``budget`` bytes of shared
    memory (:func:`decode_path_ok`); otherwise the grid at
    ``DEFAULT_GRID_BLOCK_T`` rows, r_chunk 1, unpack.  Returns the fields of
    an ``autotune.Schedule``."""
    if T <= SMALL_T and decode_path_ok(T, n_r, tn, K, td, x_itemsize, budget):
        return {"mode": "decode", "math": "bitplane", "block_t": 128, "r_chunk": 1}
    return {"mode": "grid", "math": "unpack", "block_t": DEFAULT_GRID_BLOCK_T, "r_chunk": 1}


def _lib(mode: str):
    fn = _FNS.get(mode)
    if fn is None:
        fn = getattr(_build.load(_SOURCES[mode]), f"bitlinear_{mode}")
        # decode takes (..., bitplane, clusters, smem_budget, stream); grid
        # and stream (..., bitplane, block_t, r_chunk, smem_budget, small_t,
        # stream, *tensor_cores)
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
                       if mode == "decode" else
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        _FNS[mode] = fn
    return fn


def _check(name, x, m_packed, C, lead: int, mode: str, math: str, modes) -> None:
    """Validate shapes, dtypes and options; ``lead`` is 1 for the grouped
    form (a leading expert axis on all three) and 0 for the plain one."""
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
    if x.dtype not in _X_KINDS or C.dtype not in _C_DTYPES:
        raise NotImplementedError(
            f"{name}: x {x.dtype} / C {C.dtype}: x must be float32, bfloat16 or int8, "
            "C float32 or bfloat16"
        )
    if mode not in modes:
        raise ValueError(f"{name}: mode {mode!r} not in {modes}")
    if math not in MATHS + ("dot",):
        raise ValueError(f"{name}: math {math!r} not in {MATHS + ('dot',)}")


def _launch(name, mode, x, m_packed, C, y, dims, math, block_t, r_chunk, budget) -> int:
    """Launch ``csrc/bitlinear*.cu::bitlinear_<mode>`` on x's device and
    stream; ``dims`` are (E, T, n_r, n_c, tn, kb, K, td).  The library
    refuses a block over ``budget`` bytes of shared memory.  Returns for
    decode the cluster size S it was launched with (the rule's), else
    whether the library reports that the launch ran the grid's tensor-core
    body."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for arg, t in (("m_packed", m_packed), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} on {t.device}, x on {x.device}")
    if not (x.is_contiguous() and m_packed.is_contiguous() and C.is_contiguous()):
        raise ValueError(f"{name}: x, m_packed and C must be contiguous")
    E, T, n_r, n_c, tn, kb, K, td = dims
    if E * n_c > _MAX_GRID_Y:
        raise ValueError(f"{name}: E * n_c = {E * n_c} exceeds {_MAX_GRID_Y}")
    if block_t < 1:
        raise ValueError(f"{name}: block_t {block_t} < 1")
    # the tensor-core grid copies x and C in 16-byte and M in 4-byte units:
    # a view that starts elsewhere in its buffer is cloned
    if x.data_ptr() % 16 or m_packed.data_ptr() % 16 or C.data_ptr() % 16:
        x, m_packed, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, m_packed, C))
    ran = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if mode == "decode":
        S = decode_cluster_size(E * n_c, n_r, device_sms(x.device))
        opts = (S, int(budget), stream)
    else:
        opts = (int(block_t), int(r_chunk), int(budget), SMALL_T, stream, ctypes.byref(ran))
    err = _lib(mode)(
        x.data_ptr(), m_packed.data_ptr(), C.data_ptr(), y.data_ptr(), *dims,
        _X_KINDS[x.dtype], int(C.dtype == torch.bfloat16), int(math == "bitplane"), *opts,
    )
    if err < 0:
        raise ValueError(f"{name}: mode {mode!r} needs {-err} bytes of shared memory per "
                         f"block, over the budget of {budget}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch of mode {mode!r} failed (cudaError {err})")
    return S if mode == "decode" else ran.value


def _card_schedule(mode, x, T, n_r, tn, K, td, block_t, r_chunk, budget):
    """(mode, block_t, r_chunk, budget) of a call on the card: "auto" takes
    the default rule's, the budget defaults to the card's opt-in limit."""
    budget = device_smem_budget(x.device) if budget is None else budget
    if mode == "auto":
        s = default_schedule(T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=x.element_size(),
                             budget=budget)
        mode, block_t, r_chunk = s["mode"], s["block_t"], s["r_chunk"]
    rc = resolve_r_chunk(n_r, r_chunk) if mode != "decode" else 1
    return mode, block_t, rc, budget


def _count(fn, mode: str, math: str, ran: int) -> None:
    fn.launches += 1
    fn.by_schedule[f"{mode}/{math}"] += 1
    if mode == "decode":
        fn.decode_clusters[ran] = fn.decode_clusters.get(ran, 0) + 1
    else:
        fn.tensor_core_launches += ran


def bitlinear(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor, block_t: int = 128,
              mode: str = "auto", math: str = "unpack", r_chunk: int = 1,
              smem_budget: int | None = None) -> torch.Tensor:
    """y (T, n_c*td) = x @ decompress(m_packed, C) for x (T, d_in),
    m_packed (n_r, n_c, tn, kb) uint8 and C (n_r, n_c, K, td); any T.
    ``mode`` pins the schedule (module docstring); "auto" runs
    :func:`default_schedule`'s.  ``smem_budget`` is the shared memory a
    block may take (default: the card's opt-in limit)."""
    _check("bitlinear", x, m_packed, C, 0, mode, math, MODES)
    if mode != "jnp" and math == "dot":
        math = "unpack"
    if x.device.type == "cpu":
        return bitlinear_ref(x, m_packed, C, math)
    if mode == "jnp":
        raise ValueError("bitlinear: mode 'jnp' is the plain version, the CPU route; "
                         "it is not served on the card")
    T = x.shape[0]
    n_r, n_c, tn, kb = m_packed.shape
    K, td = C.shape[2], C.shape[3]
    mode, block_t, rc, budget = _card_schedule(mode, x, T, n_r, tn, K, td, block_t, r_chunk,
                                               smem_budget)
    x = x.contiguous()
    y = torch.empty((T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    ran = _launch("bitlinear", mode, x, m_packed, C, y, (1, T, n_r, n_c, tn, kb, K, td), math,
                  block_t, rc, budget)
    _count(bitlinear, mode, math, ran)
    return y


def bitlinear_grouped(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor,
                      block_t: int = 128, mode: str = "auto", math: str = "unpack",
                      r_chunk: int = 1, smem_budget: int | None = None) -> torch.Tensor:
    """y_e (T, n_c*td) = x_e @ decompress(m_packed_e, C_e) for every expert
    e in one launch: x (E, T, d_in), m_packed (E, n_r, n_c, tn, kb) uint8,
    C (E, n_r, n_c, K, td) -> (E, T, n_c*td); any T (one T for all
    experts), any E >= 1.  Schedules grid, decode and jnp (no stream, as in
    JAX); "auto" and ``smem_budget`` as in :func:`bitlinear`."""
    _check("bitlinear_grouped", x, m_packed, C, 1, mode, math, GROUPED_MODES)
    if mode != "jnp" and math == "dot":
        math = "unpack"
    if x.device.type == "cpu":
        return bitlinear_grouped_ref(x, m_packed, C, math)
    if mode == "jnp":
        raise ValueError("bitlinear_grouped: mode 'jnp' is the plain version, the CPU route; "
                         "it is not served on the card")
    E, T, _ = x.shape
    _, n_r, n_c, tn, kb = m_packed.shape
    K, td = C.shape[3], C.shape[4]
    mode, block_t, rc, budget = _card_schedule(mode, x, T, n_r, tn, K, td, block_t, r_chunk,
                                               smem_budget)
    x = x.contiguous()
    y = torch.empty((E, T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0 or E == 0:
        return y
    ran = _launch("bitlinear_grouped", mode, x, m_packed, C, y,
                  (E, T, n_r, n_c, tn, kb, K, td), math, block_t, rc, budget)
    _count(bitlinear_grouped, mode, math, ran)
    return y


def reset_counts() -> None:
    """Set every launch count of K3 and K4 to 0: the totals ``launches``,
    the counts per schedule and bit algebra, ``by_schedule["mode/math"]``,
    ``tensor_core_launches``, the grid launches (of ``launches``) that the
    library reports ran its tensor-core body, and ``decode_clusters``,
    {S: decode launches with clusters of S blocks}."""
    for fn, modes in ((bitlinear, MODES), (bitlinear_grouped, GROUPED_MODES)):
        fn.launches = 0
        fn.tensor_core_launches = 0
        fn.decode_clusters = {}
        fn.by_schedule = {f"{m}/{a}": 0 for m in modes if m not in ("auto", "jnp")
                          for a in MATHS}


reset_counts()
