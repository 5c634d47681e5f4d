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
  * decode: one block per (expert,) column tile with all T rows; the rows
    of x are staged once in shared memory, so it is admissible only while
    they fit (:func:`decode_path_ok`).  ``block_t`` and ``r_chunk`` are
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
(``block_smem``): the launch refuses a block over the budget, and
:func:`smem_bytes` asks the built library for the same number.

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

# The card's default schedule (default_schedule): up to SMALL_T rows, K3
# streams and K4 decodes, in the bitplane algebra, while the block fits the
# budget; above, the grid at DEFAULT_GRID_BLOCK_T rows.  Set from the times
# of each schedule at T = 1 ... 64 that chip_smoke.py measures on an H100
# (PERF.md): their register groups fit T up to 4 rows, where stream beats
# the grid by 13-44% and decode ties or beats it by up to 7%; from 8 rows
# on both use the grid's 8-row groups and tie or trail it.  The grid's
# tensor-core body starts above the same cutoff (every launch and layout
# query passes SMALL_T to the library), so the grid block the rule falls
# back to at T <= SMALL_T is the small FMA one.
SMALL_T = 4
DEFAULT_GRID_BLOCK_T = 64


def resolve_r_chunk(n_r: int, r_chunk: int) -> int:
    """Largest divisor of n_r that is <= the requested chunk (JAX's
    ``_resolve_r_chunk``)."""
    rc = max(1, min(int(r_chunk), n_r))
    while n_r % rc:
        rc -= 1
    return rc


def smem_bytes(mode: str, *, T: int, n_r: int, tn: int, K: int, td: int, x_itemsize: int,
               c_itemsize: int, r_chunk: int = 1) -> int:
    """Dynamic shared memory of one block of ``mode`` (the warps' z
    buffers and the block sums, plus the staged x rows for decode or each
    warp's two M/C slots for stream; the tensor-core grid's three stages of
    x, M and C and its partial sums), from the built kernels' own layout,
    ``bitlinear_smem_bytes`` in ``csrc/bitlinear.cu``.  Needs the CUDA
    toolchain: it builds the grid library on first use."""
    return _smem_bytes(mode, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk)


@functools.lru_cache(maxsize=4096)
def _smem_bytes(mode, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk) -> int:
    fn = _FNS.get("smem")
    if fn is None:
        fn = _build.load(_SOURCES["grid"]).bitlinear_smem_bytes
        fn.argtypes = [ctypes.c_int] * 11
        fn.restype = ctypes.c_longlong
        _FNS["smem"] = fn
    n = fn(_MODE_IDS[mode], T, n_r, tn, (K + 7) // 8, K, td, _KIND_OF_ITEMSIZE[x_itemsize],
           int(c_itemsize == 2), r_chunk, SMALL_T)
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


def decode_path_ok(T: int, n_r: int, tn: int, K: int, td: int, x_itemsize: int,
                   budget: int) -> bool:
    """Counterpart of JAX's ``_decode_path_ok``: the decode block keeps all
    T rows of x in shared memory; it is admissible when what it keeps there
    fits ``budget`` bytes.  (No bound on n_r: the r loop is not unrolled.)"""
    return smem_bytes("decode", T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=x_itemsize,
                      c_itemsize=4) <= budget


def default_schedule(grouped: bool, *, T: int, n_r: int, tn: int, K: int, td: int,
                     x_itemsize: int, c_itemsize: int, budget: int) -> dict:
    """The card's default schedule of one call, the port's own cost model
    (not JAX's VMEM one): up to ``SMALL_T`` rows K3 streams with r_chunk 2
    and K4 decodes, both in the bitplane
    algebra and only while the block fits ``budget`` bytes of shared
    memory; otherwise the grid at ``DEFAULT_GRID_BLOCK_T`` rows, r_chunk 1,
    unpack.  Returns the fields of an ``autotune.Schedule``."""
    if grouped:
        if T <= SMALL_T and decode_path_ok(T, n_r, tn, K, td, x_itemsize, budget):
            return {"mode": "decode", "math": "bitplane", "block_t": 128, "r_chunk": 1}
    elif T <= SMALL_T:
        rc = resolve_r_chunk(n_r, 2)
        if smem_bytes("stream", T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=x_itemsize,
                      c_itemsize=c_itemsize, r_chunk=rc) <= budget:
            return {"mode": "stream", "math": "bitplane", "block_t": 128, "r_chunk": rc}
    return {"mode": "grid", "math": "unpack", "block_t": DEFAULT_GRID_BLOCK_T, "r_chunk": 1}


def _lib(mode: str):
    fn = _FNS.get(mode)
    if fn is None:
        fn = getattr(_build.load(_SOURCES[mode]), f"bitlinear_{mode}")
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 15
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


def _launch(name, mode, x, m_packed, C, y, dims, math, block_t, r_chunk, budget) -> bool:
    """Launch ``csrc/bitlinear*.cu::bitlinear_<mode>`` on x's device and
    stream; ``dims`` are (E, T, n_r, n_c, tn, kb, K, td).  The library
    refuses a block over ``budget`` bytes of shared memory.  Returns whether
    the launch ran the grid's tensor-core body."""
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
    tensor_cores = ctypes.c_int(0)
    err = _lib(mode)(
        x.data_ptr(), m_packed.data_ptr(), C.data_ptr(), y.data_ptr(), *dims,
        _X_KINDS[x.dtype], int(C.dtype == torch.bfloat16), int(math == "bitplane"),
        int(block_t), int(r_chunk), int(budget), SMALL_T,
        torch.cuda.current_stream(x.device).cuda_stream, ctypes.byref(tensor_cores),
    )
    if err < 0:
        raise ValueError(f"{name}: mode {mode!r} needs {-err} bytes of shared memory per "
                         f"block, over the budget of {budget}")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch of mode {mode!r} failed (cudaError {err})")
    return bool(tensor_cores.value)


def _card_schedule(grouped, mode, x, C, T, n_r, tn, K, td, block_t, r_chunk, budget):
    """(mode, block_t, r_chunk, budget) of a call on the card: "auto" takes
    the default rule's, the budget defaults to the card's opt-in limit."""
    budget = device_smem_budget(x.device) if budget is None else budget
    if mode == "auto":
        s = default_schedule(grouped, T=T, n_r=n_r, tn=tn, K=K, td=td,
                             x_itemsize=x.element_size(), c_itemsize=C.element_size(),
                             budget=budget)
        mode, block_t, r_chunk = s["mode"], s["block_t"], s["r_chunk"]
    rc = resolve_r_chunk(n_r, r_chunk) if mode != "decode" else 1
    return mode, block_t, rc, budget


def _count(fn, mode: str, math: str, tensor_cores: bool) -> None:
    fn.launches += 1
    fn.by_schedule[f"{mode}/{math}"] += 1
    fn.tensor_core_launches += tensor_cores


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
    mode, block_t, rc, budget = _card_schedule(False, mode, x, C, T, n_r, tn, K, td, block_t,
                                               r_chunk, smem_budget)
    x = x.contiguous()
    y = torch.empty((T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0:
        return y
    mma = _launch("bitlinear", mode, x, m_packed, C, y, (1, T, n_r, n_c, tn, kb, K, td), math,
                  block_t, rc, budget)
    _count(bitlinear, mode, math, mma)
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
    mode, block_t, rc, budget = _card_schedule(True, mode, x, C, T, n_r, tn, K, td, block_t,
                                               r_chunk, smem_budget)
    x = x.contiguous()
    y = torch.empty((E, T, n_c * td), dtype=x.dtype, device=x.device)
    if T == 0 or E == 0:
        return y
    mma = _launch("bitlinear_grouped", mode, x, m_packed, C, y,
                  (E, T, n_r, n_c, tn, kb, K, td), math, block_t, rc, budget)
    _count(bitlinear_grouped, mode, math, mma)
    return y


def reset_counts() -> None:
    """Set every launch count of K3 and K4 to 0: the totals ``launches``,
    the counts per schedule and bit algebra, ``by_schedule["mode/math"]``,
    and ``tensor_core_launches``, the grid launches (of ``launches``) that
    the library reports ran its tensor-core body."""
    for fn, modes in ((bitlinear, MODES), (bitlinear_grouped, GROUPED_MODES)):
        fn.launches = 0
        fn.tensor_core_launches = 0
        fn.by_schedule = {f"{m}/{a}": 0 for m in modes if m not in ("auto", "jnp")
                          for a in MATHS}


reset_counts()
