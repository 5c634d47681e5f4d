"""Fused compressed linear layer y = (x @ M) @ C (kernel K3) and its
grouped per-expert form (kernel K4).

Counterpart of ``repro/kernels/bitlinear.py::bitlinear`` and
``::bitlinear_grouped``.  For CUDA tensors they launch the hand-written
kernels ``csrc/bitlinear*.cu`` (designs in ``csrc/bitlinear.cuh``, grid;
``bitlinear_decode.cuh``; ``bitlinear_stream.cuh``); for CPU tensors they
run the plain versions ``ref.bitlinear_ref`` and ``ref.bitlinear_grouped_ref``
with the requested bit algebra.

Schedules (``mode``), the names of the JAX kernels' so that a tuned
``kernel_schedules`` table means the same in both packages:

  * grid: blocks of ``block_t`` rows.  bf16 x with bf16 C at T > SMALL_T
    (K <= 8, tn % 8 == 0, any td: :func:`grid_on_tensor_cores`) runs on the
    tensor cores: a block owns four column tiles and one column chunk of
    them (td padded with zero C columns to a multiple of 16,
    :func:`grid_mma_chunk`: 131 -> one chunk of 144, 419 -> three), its
    warps one 16-row tile each, and every step stages ``r_chunk`` r tiles
    (rounded up to whole mma groups) of x, M and C in shared memory (C's
    rows raw and shifted into place where td % 8 != 0 leaves them
    unaligned); z = x @ M and y += z @ C are mma.sync products.
    ``tensor_core_launches`` counts the launches that the library reports
    ran it.  Every other call runs the FMA body: register groups of 8 rows
    x one column chunk, each warp taking ``r_chunk`` r tiles at a time.
  * decode: a kernel of its own.  Each (expert,) column tile's r tiles are
    split across the S blocks of a thread-block cluster (S from
    :func:`decode_cluster_size`); a producer warp streams
    the tiles (C, M and the T rows of x over them) into a ring of
    shared-memory stages, four consumer warps reduce them, and rank 0 adds
    the blocks' partial sums.  C tiles of 129 to 160 columns, which span
    two 128-column chunks (zamba2's td 131), are staged raw and one block
    covers all their columns against one z (:func:`decode_layout`).  Its
    shared memory grows with T, K and td, not with d_in
    (:func:`decode_path_ok`).  ``decode_clusters`` counts its launches by
    the S passed to the launch.  ``block_t`` and ``r_chunk`` are ignored.
  * stream (K3 only, as in JAX): a kernel of its own.  Each column tile's r
    tiles are split across the S blocks of a thread-block cluster in whole
    chunks of ``r_chunk`` tiles (S from :func:`stream_cluster_size`); one
    producer thread copies each chunk's C tiles, M tiles and x rows into a
    ring stage with one tensor-map copy per part (the parts TMA's rules
    admit, :func:`stream_tensor_maps`; the others are read from device
    memory), consumer warps take the stages in turn with decode's body, and
    rank 0 adds the blocks' partial sums.  A block covers at most
    ``STREAM_ROWS`` rows (:func:`stream_geometry`).  ``stream_clusters`` and
    ``stream_maps`` count its launches by S and by the parts that went
    through a tensor map.  ``block_t`` is ignored.
  * auto: the card's default schedule for the call, :func:`default_schedule`
    (its mode, block_t and r_chunk; the caller's math).  A serve without a
    tuned table resolves the same rule (``autotune.heuristic``).
  * jnp: the plain version; the CPU route.  It is not served on the card:
    a CUDA tensor with ``mode="jnp"`` is refused.

A block's shared memory is defined once per schedule, in its header
(``block_smem``, ``decode_geom``, ``stream_geom``): the launch refuses a
block over the budget, and :func:`smem_bytes` asks the built library for
the same number.

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
    "grid_on_tensor_cores",
    "grid_mma_chunk",
    "decode_cluster_size",
    "decode_layout",
    "built_decode_layout",
    "stream_cluster_size",
    "stream_geometry",
    "stream_tensor_maps",
    "tensor_map_ok",
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
_FNS: dict = {}           # mode -> loaded C entry point
_BUDGETS: dict = {}       # device index -> opt-in shared memory per block
_SMS: dict = {}           # device index -> streaming multiprocessors
_SM_SMEM: dict = {}       # device index -> shared memory per SM

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

# The decode block's staging of C (decode_layout mirrors
# csrc/bitlinear_decode.cuh's decode_geom; tests/test_torch_guards.py holds
# these to its DEC_WARPS, BITLINEAR_DECODE_STAGE_BYTES, DEC_RAW_COLS and
# DEC_RAW_STAGE_BYTES): DECODE_WARPS consumer warps, stages of
# at most DECODE_STAGE_BYTES of the parts that are whole 16-byte tiles
# (C's only within one column chunk), and C staged raw at tile widths over
# one chunk up to 32 DECODE_RAW_COLS where a stage of it stays within
# DECODE_RAW_STAGE_BYTES.
DECODE_WARPS = 4
DECODE_STAGE_BYTES = 24576
DECODE_RAW_COLS = 5
DECODE_RAW_STAGE_BYTES = 65536

# The stream block (csrc/bitlinear_stream.cuh; stream_geometry mirrors its
# layout): STREAM_WARPS consumer warps; a ring of stages of one r chunk each,
# as many as STREAM_RING_BYTES holds, a multiple of STREAM_WARPS up to
# STREAM_STAGES; at most STREAM_ROWS rows of x; STREAM_MIN_BLOCKS resident
# blocks per SM promised by its registers (0: stream_min_blocks's rule).
# Its launch's split of r (stream_cluster_size): as many blocks as the card
# holds at once (stream_blocks_per_sm), each keeping at least
# STREAM_MIN_TILES r tiles, in clusters of up to STREAM_PORTABLE_CLUSTER
# blocks, or STREAM_MAX_CLUSTER.
STREAM_WARPS = 4
STREAM_STAGES = 8
STREAM_RING_BYTES = 49152
STREAM_ROWS = 32
STREAM_MIN_BLOCKS = 0
STREAM_MIN_TILES = 8
STREAM_PORTABLE_CLUSTER = 8
STREAM_MAX_CLUSTER = 16
# The card's stream candidates for the tuner, and the r_chunk chip_smoke.py's
# small-T sweep times stream at: the two r_chunks that led the stream
# kernel's sweep (tools/torch_stream_ab.py on an H100 at 700 W; PERF.md): at
# T = 4, qwen3-32b's eight K3 calls took 0.62, 0.40, 0.30 and 0.31 ms at
# r_chunk 1, 2, 4, 8 (device time), granite-moe's four 0.050, 0.045, 0.045,
# 0.052.  JAX's tuner takes the first two of 1, 2, 4, 8.
STREAM_R_CHUNKS = (4, 8)


def resolve_r_chunk(n_r: int, r_chunk: int) -> int:
    """Largest divisor of n_r that is <= the requested chunk (JAX's
    ``_resolve_r_chunk``)."""
    rc = max(1, min(int(r_chunk), n_r))
    while n_r % rc:
        rc -= 1
    return rc


def smem_bytes(mode: str, *, T: int, n_r: int, tn: int, K: int, td: int, x_itemsize: int,
               c_itemsize: int, r_chunk: int = 1) -> int:
    """Dynamic shared memory of one block of ``mode`` (grid: the warps' z
    buffers and the block sums, or the tensor-core body's stages of x, M and
    C and its partial sums; decode: its ring of stages, z buffers, partial-y
    slots and barriers, independent of n_r and r_chunk; stream: the same,
    its stages of r_chunk tiles), from the built kernels' own layout: each
    schedule's library, ``bitlinear_smem_bytes`` in ``csrc/bitlinear.cu``,
    ``bitlinear_decode_smem_bytes`` and ``bitlinear_stream_smem_bytes`` in
    theirs.  Needs the CUDA toolchain: it builds the schedule's library on
    first use."""
    return _smem_bytes(mode, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk)


# each library's layout query: (C function, argument count)
_SMEM_FNS = {"grid": ("bitlinear_smem_bytes", 9), "decode": ("bitlinear_decode_smem_bytes", 7),
             "stream": ("bitlinear_stream_smem_bytes", 8)}


@functools.lru_cache(maxsize=4096)
def _smem_bytes(mode, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk) -> int:
    key = f"smem/{mode}"
    fn = _FNS.get(key)
    if fn is None:
        name, nargs = _SMEM_FNS[mode]
        fn = getattr(_build.load(_SOURCES[mode]), name)
        fn.argtypes = [ctypes.c_int] * nargs
        fn.restype = ctypes.c_longlong
        _FNS[key] = fn
    kind, c_bf16, kb = _KIND_OF_ITEMSIZE[x_itemsize], int(c_itemsize == 2), (K + 7) // 8
    if mode == "decode":
        n = fn(T, tn, kb, K, td, kind, c_bf16)
    elif mode == "stream":
        n = fn(T, tn, kb, K, td, kind, c_bf16, r_chunk)
    else:
        n = fn(T, tn, kb, K, td, kind, c_bf16, r_chunk, SMALL_T)
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


def device_sm_smem(device=None) -> int:
    """The card's shared memory per SM, 1 KiB of it reserved per resident
    block (228 KiB on an H100)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _SM_SMEM:
        _SM_SMEM[idx] = int(torch.cuda.get_device_properties(idx).shared_memory_per_multiprocessor)
    return _SM_SMEM[idx]


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


def decode_layout(*, T: int, tn: int, K: int, td: int, x_itemsize: int,
                  c_itemsize: int) -> dict:
    """The decode block's layout (``csrc/bitlinear_decode.cuh::decode_geom``,
    mirrored): ``rs`` r tiles a stage, split among the ``DECODE_WARPS``
    consumer warps as the parts staged as whole 16-byte tiles allow; ``c``,
    how C reaches the consumers: "tiles" (whole tiles in the stage: they are
    16-byte units within one 128-column chunk), "raw" (each tile's span from
    the 16-byte boundary below it, where it spans two chunks, 128 < td <= 32
    ``DECODE_RAW_COLS``, at T <= 4, while a stage of them stays within
    ``DECODE_RAW_STAGE_BYTES``)
    or "device" (read from device memory); ``groups``, the blocks along td
    (one per 128-column chunk unless C is raw)."""
    cw = 32 if td <= 32 else 128
    nch = -(-td // cw)
    per_vec = 16 // x_itemsize
    ns = -(-tn // per_vec)
    ls = 1
    while ls < ns and ls < 32:
        ls *= 2
    pairs = (K + 1) // 2
    full = 32 // ls // pairs if 32 // ls > pairs else 1
    c_tile, m_tile, x_tile = K * td * c_itemsize, tn * (-(-K // 8)), tn * x_itemsize
    tiles = c_tile % 16 == 0 and nch == 1
    per = ((c_tile if tiles else 0) + (m_tile if m_tile % 16 == 0 else 0)
           + (T * x_tile if x_tile % 16 == 0 else 0))
    fit = DECODE_STAGE_BYTES // per if per else DECODE_WARPS * full
    ts = min(fit, DECODE_WARPS * full)
    rs = DECODE_WARPS if ts < DECODE_WARPS else ts - ts % DECODE_WARPS
    c_slot = (c_tile + 15) // 16 * 16 + 16 if c_tile % 16 else c_tile
    raw = (cw < td <= 32 * DECODE_RAW_COLS and T <= 4
           and rs * (c_slot + per) <= DECODE_RAW_STAGE_BYTES)
    return {"rs": rs, "c": "tiles" if tiles else "raw" if raw else "device",
            "groups": 1 if raw else nch}


def built_decode_layout(*, T: int, tn: int, K: int, td: int, x_itemsize: int,
                        c_itemsize: int) -> dict:
    """:func:`decode_layout` as the built library computes it
    (``bitlinear_decode_layout`` in ``csrc/bitlinear_decode.cu``, the
    ``decode_geom`` every decode launch takes its layout from), for holding
    the mirror and a launch's staging to it.  Builds the library on first
    use."""
    fn = _FNS.get("layout/decode")
    if fn is None:
        fn = _FNS["layout/decode"] = _build.load("bitlinear_decode").bitlinear_decode_layout
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * 3)()
    if fn(T, tn, (K + 7) // 8, K, td, _KIND_OF_ITEMSIZE[x_itemsize], int(c_itemsize == 2),
          out) != 0:
        raise ValueError(f"built_decode_layout: bad x_itemsize {x_itemsize}")
    return {"rs": out[0], "c": ("device", "tiles", "raw")[out[1]], "groups": out[2]}


def tensor_map_ok(esize: int, box, strides, base: int = 0) -> bool:
    """TMA's rules for one tensor map (``csrc/bitlinear_stream.cuh::
    stream_map_ok``, mirrored): the inner box (``box[0]`` elements of
    ``esize`` bytes) a multiple of 16 bytes, every box dimension in
    1 ... 256, every global stride (bytes, dims 1 ...) a multiple of 16
    bytes, and the global address ``base`` 16-byte aligned."""
    return (base % 16 == 0 and box[0] * esize % 16 == 0 and all(1 <= b <= 256 for b in box)
            and all(s % 16 == 0 for s in strides))


def stream_tensor_maps(*, T: int, tn: int, K: int, td: int, x_itemsize: int, c_itemsize: int,
                       r_chunk: int) -> dict:
    """The parts a stream launch copies through a tensor map (at 16-byte
    aligned bases; the wrapper clones a view that is not), by
    :func:`tensor_map_ok` on the kernel's views: C as {td, K, n_c, n_r}, box
    {the chunk's columns, K, 1, r_chunk}; M as bytes {tn kb, n_c, n_r}, box
    {tn kb, 1, r_chunk}; x as {tn, n_r, T}, box {tn, r_chunk, the block's
    rows}.  Every stride is a multiple of dim 1's, so n_r and n_c do not
    matter.  {"C": bool, "M": bool, "x": bool}."""
    g = _stream_shape(T, td)
    mt = tn * ((K + 7) // 8)
    return {"C": tensor_map_ok(c_itemsize, (g["cbox"], K, 1, r_chunk),
                               (td * c_itemsize, K * td * c_itemsize, K * td * c_itemsize)),
            "M": tensor_map_ok(1, (mt, 1, r_chunk), (mt, mt)),
            "x": tensor_map_ok(x_itemsize, (tn, r_chunk, g["rows"]),
                               (tn * x_itemsize, tn * x_itemsize))}


def _stream_shape(T: int, td: int) -> dict:
    rows = min(T, STREAM_ROWS)
    cols = 32 if td <= 32 else 128
    return {"rows": rows, "row_blocks": -(-T // rows), "cols": cols,
            "col_chunks": -(-td // cols), "cbox": min(td, cols),
            "bt": 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8}


def stream_geometry(*, T: int, tn: int, K: int, td: int, x_itemsize: int, c_itemsize: int,
                    r_chunk: int) -> dict:
    """The stream block's geometry and layout, as ``csrc/bitlinear_stream.cuh::
    stream_geom`` computes it (the library's ``bitlinear_stream_smem_bytes``
    is the number a launch checks; the card tests hold the two equal): the
    rows a block covers and the row blocks, the column chunks, the ring's
    stages (each part of a stage 128-byte aligned; a multiple of the
    consumer warps, which take the stages in turn) and the block's shared
    memory [stages] [z buffers] [partial-y slots] [barriers]."""
    g = _stream_shape(T, td)
    maps = stream_tensor_maps(T=T, tn=tn, K=K, td=td, x_itemsize=x_itemsize,
                              c_itemsize=c_itemsize, r_chunk=r_chunk)

    def a128(n):
        return -(-n // 128) * 128

    c_b = a128(r_chunk * K * g["cbox"] * c_itemsize) if maps["C"] else 0
    m_b = a128(r_chunk * tn * ((K + 7) // 8)) if maps["M"] else 0
    x_b = a128(g["rows"] * r_chunk * tn * x_itemsize) if maps["x"] else 0
    stage = c_b + m_b + x_b
    fit = min(STREAM_STAGES, STREAM_RING_BYTES // stage if stage else STREAM_STAGES)
    ns = max(STREAM_WARPS, fit - fit % STREAM_WARPS)
    zbuf = -(-STREAM_WARPS * r_chunk * K * g["bt"] * 4 // 16) * 16
    slots = STREAM_WARPS * g["rows"] * g["cols"] * 4
    return {**g, "maps": maps, "stage_bytes": stage, "stages": ns,
            "smem": ns * stage + zbuf + slots + 2 * ns * 8}


def stream_min_blocks(bt: int) -> int:
    """Resident stream blocks per SM that the kernel's registers promise
    (``csrc/bitlinear_stream.cuh::stream_min_blocks``, its launch bounds) for
    register groups of ``bt`` rows: 3 up to 4 rows, else 2."""
    return STREAM_MIN_BLOCKS or (3 if bt <= 4 else 2)


def stream_blocks_per_sm(bt: int, smem: int, sm_smem: int) -> int:
    """Stream blocks of ``smem`` bytes of shared memory each that one SM
    holds at once: what the registers promise (:func:`stream_min_blocks`)
    and ``sm_smem`` (the SM's shared memory, :func:`device_sm_smem`, 1 KiB
    of it reserved per block) allow; at least 1."""
    return max(1, min(stream_min_blocks(bt), sm_smem // (smem + 1024)))


def stream_cluster_size(blocks: int, n_r: int, r_chunk: int, sms: int, per_sm: int) -> int:
    """S, the blocks of a thread-block cluster that split each column tile's
    r chunks in a stream launch of ``blocks`` = n_c x column chunks x row
    blocks such groups, ``per_sm`` of whose blocks an SM holds
    (:func:`stream_blocks_per_sm`): the most whose blocks still run in one
    wave (blocks * S <= per_sm x ``sms``), each keeping whole r chunks (S <=
    ceil(n_r / r_chunk)) and at least ``STREAM_MIN_TILES`` r tiles, taken
    from 1 ... ``STREAM_PORTABLE_CLUSTER`` and ``STREAM_MAX_CLUSTER``; at
    least 1.  The one definition of S: the wrapper passes it to every
    stream launch."""
    S = min(-(-n_r // r_chunk), n_r // STREAM_MIN_TILES, per_sm * sms // max(1, blocks))
    if S >= STREAM_MAX_CLUSTER:
        return STREAM_MAX_CLUSTER
    return max(1, min(STREAM_PORTABLE_CLUSTER, S))


def grid_on_tensor_cores(T: int, tn: int, K: int, td: int, x_itemsize: int,
                         c_itemsize: int) -> bool:
    """Whether a grid launch runs the tensor-core body, as
    ``csrc/bitlinear.cuh::grid_on_mma`` decides (mirrored; the library
    reports each launch's body, ``tensor_core_launches``): bf16 x and C
    above ``SMALL_T`` rows, K <= 8 and tn % 8 == 0, at any td (zamba2's
    in_proj at 131 included).  Every other grid call runs the FMA body."""
    return (T > SMALL_T and x_itemsize == 2 and c_itemsize == 2 and 1 <= K <= 8
            and tn % 8 == 0 and td >= 1)


# The tensor-core grid's column chunk (csrc/bitlinear.cuh::mma_ntp, its
# BITLINEAR_MMA_MAX_NTP and instantiated counts): the fewest chunks of at
# most GRID_MMA_MAX_NTP pairs of 8-column n-tiles cover td padded to a
# multiple of 16, split evenly, each the smallest of GRID_MMA_NTPS pairs
# that holds a share.
GRID_MMA_MAX_NTP = 9
GRID_MMA_NTPS = (3, 4, 8, 9)


def grid_mma_chunk(td: int) -> tuple[int, int]:
    """(columns of a chunk, chunks) of a tensor-core grid launch at tile
    width ``td``: (128, 1) at 128, (144, 1) at 131, (144, 3) at 419, (48, 1)
    at 37."""
    n16 = -(-td // 16)
    need = -(-n16 // -(-n16 // GRID_MMA_MAX_NTP))
    cols = 16 * min(n for n in GRID_MMA_NTPS if n >= need)
    return cols, -(-td // cols)


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


# each entry point's arguments after (x, m_packed, C, y): decode (E, T, ...,
# bitplane, clusters, smem_budget, stream); stream (T, ..., bitplane,
# r_chunk, clusters, smem_budget, stream, *maps); grid (E, T, ..., bitplane,
# block_t, r_chunk, smem_budget, small_t, stream, *tensor_cores)
_ARGTYPES = {"decode": [ctypes.c_int] * 13 + [ctypes.c_void_p],
             "stream": [ctypes.c_int] * 13 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)],
             "grid": [ctypes.c_int] * 15 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]}
# the stream entry point's maps bits, and a failed tensor-map encode's code
_MAP_BITS = (("C", 1), ("M", 2), ("x", 4))
_ENCODE_ERROR = 20000


def _lib(mode: str):
    fn = _FNS.get(mode)
    if fn is None:
        fn = getattr(_build.load(_SOURCES[mode]), f"bitlinear_{mode}")
        fn.argtypes = [ctypes.c_void_p] * 4 + _ARGTYPES[mode]
        fn.restype = ctypes.c_int
        _FNS[mode] = fn
    return fn


def _parts(maps: int) -> str:
    """The stream entry point's maps bits as "C+M+x" ("none": no part)."""
    return "+".join(n for n, b in _MAP_BITS if maps & b) or "none"


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


def _launch(name, mode, x, m_packed, C, y, dims, math, block_t, r_chunk, budget):
    """Launch ``csrc/bitlinear*.cu::bitlinear_<mode>`` on x's device and
    stream; ``dims`` are (E, T, n_r, n_c, tn, kb, K, td).  The library
    refuses a block over ``budget`` bytes of shared memory.  Returns for
    decode the cluster size S it was launched with (the rule's), for stream
    (S, the parts that went through a tensor map), else whether the library
    reports that the launch ran the grid's tensor-core body."""
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
    # the tensor-core grid copies x and C in 16-byte and M in 4-byte units,
    # stream's tensor maps need 16-byte aligned bases: a view that starts
    # elsewhere in its buffer is cloned
    if x.data_ptr() % 16 or m_packed.data_ptr() % 16 or C.data_ptr() % 16:
        x, m_packed, C = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, m_packed, C))
    ran = ctypes.c_int(0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if mode == "decode":
        S = decode_cluster_size(E * n_c, n_r, device_sms(x.device))
        opts = (S, int(budget), stream)
    elif mode == "stream":
        dims = dims[1:]   # K3 only: no expert axis
        g = _stream_shape(T, td)
        smem = smem_bytes("stream", T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=x.element_size(),
                          c_itemsize=C.element_size(), r_chunk=r_chunk)
        per_sm = stream_blocks_per_sm(g["bt"], smem, device_sm_smem(x.device))
        S = stream_cluster_size(n_c * g["col_chunks"] * g["row_blocks"], n_r, r_chunk,
                                device_sms(x.device), per_sm)
        opts = (int(r_chunk), S, int(budget), stream, ctypes.byref(ran))
    else:
        opts = (int(block_t), int(r_chunk), int(budget), SMALL_T, stream, ctypes.byref(ran))
    err = _lib(mode)(
        x.data_ptr(), m_packed.data_ptr(), C.data_ptr(), y.data_ptr(), *dims,
        _X_KINDS[x.dtype], int(C.dtype == torch.bfloat16), int(math == "bitplane"), *opts,
    )
    if err < 0:
        raise ValueError(f"{name}: mode {mode!r} needs {-err} bytes of shared memory per "
                         f"block, over the budget of {budget}")
    if mode == "stream" and err >= _ENCODE_ERROR:
        raise RuntimeError(f"{name}: a tensor map of mode 'stream' failed to encode "
                           f"(CUresult {err - _ENCODE_ERROR})")
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch of mode {mode!r} failed (cudaError {err})")
    if mode == "stream":
        return S, _parts(ran.value)
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


def _count(fn, mode: str, math: str, ran) -> None:
    fn.launches += 1
    fn.by_schedule[f"{mode}/{math}"] += 1
    if mode == "decode":
        fn.decode_clusters[ran] = fn.decode_clusters.get(ran, 0) + 1
    elif mode == "stream":
        S, parts = ran
        fn.stream_clusters[S] = fn.stream_clusters.get(S, 0) + 1
        fn.stream_maps[parts] = fn.stream_maps.get(parts, 0) + 1
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
    library reports ran its tensor-core body, ``decode_clusters``, {S:
    decode launches with clusters of S blocks}, and for K3
    ``stream_clusters``, the same of stream, and ``stream_maps``, {"C+M+x":
    stream launches whose parts named there went through a tensor map}."""
    for fn, modes in ((bitlinear, MODES), (bitlinear_grouped, GROUPED_MODES)):
        fn.launches = 0
        fn.tensor_core_launches = 0
        fn.decode_clusters = {}
        fn.stream_clusters = {}
        fn.stream_maps = {}
        fn.by_schedule = {f"{m}/{a}": 0 for m in modes if m not in ("auto", "jnp")
                          for a in MATHS}


reset_counts()
