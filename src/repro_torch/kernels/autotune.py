"""Kernel schedule autotuner for the fused bitlinear path (K3, K4).

Counterpart of ``repro/kernels/autotune.py``.  The bitlinear kernels
(``kernels/bitlinear.py``) expose a small schedule space: mode (grid /
decode / stream / jnp), bit algebra (unpack / bitplane / dot), the token
block ``block_t`` and the reduction chunk ``r_chunk``.

  * :func:`tune` times the candidate schedules of one concrete call;
    :func:`tune_artifact` sweeps every distinct (geometry, T bucket) a
    compression manifest can produce and stores the winners in
    ``manifest["kernel_schedules"]`` (format ``repro.kernel_schedules/v1``).
  * :func:`resolve` looks a call signature up by :func:`schedule_key` and
    falls back to :func:`heuristic`; the ops adapters
    (``ops.apply_compressed_fused`` / ``_grouped_fused``) call it, memoised
    per signature, and ``Engine`` installs a manifest's table with
    :func:`load_schedules` before enabling the kernels.

Keys are byte-identical to JAX's for the same signature:
``v1|kind|device|mode|r..c..n..k..d..|E..|T..|dtype``.  On the CPU the
device is ``cpu`` and the mode ``interpret``, so a table JAX tuned on the
CPU resolves from cache here; on the card the device is
``torch.cuda.get_device_name()`` and the mode ``compiled``.

On the card ``jnp`` (the plain version) is never a candidate and never
resolved: :func:`tune` times it beside the kernels for the record, and
:func:`load_schedules` refuses a CUDA-keyed entry that names it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Sequence

import numpy as np
import torch

from repro_torch.device import dtype_from_name, dtype_name, resolve_device
from repro_torch.kernels import bitlinear as _bl
from repro_torch.kernels import ref as _ref

__all__ = [
    "Schedule",
    "SCHEDULES_FORMAT",
    "schedule_key",
    "t_bucket",
    "device_kind",
    "pallas_mode",
    "resolve",
    "resolve_fused",
    "resolve_grouped",
    "heuristic",
    "candidates",
    "tune",
    "tune_artifact",
    "load_schedules",
    "export_schedules",
    "clear_schedules",
    "last_resolutions",
    "clear_log",
]

SCHEDULES_FORMAT = "repro.kernel_schedules/v1"

_T_BUCKET_CAP = 512
_LOG_CAP = 512


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One point of the bitlinear schedule space.  ``math`` "dot" is only
    meaningful for mode "jnp" (the kernels take it as unpack).  Fields a
    mode ignores: decode ignores ``block_t`` and ``r_chunk``; stream
    ignores ``block_t``."""

    mode: str
    math: str = "unpack"
    block_t: int = 128
    r_chunk: int = 1

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Schedule":
        return cls(
            mode=d["mode"],
            math=d.get("math", "unpack"),
            block_t=int(d.get("block_t", 128)),
            r_chunk=int(d.get("r_chunk", 1)),
        )

    def kwargs(self) -> dict:
        return {"mode": self.mode, "math": self.math, "block_t": self.block_t,
                "r_chunk": self.r_chunk}


# ---------------------------------------------------------------------------
# keys and environment
# ---------------------------------------------------------------------------


def _device(device=None) -> torch.device:
    """The device a key describes: the given one, else the card when there
    is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


_NAMES: dict = {}


def device_kind(device=None) -> str:
    """``cpu`` on the CPU (as JAX's platform name there), the card's name
    (``torch.cuda.get_device_name``) on a CUDA device."""
    dev = _device(device)
    if dev.type != "cuda":
        return dev.type
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx not in _NAMES:
        _NAMES[idx] = torch.cuda.get_device_name(idx)
    return _NAMES[idx]


def pallas_mode(device=None) -> str:
    """"compiled" on the card (the kernels), "interpret" on the CPU (the
    plain versions), as JAX names its kernels' two execution modes."""
    return "compiled" if _device(device).type == "cuda" else "interpret"


def t_bucket(T: int) -> int:
    """Token counts are bucketed to the next power of two (capped) so a
    tuned table covers nearby batch sizes instead of exact T only."""
    b = 1
    while b < min(int(T), _T_BUCKET_CAP):
        b *= 2
    return b


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a numpy-style name ("bfloat16":
    numpy itself knows that name only where ml_dtypes is loaded)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return dtype_from_name(dtype if isinstance(dtype, str) else np.dtype(dtype).name)


def schedule_key(kind: str, *, n_r: int, n_c: int, tn: int, K: int, td: int, T: int, dtype,
                 E: int = 0, device: str | None = None, mode: str | None = None) -> str:
    """Cache key for one call signature.  ``kind`` is "bitlinear" or
    "bitlinear_grouped" (E = expert count, 0 for 2D); ``dtype`` a torch
    dtype or a numpy dtype name; ``device`` and ``mode`` default to those
    of the current device."""
    device = device_kind() if device is None else device
    mode = pallas_mode() if mode is None else mode
    return (
        f"v1|{kind}|{device}|{mode}|r{n_r}c{n_c}n{tn}k{K}d{td}"
        f"|E{E}|T{t_bucket(T)}|{dtype_name(_torch_dtype(dtype))}"
    )


def _cuda_key(key: str) -> bool:
    return key.split("|")[3] == "compiled"


# ---------------------------------------------------------------------------
# cache, memo and resolution log
# ---------------------------------------------------------------------------

_CACHE: dict[str, Schedule] = {}
_MEMO: dict[tuple, Schedule] = {}
_LOG: list[dict] = []


def load_schedules(table: dict) -> int:
    """Install a ``manifest["kernel_schedules"]`` table into the process
    cache (returns the number of entries).  ``Engine`` calls it before
    enabling the kernels.  An entry keyed to a CUDA device that names the
    plain version (mode ``jnp``) is refused: the card serves kernels."""
    fmt = table.get("format")
    if fmt != SCHEDULES_FORMAT:
        raise ValueError(
            f"unsupported kernel schedule format {fmt!r} (expected {SCHEDULES_FORMAT!r})"
        )
    entries = {k: Schedule.from_dict(d) for k, d in table.get("entries", {}).items()}
    bad = [k for k, s in entries.items() if s.mode == "jnp" and _cuda_key(k)]
    if bad:
        raise ValueError(f"kernel schedule table serves the plain version (jnp) on a card: {bad}")
    _CACHE.update(entries)
    _MEMO.clear()
    return len(entries)


def export_schedules(extra: dict | None = None) -> dict:
    """The process cache as a manifest-embeddable table."""
    out = {
        "format": SCHEDULES_FORMAT,
        "tuned_on": {"device": device_kind(), "pallas_mode": pallas_mode()},
        "entries": {k: s.to_dict() for k, s in sorted(_CACHE.items())},
    }
    if extra:
        out.update(extra)
    return out


def clear_schedules() -> None:
    _CACHE.clear()
    _MEMO.clear()


def last_resolutions() -> list[dict]:
    """Resolution log: one entry per signature resolved,
    ``{"key", "schedule", "source"}`` with source "cache" or "heuristic"."""
    return list(_LOG)


def clear_log() -> None:
    """Empty the log and the memo, so the next call of every signature
    resolves (and logs) again."""
    _LOG.clear()
    _MEMO.clear()


# ---------------------------------------------------------------------------
# heuristic cost model (defaults when no cache entry matches)
# ---------------------------------------------------------------------------


def heuristic(kind: str, *, n_r: int, n_c: int, tn: int, kb: int, K: int, td: int, T: int,
              x_itemsize: int, c_itemsize: int, interpret: bool | None = None,
              smem_budget: int | None = None) -> Schedule:
    """Static cost-model default.  On the CPU (``interpret``) every mode is
    the plain version, so the jnp schedule with the dot formulation, as
    JAX's interpret-mode default.  On the card, the kernels' own default
    rule, ``bitlinear.default_schedule`` (the one ``mode="auto"`` runs),
    against ``smem_budget`` (default: the card's opt-in shared memory)."""
    if interpret is None:
        interpret = not torch.cuda.is_available()
    if interpret:
        return Schedule(mode="jnp", math="dot")
    budget = _bl.device_smem_budget() if smem_budget is None else smem_budget
    return Schedule(**_bl.default_schedule(T=T, n_r=n_r, tn=tn, K=K, td=td,
                                           x_itemsize=x_itemsize, budget=budget))


def resolve(kind: str, *, n_r: int, n_c: int, tn: int, kb: int, K: int, td: int, T: int, dtype,
            E: int = 0, c_itemsize: int | None = None, device=None) -> Schedule:
    """Schedule for one call signature: the tuned cache entry when one
    matches the device, the heuristic default otherwise.  Logs every call."""
    dev = _device(device)
    key = schedule_key(kind, n_r=n_r, n_c=n_c, tn=tn, K=K, td=td, T=T, dtype=dtype, E=E,
                       device=device_kind(dev), mode=pallas_mode(dev))
    sched = _CACHE.get(key)
    source = "cache"
    if sched is None:
        source = "heuristic"
        itemsize = _torch_dtype(dtype).itemsize
        budget = _bl.device_smem_budget(dev) if dev.type == "cuda" else None
        sched = heuristic(kind, n_r=n_r, n_c=n_c, tn=tn, kb=kb, K=K, td=td, T=T,
                          x_itemsize=itemsize,
                          c_itemsize=itemsize if c_itemsize is None else c_itemsize,
                          interpret=dev.type != "cuda", smem_budget=budget)
    if len(_LOG) >= _LOG_CAP:
        del _LOG[: _LOG_CAP // 2]
    _LOG.append({"key": key, "schedule": sched.to_dict(), "source": source})
    return sched


def _memoised(kind, x, m_packed, C, T, E) -> Schedule:
    """PyTorch runs eagerly, so the adapters resolve on every call: the
    memo keys on shapes, dtypes and device (no string is formatted on a
    hit) and the log gets one entry per new signature, as JAX's trace-time
    resolution gives."""
    memo = (kind, tuple(m_packed.shape), tuple(C.shape), T, x.dtype, C.dtype, x.device)
    sched = _MEMO.get(memo)
    if sched is None:
        n_r, n_c, tn, kb = m_packed.shape[-4:]
        K, td = C.shape[-2:]
        sched = _MEMO[memo] = resolve(
            kind, n_r=n_r, n_c=n_c, tn=tn, kb=kb, K=K, td=td, T=T, dtype=x.dtype, E=E,
            c_itemsize=C.element_size(), device=x.device,
        )
    return sched


def resolve_fused(x, m_packed, C) -> Schedule:
    """Resolution for ``ops.apply_compressed_fused`` operands (x already
    flattened to (T, d_in))."""
    return _memoised("bitlinear", x, m_packed, C, x.shape[0], 0)


def resolve_grouped(x, m_packed, C) -> Schedule:
    return _memoised("bitlinear_grouped", x, m_packed, C, x.shape[1], m_packed.shape[0])


# ---------------------------------------------------------------------------
# candidate generation + timed search
# ---------------------------------------------------------------------------


def candidates(kind: str, *, n_r: int, n_c: int, tn: int, kb: int, K: int, td: int, T: int,
               x_itemsize: int, c_itemsize: int, interpret: bool = False,
               smem_budget: int | None = None) -> list[Schedule]:
    """The schedule points :func:`tune` times for one call signature.  On
    the CPU every mode runs the plain version, so only the jnp formulations
    are candidates.  On the card: grid over block_t x r_chunk, decode when
    its x rows fit the budget, stream (2D only) at
    ``bitlinear.STREAM_R_CHUNKS`` (not JAX's first two r_chunks: larger
    chunks led on the card) when its block fits; r_chunk values are
    divisors of n_r, and a field the mode ignores is left at its default,
    so no two candidates make the same launch."""
    if interpret:
        return [Schedule(mode="jnp", math=m) for m in ("unpack", "dot", "bitplane")]
    budget = _bl.device_smem_budget() if smem_budget is None else smem_budget
    r_chunks = sorted({_bl.resolve_r_chunk(n_r, c) for c in (1, 2, 4, 8)})
    stream_rcs = sorted({_bl.resolve_r_chunk(n_r, c) for c in _bl.STREAM_R_CHUNKS})
    # rows per grid block are min(block_t, T rounded up to 8): block_t
    # values past that give the same launch
    Tp = -(-T // 8) * 8
    block_ts = sorted({min(bt, Tp) for bt in (64, 128, 256)}) if T > 64 else [128]
    grouped = kind == "bitlinear_grouped"

    def fits(mode, rc=1):
        return _bl.smem_bytes(mode, T=T, n_r=n_r, tn=tn, K=K, td=td, x_itemsize=x_itemsize,
                              c_itemsize=c_itemsize, r_chunk=rc) <= budget

    out = []
    for math in _bl.MATHS:
        out += [Schedule("grid", math, bt, rc) for bt in block_ts for rc in r_chunks
                if fits("grid", rc)]
        if fits("decode"):
            out.append(Schedule("decode", math))
        if not grouped:
            out += [Schedule("stream", math, 128, rc) for rc in stream_rcs if fits("stream", rc)]
    return out


def _time(fn, device: torch.device, repeats: int, iters: int) -> float:
    """Best of ``repeats`` of the mean time of ``iters`` back-to-back calls
    (seconds per call), after one warm-up call; CUDA events on the card,
    the host clock on the CPU."""
    fn()
    best = float("inf")
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            dt = time.perf_counter() - t0
        best = min(best, dt / iters)
    return best


def tune(x, m_packed, C, *, schedules: Iterable[Schedule] | None = None, repeats: int = 3,
         iters: int = 10) -> tuple[Schedule, list[dict]]:
    """Timed best-of-N search over the candidate schedules for one concrete
    call; returns (best, trials).  Grouped operands (x.ndim == 3) route to
    ``bitlinear_grouped``.  A schedule the wrapper refuses for these shapes
    (its shared memory over the budget) is recorded with its error and
    skipped; a CUDA failure is raised.  On the card the plain version is
    timed too (trials with ``"plain": true``) and never chosen."""
    grouped = x.ndim == 3
    kind = "bitlinear_grouped" if grouped else "bitlinear"
    T = x.shape[1] if grouped else x.shape[0]
    n_r, n_c, tn, kb = m_packed.shape[-4:]
    K, td = C.shape[-2:]
    on_card = x.device.type == "cuda"
    if schedules is None:
        schedules = candidates(kind, n_r=n_r, n_c=n_c, tn=tn, kb=kb, K=K, td=td, T=T,
                               x_itemsize=x.element_size(), c_itemsize=C.element_size(),
                               interpret=not on_card)
    call = _bl.bitlinear_grouped if grouped else _bl.bitlinear
    plain = _ref.bitlinear_grouped_ref if grouped else _ref.bitlinear_ref
    valid_modes = _bl.GROUPED_MODES if grouped else _bl.MODES

    trials = []
    best: Schedule | None = None
    best_t = float("inf")
    for s in schedules:
        if s.mode not in valid_modes or (on_card and s.mode == "jnp"):
            continue
        try:
            dt = _time(lambda: call(x, m_packed, C, **s.kwargs()), x.device, repeats, iters)
        except ValueError as err:           # refused for these shapes
            trials.append({"schedule": s.to_dict(), "error": str(err)[:200]})
            continue
        trials.append({"schedule": s.to_dict(), "seconds": dt})
        if dt < best_t:
            best, best_t = s, dt
    if on_card:
        for math in _bl.MATHS:
            dt = _time(lambda: plain(x, m_packed, C, math), x.device, 1, 1)
            trials.append({"schedule": Schedule("jnp", math).to_dict(), "seconds": dt,
                           "plain": True})
    if best is None:
        raise RuntimeError(f"no bitlinear schedule ran for {kind}")
    return best, trials


# ---------------------------------------------------------------------------
# manifest-level tuning (probe once, serve forever)
# ---------------------------------------------------------------------------


def _entry_geometry(entry: dict):
    """(E, n_r, n_c, tn, kb, K, td, dtype name) of the call signature a
    manifest tensor serves through; E = 0 for the 2D kernel.  The forward
    slices off the first lead dim (the layer), so a plain layer stack serves
    2D and only a layer x expert stack keeps a group axis."""
    mp_shape = tuple(entry["m_packed"]["shape"])
    c_shape = tuple(entry["C"]["shape"])
    lead = mp_shape[:-4]
    E = int(np.prod(lead[1:])) if len(lead) >= 2 else 0
    n_r, n_c, tn, kb = mp_shape[-4:]
    K, td = c_shape[-2:]
    return E, n_r, n_c, tn, kb, K, td, entry["dtype"]


def tune_artifact(manifest_or_artifact, *, T_values: Sequence[int] = (1, 4, 16, 128),
                  seed: int = 0, repeats: int = 3, iters: int = 10,
                  schedules: Iterable[Schedule] | None = None, verbose: bool = False,
                  device=None, trials_out: dict | None = None) -> dict:
    """Probe every distinct (kind, geometry, T bucket, dtype) signature a
    compression manifest can produce on ``device`` (default: the card),
    time the candidate schedules, and store the winners in
    ``manifest["kernel_schedules"]`` (also installed in the process
    cache).  Operands are synthesised from the manifest's shapes with a
    numpy generator seeded ``seed`` (timing depends on shapes, not values).
    ``trials_out``, when given, receives each key's trials.  Returns the
    schedule table."""
    device = resolve_device(device)
    manifest = getattr(manifest_or_artifact, "manifest", manifest_or_artifact)
    if schedules is not None:
        schedules = list(schedules)   # reused across signatures
    rng = np.random.default_rng(seed)
    seen: set[str] = set()
    for path, entry in manifest.get("tensors", {}).items():
        if entry.get("method") == "int8":
            # int8-baseline tensors serve by dequant-einsum: no fused kernel
            continue
        E, n_r, n_c, tn, kb, K, td, dname = _entry_geometry(entry)
        dtype = dtype_from_name(dname)
        kind = "bitlinear_grouped" if E else "bitlinear"
        for T in T_values:
            key = schedule_key(kind, n_r=n_r, n_c=n_c, tn=tn, K=K, td=td, T=T, dtype=dtype,
                               E=E, device=device_kind(device), mode=pallas_mode(device))
            if key in seen:
                continue
            seen.add(key)
            Tb = t_bucket(T)
            lead = (E,) if E else ()
            x = torch.from_numpy(
                rng.standard_normal(lead + (Tb, n_r * tn)).astype(np.float32)).to(device, dtype)
            mp = torch.from_numpy(
                rng.integers(0, 256, lead + (n_r, n_c, tn, kb)).astype(np.uint8)).to(device)
            C = torch.from_numpy(
                rng.standard_normal(lead + (n_r, n_c, K, td)).astype(np.float32)).to(device, dtype)
            best, trials = tune(x, mp, C, repeats=repeats, iters=iters, schedules=schedules)
            _CACHE[key] = best
            if trials_out is not None:
                trials_out[key] = trials
            if verbose:
                dt = min(t["seconds"] for t in trials if "seconds" in t and not t.get("plain"))
                print(f"[autotune] {key} -> {best.mode}/{best.math} bt={best.block_t} "
                      f"rc={best.r_chunk} ({dt * 1e6:.1f} us)")
    _MEMO.clear()
    table = export_schedules()
    table["tuned_on"] = {"device": device_kind(device), "pallas_mode": pallas_mode(device)}
    manifest["kernel_schedules"] = table
    return table
