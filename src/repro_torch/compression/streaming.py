"""Streaming, resumable compression of checkpoints larger than host RAM.

Counterpart of ``repro/compression/streaming.py``.  ``plan_compression`` and
``execute_plan`` hold the whole values tree; this module restates the
pipeline around three constraints:

  * **Plan from metadata alone.**  A :class:`TreeLeafSource` over a
    template of ``meta`` tensors (``init_model(cfg, device="meta")``, the
    port's counterpart of ``jax.eval_shape``) or a
    :class:`CheckpointLeafSource` over a step MANIFEST gives shapes and
    dtypes without loading a tensor.
  * **Probe with surrogates.**  :func:`surrogate_probe` takes a candidate's
    distortion from the SVD tail of a small tile subsample, inflated by a
    per-K factor calibrated by a few exact trial compressions; tensors whose
    confidence interval straddles an allocation boundary are probed exactly
    on the same subsample.  A metadata-only source probes synthetic
    init-distribution tiles.
  * **Execute under a host budget, resumably.**  :func:`execute_streaming`
    walks the source one leaf at a time and reads it on the host in blocks
    of whole tile rows (memory-mapped shard files for a checkpoint), each
    block at most a chunk of ``REPRO_STREAM_BUDGET_BYTES // (32 tile_n
    tile_d)`` tiles; it moves a block to the device in the leaf's dtype,
    cuts it into tiles and widens it to float32 there, solves each chunk and
    writes the packed result into the output step directory through npy
    memmaps.  Job state is saved after every
    leaf; :func:`run_compression_job` supervises with ``run_with_restarts``,
    and a killed job resumes where it stopped, to an output byte-identical
    to an uninterrupted run's.

Determinism: a chunk's restart draws are its slice of what
``execute_plan`` draws for the tensor (``execute._slice_signs``: one
generator per (seed, leaf_index, group slice)), so greedy/alternating output
is bit-identical to ``execute_plan``'s on the same device and seed.  BBO
chunks draw from ``generator(device, seed, stream salt, leaf_index,
chunk)``: deterministic per (plan, seed, budget), equal to a pooled execute
only in quality.  The job state is keyed by (plan, seed, backend, budget)
and the seed's encoding is the port's own, so a job state the reference
left is not resumed: the port starts that job afresh.

Host data needs no JAX: bfloat16 shards read as raw 2-byte data and become
bf16 tensors by a view; compressed bf16 C is written as raw ``|V2``, as the
port's checkpointer writes it.  A process's peak resident set is the
kernel's high-water mark (``VmHWM``) where it keeps one, else the largest
``VmRSS`` an :class:`RssSampler` read while the job ran: ``ru_maxrss``, the
reference's measure, also holds what a parent had resident when it spawned
the process, which is why the kill, the resume and the memory figure are
measured in child processes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import resource
import shutil
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.checkpointer import _safe, np_dtype, to_numpy
from repro_torch.compression.artifact import MANIFEST_FORMAT, CompressionArtifact
from repro_torch.compression.autotune.allocate import allocate_budget
from repro_torch.compression.autotune.probe import (
    DEFAULT_K_FRACTIONS,
    ProbeResult,
    RDPoint,
    candidate_settings,
    probe_indices,
)
from repro_torch.compression.autotune.refine import (
    AutotuneResult,
    _verify_refined,
    allocation_rules,
)
from repro_torch.compression.execute import EIGH_MAX_BATCH, _slice_signs, auto_pool_chunk
from repro_torch.compression.plan import CompressionPlan, TensorPlan, plan_compression, tree_paths
from repro_torch.core import decomposition as dec
from repro_torch.core.compress import GREEDY_RESTARTS, compress_tile_batch
from repro_torch.device import dtype_from_name, dtype_name, generator, resolve_device
from repro_torch.distributed.fault_tolerance import Heartbeat, run_with_restarts

__all__ = [
    "CheckpointLeafSource",
    "TreeLeafSource",
    "surrogate_probe",
    "surrogate_probe_from",
    "SurrogateProbe",
    "streaming_autotune_plan",
    "execute_streaming",
    "run_compression_job",
    "peak_rss_bytes",
    "RssSampler",
    "STREAM_BUDGET_ENV",
    "KILL_AFTER_ENV",
    "STATE_NAME",
]

#: Host-memory budget of the streaming execute: bounds the dense tile chunk
#: of each batched solve (with headroom), not the checkpoint size.
STREAM_BUDGET_ENV = "REPRO_STREAM_BUDGET_BYTES"
_DEFAULT_STREAM_BUDGET = 1 << 30

#: Job-state document saved beside the step directories.
STATE_NAME = "stream_state.json"
STATE_FORMAT = "repro.compression.stream/v1"

#: Fault injection: SIGKILL the process after this many leaves of the
#: current run (0 or unset: never).
KILL_AFTER_ENV = "REPRO_STREAM_KILL_AFTER"

_STREAM_SALT = 0x73747265   # "stre": BBO and exact-probe draws
_SYNTH_SALT = 0x73796E74    # "synt": synthetic tiles
_FACTOR_CLIP = (1.0, 1e3)   # a binary M is never below the SVD tail; a
                            # near-zero tail must not explode the factor


def stream_budget_bytes(budget_bytes: int | None = None) -> int:
    if budget_bytes is not None:
        return int(budget_bytes)
    return int(os.environ.get(STREAM_BUDGET_ENV, _DEFAULT_STREAM_BUDGET))


def _status_bytes(field: str) -> int | None:
    """A size field of /proc/self/status (``VmHWM``, ``VmRSS``) in bytes,
    None where the kernel does not report it."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def peak_rss_bytes(sampled: int = 0) -> int:
    """This process's peak resident set since it started its program:
    ``VmHWM`` where the kernel keeps it, else the larger of ``sampled`` (an
    :class:`RssSampler`'s peak) and the resident set now; ``ru_maxrss`` where
    /proc has neither."""
    hwm = _status_bytes("VmHWM")
    if hwm is not None:
        return hwm
    rss = _status_bytes("VmRSS")
    if rss is not None:
        return max(sampled, rss)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class RssSampler:
    """Reads ``VmRSS`` every ``interval_s`` on a thread while its block runs;
    ``peak`` is the largest read, for kernels that keep no high-water mark."""

    def __init__(self, interval_s: float = 0.01):
        self.interval_s, self.peak = interval_s, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _read(self) -> None:
        self.peak = max(self.peak, _status_bytes("VmRSS") or 0)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._read()

    def __enter__(self):
        self._read()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._read()
        return False


def _host_tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    """Host data of manifest dtype ``dtype`` as a tensor of that dtype,
    without a copy (bfloat16: raw 2-byte data viewed as bf16)."""
    a = np.ascontiguousarray(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


# ---------------------------------------------------------------------------
# Leaf sources
# ---------------------------------------------------------------------------


class CheckpointLeafSource:
    """Leaf-granular view of a saved checkpoint step: metadata from the step
    MANIFEST, tensor data through memory-mapped shard reads.  ``prefix``
    selects the params subtree (a checkpoint of ``{"params": ...}``)."""

    data_available = True

    def __init__(self, directory: str, step: int | None = None, prefix: str = "params"):
        if step is None:
            step = checkpointer.latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no checkpoint steps in {directory!r}")
        self.directory, self.step, self.prefix = directory, int(step), prefix
        pre = prefix + "/" if prefix else ""
        self.leaves = {
            name[len(pre):]: e
            for name, e in checkpointer.leaf_entries(directory, self.step).items()
            if name.startswith(pre)
        }
        if not self.leaves:
            raise ValueError(
                f"checkpoint {directory!r} step {self.step} has no leaves under "
                f"prefix {prefix!r}"
            )

    def describe(self) -> str:
        return f"checkpoint:{self.directory}@{self.step}"

    def _full(self, path: str) -> str:
        return f"{self.prefix}/{path}" if self.prefix else path

    def template(self):
        """Nested tree of ``meta`` tensors over the params subtree; dict keys
        flatten sorted, so ``leaf_index`` agrees with a plan of the tree."""
        return checkpointer._unflatten(
            (path, torch.empty(e["shape"], dtype=dtype_from_name(e["dtype"]), device="meta"))
            for path, e in self.leaves.items()
        )

    def read_band(self, path: str, g: int, r0: int, r1: int) -> torch.Tensor:
        """Rows [r0, r1) of group slice ``g`` as a (r1 - r0, d_out) host
        tensor of the leaf's dtype; the host holds the band, not the leaf."""
        e = self.leaves[path]
        shape = e["shape"]
        lead = shape[:-2]
        idx = np.unravel_index(g, lead) if lead else ()
        index = tuple(slice(int(x), int(x) + 1) for x in idx) + (slice(r0, r1), slice(None))
        arr = checkpointer.read_leaf_slice(self.directory, self.step, self._full(path), index,
                                           entry=e)
        return _host_tensor(arr.reshape(r1 - r0, shape[-1]), e["dtype"])

    def copy_leaf(self, path: str, dst_dir: str, dst_name: str) -> dict:
        entry = checkpointer.copy_leaf_files(self.directory, self.step, self._full(path),
                                             dst_dir, dst_name, entry=self.leaves[path])
        return {dst_name: entry}


class TreeLeafSource:
    """Source over a values tree of tensors (any device; read on the host),
    or of ``meta`` tensors: then only planning and synthetic probing."""

    def __init__(self, tree):
        self._tree = tree
        self.leaves = dict(tree_paths(tree))
        self.data_available = not any(
            leaf.device.type == "meta" for leaf in self.leaves.values()
        )
        self._host: dict = {}

    def describe(self) -> str:
        return "tree:" + ("values" if self.data_available else "metadata-only")

    def template(self):
        return self._tree

    def _host_leaf(self, path: str) -> torch.Tensor:
        if path not in self._host:
            leaf = self.leaves[path]
            if leaf.device.type == "meta":
                raise ValueError(
                    f"metadata-only source holds no data for {path!r} "
                    "(plan/synthetic-probe only)"
                )
            self._host[path] = leaf.detach().cpu().reshape(-1, *leaf.shape[-2:])
        return self._host[path]

    def read_band(self, path: str, g: int, r0: int, r1: int) -> torch.Tensor:
        return self._host_leaf(path)[g, r0:r1, :]

    def copy_leaf(self, path: str, dst_dir: str, dst_name: str) -> dict:
        leaf = self.leaves[path]
        fname = _safe(dst_name) + "__shard0_0.npy"
        np.save(os.path.join(dst_dir, fname), to_numpy(leaf))
        return {dst_name: {
            "shape": list(leaf.shape),
            "dtype": dtype_name(leaf.dtype),
            "shards": [{"file": fname, "index": [[0, int(s)] for s in leaf.shape]}],
        }}


# ---------------------------------------------------------------------------
# Tiles and draws in execute's order (g-major, then row-major (r, c))
# ---------------------------------------------------------------------------


def _gather_tiles(source, t: TensorPlan, idx) -> torch.Tensor:
    """Tiles at sorted global indices as (m, tn, td) float32 on the host,
    reading one row band at a time."""
    tn, td = t.tile_n, t.tile_d
    c = t.d_out // td
    per_slice = (t.d_in // tn) * c
    out = torch.empty((len(idx), tn, td), dtype=torch.float32)
    band_key, band = None, None
    for j, gi in enumerate(np.asarray(idx)):
        g, rem = divmod(int(gi), per_slice)
        i, col = divmod(rem, c)
        if band_key != (g, i):
            band = source.read_band(t.path, g, i * tn, (i + 1) * tn)
            band_key = (g, i)
        out[j] = band[:, col * td:(col + 1) * td]
    return out


def _signs_at(seed: int, t: TensorPlan, idx, device) -> torch.Tensor:
    """Restart signs of the tiles at sorted global indices: execute's draws,
    one group slice's at a time."""
    idx = np.asarray(idx)
    per_slice = t.num_tiles // t.groups
    parts = []
    for g in np.unique(idx // per_slice):
        sel = idx[idx // per_slice == g] - int(g) * per_slice
        parts.append(_slice_signs(seed, t, int(g), device)[torch.as_tensor(sel, device=device)])
    return torch.cat(parts)


def _iter_chunks(source, t: TensorPlan, seed: int, chunk: int, device):
    """(start, tiles (m, tn, td) f32 on ``device``, restart signs (m, K,
    restarts, tn)) chunks in execute's tile order.  The source is read in
    blocks of whole tile rows of at most a chunk's tiles, each moved to the
    device in the leaf's dtype and tiled and widened there: the host holds
    one block, never the tensor."""
    tn, td = t.tile_n, t.tile_d
    r, c = t.d_in // tn, t.d_out // td
    rows = max(1, min(r, chunk // c))
    buf_t, buf_s, n, start = [], [], 0, 0
    for g in range(t.groups):
        ssigns = _slice_signs(seed, t, g, device)
        for i0 in range(0, r, rows):
            k = min(rows, r - i0)
            block = source.read_band(t.path, g, i0 * tn, (i0 + k) * tn).to(device)
            tiles = block.reshape(k, tn, c, td).permute(0, 2, 1, 3).reshape(k * c, tn, td)
            pos = 0
            while pos < k * c:
                take = min(chunk - n, k * c - pos)
                buf_t.append(tiles[pos:pos + take])
                buf_s.append(ssigns[i0 * c + pos:i0 * c + pos + take])
                n += take
                pos += take
                if n == chunk:
                    yield start, torch.cat(buf_t).to(torch.float32), torch.cat(buf_s)
                    start += n
                    buf_t, buf_s, n = [], [], 0
    if n:
        yield start, torch.cat(buf_t).to(torch.float32), torch.cat(buf_s)


def _synthetic_tiles(seed: int, t: TensorPlan, n: int, device) -> torch.Tensor:
    """Init-distribution sample tiles for a metadata-only source: a normal
    truncated at +-2, at the fan-in scale ``params.dense_init`` uses."""
    g = generator(device, seed, _SYNTH_SALT, t.leaf_index, t.tile_n, t.tile_d)
    v = torch.empty((n, t.tile_n, t.tile_d), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=g)
    return v * float(t.d_in) ** -0.5


# ---------------------------------------------------------------------------
# Surrogate probing (SVD tails and calibrated inflation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SurrogateProbe:
    """Surrogate RD curves for the allocator, with each point's confidence
    interval for the boundary fallback."""

    probes: tuple          # ProbeResult per tensor, plan order
    cis: dict              # (path, tile_n, tile_d, K) -> 95% CI on distortion
    factors: tuple         # ((K/tile_n, inflation), ...) calibration table
    sample_tiles: int
    mode: str              # "data" | "synthetic"


def _host64(tiles) -> np.ndarray:
    if isinstance(tiles, torch.Tensor):
        tiles = tiles.detach().cpu().numpy()
    return np.asarray(tiles, dtype=np.float64)


def _svd_tails(tiles, kmax: int) -> np.ndarray:
    """(m, kmax + 1): column K holds each tile's optimal rank-K squared
    residual (the squared singular values beyond the first K), in float64
    on the host."""
    s2 = np.linalg.svd(_host64(tiles), compute_uv=False) ** 2
    rev = np.cumsum(s2[:, ::-1], axis=1)[:, ::-1]
    out = np.zeros((s2.shape[0], kmax + 1), np.float64)
    q = min(s2.shape[1], kmax + 1)
    out[:, :q] = rev[:, :q]
    return out


def _factor_at(factors, frac: float) -> float:
    return float(np.interp(frac, [f[0] for f in factors], [f[1] for f in factors]))


def _trial_iters(ct: TensorPlan, probe_bbo_iters) -> int:
    if probe_bbo_iters and ct.method == "bbo":
        return max(min(ct.bbo_iters, probe_bbo_iters), 1)
    return max(ct.bbo_iters, 1)


def _calibrate_factors(source, plan: CompressionPlan, *, seed, device, sample_tiles,
                       k_fractions, probe_bbo_iters, backend, synthetic, sample, signs):
    """Per-K-fraction inflation of the SVD tail to the binary-M residual,
    from exact trial compressions of one tensor's sample tiles (the tensor
    with the most tiles)."""
    cal = max(plan.tensors, key=lambda t: (t.num_tiles, t.path))
    cands = candidate_settings(cal, tuple(k_fractions), 1)
    ct0 = cands[0]
    if synthetic:
        m = min(sample_tiles, ct0.num_tiles)
        tiles = _synthetic_tiles(seed, ct0, m, device)
        idx = None
    else:
        idx = sample(cal, ct0)
        idx = np.arange(ct0.num_tiles) if idx is None else np.asarray(idx)
        tiles = _gather_tiles(source, ct0, idx).to(device)
    tails = _svd_tails(tiles, cal.tile_n)
    norms2 = (_host64(tiles) ** 2).sum(axis=(1, 2))
    factors = []
    for ct in cands:
        if synthetic:
            s = dec.draw_restart_signs((tiles.shape[0],), ct.K, GREEDY_RESTARTS, ct.tile_n,
                                       generator(device, seed, _SYNTH_SALT, ct.K))
        else:
            s = torch.as_tensor(signs(ct, idx), device=device)
        _, _, errs = compress_tile_batch(
            tiles, s, ct.K, ct.method,
            generator=generator(device, seed, _STREAM_SALT, 0, ct.K),
            bbo_iters=_trial_iters(ct, probe_bbo_iters), backend=backend,
        )
        exact = float(np.mean(errs.double().cpu().numpy() ** 2 * norms2))
        svd = float(np.mean(tails[:, ct.K]))
        f = exact / svd if svd > 0 else _FACTOR_CLIP[1]
        factors.append((ct.K / ct.tile_n, float(np.clip(f, *_FACTOR_CLIP))))
    factors.sort()
    return tuple(factors)


def surrogate_probe(source, plan: CompressionPlan, *, seed: int = 0, device=None,
                    sample_tiles: int = 8, **kw) -> SurrogateProbe:
    """Per-tensor RD curves without trial-compressing every candidate, on
    ``device`` (default: the GPU): per (tensor, geometry) ``sample_tiles``
    tiles (a sorted draw by (seed, leaf_index, tile_n, tile_d), as the
    in-memory probe's ``probe_indices``; synthetic tiles for a metadata-only
    source), each K's distortion the mean SVD-tail residual times the
    calibrated factor.  Keywords as :func:`surrogate_probe_from`."""
    device = resolve_device(device)
    return surrogate_probe_from(
        source, plan,
        sample=lambda t, ct: probe_indices(seed, t, ct, sample_tiles, device),
        signs=lambda ct, idx: _signs_at(seed, ct, idx, device),
        seed=seed, device=device, sample_tiles=sample_tiles, **kw,
    )


def surrogate_probe_from(
    source,
    plan: CompressionPlan,
    *,
    sample,
    signs,
    seed: int = 0,
    device=None,
    weights: dict | None = None,
    sample_tiles: int = 8,
    k_fractions: tuple = DEFAULT_K_FRACTIONS,
    tile_d_choices: int = 1,
    probe_bbo_iters: int | None = 8,
    backend: str | None = None,
    verbose: bool = False,
) -> SurrogateProbe:
    """:func:`surrogate_probe` with the draws given: ``sample(t, ct)`` the
    sorted tile subsample of tensor ``t`` at geometry ``ct`` (None: every
    tile), ``signs(ct, idx)`` the restart signs of ``ct``'s tiles at
    ``idx`` (m, K, restarts, tile_n).  Synthetic tiles and their signs are
    drawn from generators seeded by (seed, synthetic salt, ...)."""
    device = resolve_device(device)
    backend = backend or plan.policy.solver_backend
    weights = weights or {}
    synthetic = not source.data_available
    factors = _calibrate_factors(
        source, plan, seed=seed, device=device, sample_tiles=sample_tiles,
        k_fractions=k_fractions, probe_bbo_iters=probe_bbo_iters, backend=backend,
        synthetic=synthetic, sample=sample, signs=signs,
    )
    probes, cis = [], {}
    for t in plan.tensors:
        pts = [RDPoint(tile_n=0, tile_d=0, K=0, bytes=int(t.orig_bytes), distortion=0.0)]
        geom_cache: dict = {}
        for ct in candidate_settings(t, tuple(k_fractions), tile_d_choices):
            gk = (ct.tile_n, ct.tile_d)
            if gk not in geom_cache:
                if synthetic:
                    tiles = _synthetic_tiles(seed, ct, min(sample_tiles, ct.num_tiles), device)
                else:
                    idx = sample(t, ct)
                    idx = np.arange(ct.num_tiles) if idx is None else np.asarray(idx)
                    tiles = _gather_tiles(source, ct, idx)
                geom_cache[gk] = (tiles.shape[0], _svd_tails(tiles, ct.tile_n))
            m, tails = geom_cache[gk]
            scale = ct.num_tiles * _factor_at(factors, ct.K / ct.tile_n) * \
                float(weights.get(t.path, 1.0))
            tail = tails[:, ct.K]
            d = float(np.mean(tail)) * scale
            ci = 1.96 * float(np.std(tail, ddof=1)) / math.sqrt(m) * scale if m > 1 else d
            pts.append(RDPoint(tile_n=ct.tile_n, tile_d=ct.tile_d, K=ct.K,
                               bytes=int(ct.pred_bytes), distortion=d))
            cis[(t.path, ct.tile_n, ct.tile_d, ct.K)] = ci
        pts.sort(key=lambda p: (p.bytes, p.distortion))
        probes.append(ProbeResult(path=t.path, orig_bytes=t.orig_bytes,
                                  weight=float(weights.get(t.path, 1.0)), points=tuple(pts)))
        if verbose:
            print(f"  surrogate {t.path}: {len(pts) - 1} candidates from "
                  f"{sample_tiles}-tile SVD sample")
    return SurrogateProbe(probes=tuple(probes), cis=cis, factors=factors,
                          sample_tiles=sample_tiles,
                          mode="synthetic" if synthetic else "data")


def _exact_probe_tensor(source, t: TensorPlan, *, seed, device, weights, k_fractions,
                        tile_d_choices, probe_bbo_iters, backend, sample, signs) -> ProbeResult:
    """Exact trial-compression curve of one tensor on the subsample the
    surrogate measured: the fallback at allocation boundaries."""
    w = float((weights or {}).get(t.path, 1.0))
    pts = [RDPoint(tile_n=0, tile_d=0, K=0, bytes=int(t.orig_bytes), distortion=0.0)]
    geom_cache: dict = {}
    for ct in candidate_settings(t, tuple(k_fractions), tile_d_choices):
        gk = (ct.tile_n, ct.tile_d)
        if gk not in geom_cache:
            idx = sample(t, ct)
            idx = np.arange(ct.num_tiles) if idx is None else np.asarray(idx)
            tiles = _gather_tiles(source, ct, idx)
            geom_cache[gk] = (tiles.to(device), idx, (_host64(tiles) ** 2).sum(axis=(1, 2)))
        tiles, idx, norms2 = geom_cache[gk]
        _, _, errs = compress_tile_batch(
            tiles, torch.as_tensor(signs(ct, idx), device=device), ct.K, ct.method,
            generator=generator(device, seed, _STREAM_SALT, t.leaf_index, ct.K),
            bbo_iters=_trial_iters(ct, probe_bbo_iters), backend=backend,
        )
        resid2 = float(np.mean(errs.double().cpu().numpy() ** 2 * norms2))
        pts.append(RDPoint(tile_n=ct.tile_n, tile_d=ct.tile_d, K=ct.K,
                           bytes=int(ct.pred_bytes), distortion=resid2 * ct.num_tiles * w))
    pts.sort(key=lambda p: (p.bytes, p.distortion))
    return ProbeResult(path=t.path, orig_bytes=t.orig_bytes, weight=w, points=tuple(pts))


def _shift_probes(probes, cis, sign: float):
    out = []
    for p in probes:
        pts = tuple(
            pt if pt.dense else dataclasses.replace(
                pt,
                distortion=max(
                    pt.distortion + sign * cis.get((p.path, pt.tile_n, pt.tile_d, pt.K), 0.0),
                    0.0,
                ),
            )
            for pt in p.points
        )
        out.append(dataclasses.replace(p, points=pts))
    return out


def streaming_autotune_plan(
    source,
    policy,
    budget_bytes: int,
    *,
    seed: int = 0,
    device=None,
    engine: str = "greedy",
    sample_tiles: int = 8,
    k_fractions: tuple | None = None,
    tile_d_choices: int = 1,
    probe_bbo_iters: int | None = 8,
    exact_fallback: bool = True,
    backend: str | None = None,
    num_sweeps: int = 96,
    num_reads: int = 8,
    verbose: bool = False,
) -> AutotuneResult:
    """Autotune a plan to ``budget_bytes`` without loading the model, on
    ``device`` (default: the GPU): plan from the source's metadata, probe
    with SVD-tail surrogates, allocate (``engine="qubo"``: one K1 anneal),
    and probe exactly only the tensors whose surrogate CI straddles an
    allocation boundary (not for a metadata-only source).  Returns an
    :class:`AutotuneResult`; the plan's ``autotune.probe`` block records the
    surrogate's mode, factors and fallback set."""
    device = resolve_device(device)
    fracs = DEFAULT_K_FRACTIONS if k_fractions is None else tuple(k_fractions)
    template = source.template()
    base_plan = plan_compression(template, policy)
    if not base_plan.tensors:
        raise ValueError("streaming autotune: the base policy plans no tensors")

    def sample(t, ct):
        return probe_indices(seed, t, ct, sample_tiles, device)

    def signs(ct, idx):
        return _signs_at(seed, ct, idx, device)

    t0 = time.perf_counter()
    sur = surrogate_probe_from(
        source, base_plan, sample=sample, signs=signs, seed=seed, device=device,
        sample_tiles=sample_tiles, k_fractions=fracs, tile_d_choices=tile_d_choices,
        probe_bbo_iters=probe_bbo_iters, backend=backend, verbose=verbose,
    )
    # a tensor whose chosen point moves when every curve shifts to either
    # end of its CI cannot be ranked by the surrogate: probe it exactly
    lo = allocate_budget(_shift_probes(sur.probes, sur.cis, -1.0), budget_bytes,
                         engine="greedy")
    hi = allocate_budget(_shift_probes(sur.probes, sur.cis, +1.0), budget_bytes,
                         engine="greedy")
    boundary = sorted(
        path for path in lo.choices
        if (lo.choices[path].tile_n, lo.choices[path].tile_d, lo.choices[path].K)
        != (hi.choices[path].tile_n, hi.choices[path].tile_d, hi.choices[path].K)
    )
    probes = list(sur.probes)
    exact_probed = []
    if boundary and exact_fallback and source.data_available:
        by_path = {t.path: i for i, t in enumerate(base_plan.tensors)}
        for path in boundary:
            i = by_path[path]
            probes[i] = _exact_probe_tensor(
                source, base_plan.tensors[i], seed=seed, device=device, weights=None,
                k_fractions=fracs, tile_d_choices=tile_d_choices,
                probe_bbo_iters=probe_bbo_iters, backend=backend, sample=sample, signs=signs,
            )
            exact_probed.append(path)
        if verbose:
            print(f"  exact fallback: {len(exact_probed)} boundary tensor(s)")
    probe_s = time.perf_counter() - t0

    allocation = allocate_budget(
        probes, budget_bytes, engine=engine, seed=seed, device=device,
        backend=backend or policy.solver_backend, num_sweeps=num_sweeps, num_reads=num_reads,
    )
    refined_policy = dataclasses.replace(
        policy, rules=allocation_rules(allocation, base_plan) + tuple(policy.rules),
    )
    refined = plan_compression(template, refined_policy)
    _verify_refined(refined, allocation, base_plan)
    metadata = {
        "budget_bytes": int(budget_bytes),
        "engine": allocation.engine,
        "predicted_bytes": allocation.total_bytes,
        "predicted_distortion": allocation.total_distortion,
        "calibrated": False,
        "probe": {
            "mode": "surrogate",
            "source": sur.mode,
            "sample_tiles": sample_tiles,
            "factors": [list(f) for f in sur.factors],
            "boundary": boundary,
            "exact_fallback": exact_probed,
        },
        "allocation": {path: pt.to_dict() for path, pt in sorted(allocation.choices.items())},
    }
    refined = dataclasses.replace(refined, autotune=metadata)
    return AutotuneResult(plan=refined, policy=refined_policy, allocation=allocation,
                          probes=tuple(probes), weights=None, probe_s=probe_s)


# ---------------------------------------------------------------------------
# Streaming execute (bounded host memory, resumable)
# ---------------------------------------------------------------------------


def _fingerprint(plan: CompressionPlan, seed: int, backend: str, budget: int) -> str:
    """Resume guard: a job state applies only to the (plan, seed, backend,
    budget) that made it; the budget sets BBO's chunk boundaries."""
    h = hashlib.sha256()
    h.update(plan.to_json(indent=None).encode())
    h.update(f"repro_torch seed {int(seed)}".encode())
    h.update(backend.encode())
    h.update(str(int(budget)).encode())
    return h.hexdigest()


def _tensor_chunk_tiles(t: TensorPlan, budget: int, device) -> int:
    """Tiles per batched solve of one tensor: the budget over the dense
    tile's bytes with 8x headroom (chunk, device copy, solver temporaries,
    band, output); BBO also under the surrogate-memory chunk, and
    greedy/alternating on a CUDA device under ``EIGH_MAX_BATCH``."""
    chunk = max(1, budget // (8 * 4 * t.tile_n * t.tile_d))
    if t.method == "bbo":
        chunk = min(chunk, auto_pool_chunk(t.num_tiles, t.tile_n, t.K, t.bbo_iters))
    elif t.method in ("greedy", "alternating") and torch.device(device).type == "cuda":
        chunk = min(chunk, EIGH_MAX_BATCH)
    return int(min(chunk, t.num_tiles))


def _compress_tensor_streaming(source, t: TensorPlan, *, seed, device, backend, budget,
                               tmp_dir, dst, verbose):
    """Stream one tensor: band reads -> chunked solves on ``device`` ->
    npy-memmap writes of the packed output.  Returns (manifest tensor entry,
    {leaf name: checkpoint entry})."""
    tn, td, K = t.tile_n, t.tile_d, t.K
    r, c = t.d_in // tn, t.d_out // td
    lead = list(t.shape[:-2])
    kb = (K + 7) // 8
    mp_name, c_name = f"{dst}/m_packed", f"{dst}/C"
    mp_file = _safe(mp_name) + "__shard0_0.npy"
    c_file = _safe(c_name) + "__shard0_0.npy"
    mp_shape = (*lead, r, c, tn, kb)
    c_shape = (*lead, r, c, K, td)
    mp = np.lib.format.open_memmap(os.path.join(tmp_dir, mp_file), mode="w+",
                                   dtype=np.uint8, shape=mp_shape)
    Cm = np.lib.format.open_memmap(os.path.join(tmp_dir, c_file), mode="w+",
                                   dtype=np_dtype(t.dtype), shape=c_shape)
    mp_flat = mp.reshape(-1, tn, kb)
    c_flat = Cm.reshape(-1, K, td)
    chunk = _tensor_chunk_tiles(t, budget, device)
    cast = dtype_from_name(t.dtype)
    err_sum, nt, chunk_sizes = 0.0, 0, []
    for ci, (start, tiles, sgn) in enumerate(_iter_chunks(source, t, seed, chunk, device)):
        M, C, errs = compress_tile_batch(
            tiles, sgn, K, t.method,
            generator=generator(device, seed, _STREAM_SALT, t.leaf_index, ci),
            bbo_iters=max(t.bbo_iters, 1), backend=backend,
        )
        m = M.shape[0]
        mp_flat[start:start + m] = dec.pack_bits(M).cpu().numpy()
        c_flat[start:start + m] = to_numpy(C.to(cast))
        err_sum += float(errs.sum())
        nt += m
        chunk_sizes.append(m)
    mp.flush()
    Cm.flush()
    nb = int(mp.nbytes + Cm.nbytes)
    err = err_sum / max(nt, 1)
    del mp, Cm, mp_flat, c_flat
    entry = {
        "shape": list(t.shape),
        "dtype": t.dtype,
        "groups": t.groups,
        "group_dims": lead,
        "tile_n": tn,
        "tile_d": td,
        "K": K,
        "method": t.method,
        "rule": t.rule,
        "num_tiles": t.num_tiles,
        "orig_bytes": t.orig_bytes,
        "new_bytes": nb,
        "rel_err": err,
        "m_packed": {"shape": list(mp_shape), "dtype": "uint8"},
        "C": {"shape": list(c_shape), "dtype": t.dtype},
        "stream": {"chunk": chunk, "chunk_sizes": chunk_sizes},
    }
    leaves = {
        mp_name: {"shape": list(mp_shape), "dtype": "uint8",
                  "shards": [{"file": mp_file, "index": [[0, int(s)] for s in mp_shape]}]},
        c_name: {"shape": list(c_shape), "dtype": t.dtype,
                 "shards": [{"file": c_file, "index": [[0, int(s)] for s in c_shape]}]},
    }
    if verbose:
        print(f"  [stream] {t.path}: {t.num_tiles} tiles in {len(chunk_sizes)} chunk(s) of "
              f"<= {chunk}, x{t.orig_bytes / max(nb, 1):.1f}, rel_err {err:.3f}")
    return entry, leaves


def _fresh_state(fp: str) -> dict:
    return {"format": STATE_FORMAT, "fingerprint": fp, "completed": {}, "dense": {},
            "leaves": {}}


def _state_complete(state: dict, paths, planned: dict) -> bool:
    return all(
        (p in state["completed"]) if p in planned else (p in state["dense"])
        for p, _ in paths
    )


def execute_streaming(
    source,
    plan: CompressionPlan,
    out_dir: str,
    *,
    seed: int = 0,
    device=None,
    backend: str | None = None,
    budget_bytes: int | None = None,
    state_every: int = 1,
    heartbeat: Heartbeat | None = None,
    step: int = 0,
    verbose: bool = False,
):
    """Execute ``plan`` over ``source`` one leaf at a time under the stream
    budget, solving on ``device`` (default: the GPU), and write a
    restorable compressed checkpoint and manifest to ``out_dir``.  Job state
    is saved after every ``state_every`` leaves; a rerun with the same
    (plan, seed, backend, budget) skips the completed leaves, and the output
    is byte-identical whether or not the job was interrupted.  Returns
    (artifact, stats)."""
    if not getattr(source, "data_available", False):
        raise ValueError(
            "execute_streaming needs tensor data; this source is metadata-only "
            "(plan/probe only)"
        )
    device = resolve_device(device)
    backend = backend or plan.policy.solver_backend
    budget = stream_budget_bytes(budget_bytes)
    os.makedirs(out_dir, exist_ok=True)
    final = checkpointer.step_dir(out_dir, step)
    tmp = final + ".tmp"

    paths = tree_paths(source.template())
    planned = {t.path: t for t in plan.tensors}
    fp = _fingerprint(plan, seed, backend, budget)

    state = checkpointer.load_aux(out_dir, STATE_NAME)
    if not (
        isinstance(state, dict)
        and state.get("format") == STATE_FORMAT
        and state.get("fingerprint") == fp
        and (os.path.isdir(tmp) or _state_complete(state, paths, planned))
    ):
        if state is not None and verbose:
            print("[stream] existing job state does not match this job; starting fresh")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        state = _fresh_state(fp)
    resumed = len(state["completed"]) + len(state["dense"])
    if not _state_complete(state, paths, planned):
        os.makedirs(tmp, exist_ok=True)

    kill_after = int(os.environ.get(KILL_AFTER_ENV, "0") or 0)
    t_start = time.perf_counter()
    done_this_run = 0
    with RssSampler() as rss:
        for i, (path, _) in enumerate(paths):
            dst = f"params/{path}"
            if path in planned:
                if path in state["completed"]:
                    continue
                entry, leaves = _compress_tensor_streaming(
                    source, planned[path], seed=seed, device=device, backend=backend,
                    budget=budget, tmp_dir=tmp, dst=dst, verbose=verbose,
                )
                state["completed"][path] = entry
                state["leaves"].update(leaves)
            else:
                if path in state["dense"]:
                    continue
                state["leaves"].update(source.copy_leaf(path, tmp, dst))
                state["dense"][path] = 1
            done_this_run += 1
            if done_this_run % max(state_every, 1) == 0:
                checkpointer.save_aux(out_dir, STATE_NAME, state)
            if heartbeat is not None:
                heartbeat.beat(i, {"path": path, "phase": "execute"})
            if kill_after and done_this_run >= kill_after:
                os.kill(os.getpid(), signal.SIGKILL)
    checkpointer.save_aux(out_dir, STATE_NAME, state)

    artifact = _finalize(plan, state, paths, out_dir, tmp, final, backend, budget, step)
    try:
        os.remove(os.path.join(out_dir, STATE_NAME))
    except OSError:
        pass
    stats = {
        "resumed_leaves": resumed,
        "leaves_done_this_run": done_this_run,
        "total_leaves": len(paths),
        "wall_s": time.perf_counter() - t_start,
        "budget_bytes": budget,
        "peak_rss_bytes": peak_rss_bytes(rss.peak),
        "chunks": sum(len(e["stream"]["chunk_sizes"]) for e in state["completed"].values()),
    }
    return artifact, stats


def _finalize(plan, state, paths, out_dir, tmp, final, backend, budget, step):
    """The checkpoint MANIFEST and the compression manifest from the job
    state, in template and plan order (so independent of restarts); the
    step directory committed by rename; the artifact saved.  Safe to rerun
    after a crash anywhere between the first write and the state's removal."""
    leaves = {}
    for path, _ in paths:
        dst = f"params/{path}"
        if path in state["completed"]:
            leaves[f"{dst}/m_packed"] = state["leaves"][f"{dst}/m_packed"]
            leaves[f"{dst}/C"] = state["leaves"][f"{dst}/C"]
        else:
            leaves[dst] = state["leaves"][dst]

    tensors, pools = {}, []
    for t in plan.tensors:
        e = state["completed"][t.path]
        tensors[t.path] = e
        sizes = e["stream"]["chunk_sizes"]
        pools.append({
            "tile_n": t.tile_n, "tile_d": t.tile_d, "K": t.K, "method": t.method,
            "num_tiles": t.num_tiles,
            "num_tensors": 1,
            "group_slices": t.groups,
            "chunks": len(sizes),
            "chunk_sizes": sizes,
            "solver_batch": max(sizes) if t.method == "bbo" else None,
            "bbo_iters": t.bbo_iters,
            "solver_calls": t.bbo_iters * len(sizes) if t.method == "bbo" else 0,
            "chunk_policy": "stream",
        })
    ob = sum(e["orig_bytes"] for e in tensors.values())
    nb = sum(e["new_bytes"] for e in tensors.values())
    manifest = {
        "format": MANIFEST_FORMAT,
        "policy": plan.policy.to_dict(),
        "solver_backend": backend,
        "streaming": {"budget_bytes": int(budget)},
        "tensors": tensors,
        "skipped": {p: r for p, r in plan.skipped},
        "pools": pools,
        "totals": {"orig_bytes": int(ob), "new_bytes": int(nb), "ratio": ob / max(nb, 1)},
    }
    if plan.autotune is not None:
        manifest["autotune"] = plan.autotune

    if os.path.isdir(tmp):
        mpath = os.path.join(tmp, "MANIFEST.json")
        with open(mpath + ".part", "w") as f:
            json.dump({"step": int(step), "leaves": leaves}, f)
        os.replace(mpath + ".part", mpath)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    artifact = CompressionArtifact(manifest)
    artifact.save(out_dir)
    return artifact


def run_compression_job(
    source,
    plan: CompressionPlan,
    out_dir: str,
    *,
    seed: int = 0,
    device=None,
    backend: str | None = None,
    budget_bytes: int | None = None,
    max_restarts: int = 3,
    state_every: int = 1,
    heartbeat_path: str | None = None,
    heartbeat_interval_s: float = 15.0,
    verbose: bool = False,
):
    """:func:`execute_streaming` under ``run_with_restarts`` with a file
    heartbeat: a fault inside an attempt restarts it, and the attempt
    resumes from the job state.  Returns (artifact, stats) with
    ``stats["restarts"]``; an uninterrupted run has 0."""
    device = resolve_device(device)
    hb_path = heartbeat_path or os.path.join(out_dir, "stream_heartbeat.json")
    hb = Heartbeat(hb_path, interval_s=heartbeat_interval_s)
    result = {}

    def attempt_run(attempt: int) -> None:
        if attempt and verbose:
            print(f"[stream] restart attempt {attempt}: resuming from job state")
        result["value"] = execute_streaming(
            source, plan, out_dir, seed=seed, device=device, backend=backend,
            budget_bytes=budget_bytes, state_every=state_every, heartbeat=hb, verbose=verbose,
        )

    restarts = run_with_restarts(attempt_run, max_restarts=max_restarts)
    if heartbeat_path is None:
        # liveness, not output: the finished directory is what an
        # unsupervised run leaves
        try:
            os.remove(hb_path)
        except OSError:
            pass
    artifact, stats = result["value"]
    stats["restarts"] = restarts
    return artifact, stats
