"""Delta recompression: warm-started re-solve of drifted tiles.

Counterpart of ``repro/compression/delta.py``.  Weights drift (fine-tune
steps, merges) and a cold recompression re-solves every tile; a delta
re-solves only the tiles the drift made worse:

  1. **drift**: per tile, ``||W_new_t - M_prev_t C_prev_t||_F`` (the
     parent's factors applied to the new weights) against the tile's
     recorded residual ``manifest["tensors"][p]["tile_resid"]``.  Both sides
     come from :func:`repro_torch.compression.execute.tile_residuals`
     against the stored (dtype-cast) ``C``, so an unchanged tile sits at
     ratio 1.0.  A parent without ``tile_resid`` (a streamed one) takes the
     estimate ``rel_err * ||W_new_t||``.
  2. **plan**: tiles whose ratio exceeds ``threshold`` (default 1.25)
     re-solve; every other tile keeps the parent's bytes.
  3. **solve**: re-solved tiles pool by ``(tile_n, tile_d, K, method,
     bbo_iters)`` as in ``execute_plan`` and run through
     ``compress_tile_batch(M0=M_prev)``.  Each tile's cold start takes its
     slice of the tensor's restart draws (``execute._tensor_signs``), so a
     re-solved greedy/alternating tile is never worse than a cold
     recompression of it; BBO also seeds its surrogate dataset and read 0
     of every anneal from the warm point (``run_bbo_many(warm_x=)`` ->
     ``solve_many(init_state=)`` -> K1).  Pools are cut as execute cuts
     them (``auto_chunk``: greedy/alternating below cuSOLVER's batched-eigh
     limit on the card, BBO by the surrogate budget); BBO chunk ``ci`` of
     pool ``p`` draws from ``generator(device, seed, 0x64656C74, p, ci)``.

The result's manifest is the parent's with a ``delta`` lineage block and new
entries only for tensors that had tiles re-solved: on unchanged weights
every stored byte and every tensor entry is the parent's.

``ColdStartRequired`` is raised when the parent cannot anchor a delta (a
predicted-only manifest, ``prev_params`` that fail ``validate_params``, an
int8 tensor, a missing or reshaped weight); callers fall back to a cold
``plan_compression`` + ``execute_plan``.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from repro_torch.compression.artifact import CompressionArtifact
from repro_torch.compression.execute import (
    _replace,
    _tensor_signs,
    _tensor_tiles,
    auto_chunk,
    tile_residuals,
)
from repro_torch.compression.plan import TensorPlan, tree_paths
from repro_torch.core import decomposition as dec
from repro_torch.core.compress import compress_tile_batch
from repro_torch.device import generator, resolve_device

__all__ = [
    "DEFAULT_DRIFT_THRESHOLD",
    "ColdStartRequired",
    "TensorDrift",
    "DeltaPlan",
    "compute_drift",
    "plan_delta",
    "delta_recompress",
    "delta_recompress_from",
]

# re-solve once the old solution is >= 25% worse on the new weights than it
# was at compression time; an unchanged tile sits at ratio 1.0
DEFAULT_DRIFT_THRESHOLD = 1.25
_DELTA_SALT = 0x64656C74   # "delt", as repro folds it into a delta's BBO key


class ColdStartRequired(ValueError):
    """The parent artifact cannot anchor a delta; run a cold compression
    (``plan_compression`` + ``execute_plan``) instead."""


@dataclasses.dataclass(frozen=True)
class TensorDrift:
    """Per-tile drift of one manifested tensor against its parent solve."""

    path: str
    drift: np.ndarray         # (num_tiles,) ||W_new_t - M_prev_t C_prev_t||_F
    resid_prev: np.ndarray    # (num_tiles,) the parent's residual
    recorded: bool            # True: manifest tile_resid; False: estimated
                              # as rel_err * ||W_new_t|| (streamed parents)

    @property
    def ratio(self) -> np.ndarray:
        return self.drift / np.maximum(self.resid_prev, 1e-30)


@dataclasses.dataclass(frozen=True)
class DeltaPlan:
    """Which tiles re-solve: the drift measurements and a boolean mask per
    tensor (True = drift ratio above the threshold)."""

    drifts: tuple
    masks: dict
    threshold: float
    parent_fingerprint: str

    @property
    def tiles_total(self) -> int:
        return sum(d.drift.size for d in self.drifts)

    @property
    def tiles_resolved(self) -> int:
        return sum(int(m.sum()) for m in self.masks.values())

    @property
    def fraction_resolved(self) -> float:
        return self.tiles_resolved / max(self.tiles_total, 1)

    def summary(self) -> str:
        lines = [
            f"DeltaPlan: {self.tiles_resolved}/{self.tiles_total} tiles "
            f"re-solve ({self.fraction_resolved:.1%}) at threshold "
            f"{self.threshold} (parent {self.parent_fingerprint})"
        ]
        for d in self.drifts:
            m = self.masks[d.path]
            lines.append(
                f"  {d.path:48s} {int(m.sum()):5d}/{m.size:<5d} "
                f"max ratio {float(d.ratio.max()):.2f}"
                + ("" if d.recorded else "  (estimated baseline)")
            )
        return "\n".join(lines)


def _entry_plan(path: str, entry: dict, leaf_order: dict) -> TensorPlan:
    """The :class:`TensorPlan` a manifest entry was executed from.  Its
    ``leaf_index`` seeds the tensor's restart draws; a manifest without one
    (a streamed parent) takes the tensor's position in the new values tree."""
    leaf_index = entry.get("leaf_index")
    if leaf_index is None:
        leaf_index = leaf_order[path]
    return TensorPlan(
        path=path,
        leaf_index=int(leaf_index),
        shape=tuple(entry["shape"]),
        dtype=entry["dtype"],
        groups=int(entry["groups"]),
        tile_n=int(entry["tile_n"]),
        tile_d=int(entry["tile_d"]),
        K=int(entry["K"]),
        method=entry["method"],
        rule=entry.get("rule", ""),
        num_tiles=int(entry["num_tiles"]),
        orig_bytes=int(entry["orig_bytes"]),
        pred_bytes=int(entry["new_bytes"]),
        bbo_iters=int(entry.get("bbo_iters") or 0),
    )


def _prev_factors(leaves_prev: dict, t: TensorPlan, device):
    """The parent's stored factors of one tensor as per-tile stacks:
    M (num_tiles, tn, K) in {-1, +1} f32, C (num_tiles, K, td)."""
    kb = (t.K + 7) // 8
    mp = leaves_prev[f"{t.path}/m_packed"].to(device).reshape(t.num_tiles, t.tile_n, kb)
    C = leaves_prev[f"{t.path}/C"].to(device).reshape(t.num_tiles, t.K, t.tile_d)
    return dec.unpack_bits(mp, t.K), C


def _anchor(artifact: CompressionArtifact, prev_params, new_values):
    """Validate the (parent, prev, new) triple: (plans, leaves_prev,
    leaves_new), or :class:`ColdStartRequired`."""
    manifest = artifact.manifest
    if manifest.get("predicted_only"):
        raise ColdStartRequired(
            "parent manifest is predicted-only (no solver ran); cold compression required"
        )
    problems = artifact.validate_params(prev_params)
    if problems:
        raise ColdStartRequired(
            "prev_params does not match the parent manifest; cold compression "
            "required:\n  " + "\n  ".join(problems)
        )
    pairs = tree_paths(new_values)
    leaves_new = dict(pairs)
    leaf_order = {p: i for i, (p, _) in enumerate(pairs)}
    plans = []
    for path, entry in manifest["tensors"].items():
        if entry.get("method") == "int8":
            raise ColdStartRequired(
                f"manifested tensor {path!r} uses the int8 baseline, which has no "
                "warm-startable factors; cold compression required"
            )
        leaf = leaves_new.get(path)
        if leaf is None:
            raise ColdStartRequired(
                f"manifested tensor {path!r} missing from the new values tree; "
                "cold compression required"
            )
        if tuple(leaf.shape) != tuple(entry["shape"]):
            raise ColdStartRequired(
                f"shape of {path!r} changed: manifest {tuple(entry['shape'])} vs new "
                f"{tuple(leaf.shape)}; cold compression required"
            )
        plans.append(_entry_plan(path, entry, leaf_order))
    return plans, dict(tree_paths(prev_params)), leaves_new


def _norms(tiles) -> torch.Tensor:
    t = tiles.to(torch.float32)
    return torch.sqrt((t * t).sum((1, 2)))


def compute_drift(artifact: CompressionArtifact, prev_params, new_values, *,
                  device=None) -> list:
    """Per-tile drift of every manifested tensor on ``device`` (default:
    the GPU): [:class:`TensorDrift`] in manifest order."""
    device = resolve_device(device)
    plans, leaves_prev, leaves_new = _anchor(artifact, prev_params, new_values)
    out = []
    for t in plans:
        entry = artifact.manifest["tensors"][t.path]
        tiles = _tensor_tiles(leaves_new[t.path], t, device)
        Mp, Cp = _prev_factors(leaves_prev, t, device)
        drift = tile_residuals(tiles, Mp, Cp).double().cpu().numpy()
        recorded = entry.get("tile_resid") is not None
        if recorded:
            resid_prev = np.asarray(entry["tile_resid"], dtype=np.float64)
        else:
            resid_prev = float(entry["rel_err"]) * _norms(tiles).double().cpu().numpy()
        out.append(TensorDrift(t.path, drift, resid_prev, recorded))
    return out


def plan_delta(artifact: CompressionArtifact, prev_params, new_values,
               threshold: float = DEFAULT_DRIFT_THRESHOLD, *, device=None) -> DeltaPlan:
    """Measure drift and decide which tiles re-solve."""
    drifts = compute_drift(artifact, prev_params, new_values, device=device)
    return DeltaPlan(
        drifts=tuple(drifts),
        masks={d.path: d.ratio > threshold for d in drifts},
        threshold=float(threshold),
        parent_fingerprint=artifact.fingerprint(),
    )


def delta_recompress(
    artifact: CompressionArtifact,
    prev_params,
    new_values,
    *,
    seed: int = 0,
    device=None,
    threshold: float = DEFAULT_DRIFT_THRESHOLD,
    backend: str | None = None,
    verbose: bool = False,
):
    """Recompress ``new_values`` as a delta against a parent artifact on
    ``device`` (default: the GPU).

    ``prev_params`` is the parent's compressed params tree (every manifested
    tensor as ``{"m_packed", "C"}``); ``new_values`` the drifted dense tree.
    Returns ``(new_compressed_values, artifact)`` as ``execute_plan`` does;
    reused tensors' leaves are the parent's tensors themselves.  A tile's
    cold start takes its slice of what ``execute_plan`` at ``seed`` draws
    for it.  Raises :class:`ColdStartRequired` when the parent cannot anchor
    a delta."""
    device = resolve_device(device)
    return delta_recompress_from(
        artifact, prev_params, new_values,
        signs=lambda t: _tensor_signs(seed, t, device),
        seed=seed, device=device, threshold=threshold, backend=backend, verbose=verbose,
    )


def delta_recompress_from(
    artifact: CompressionArtifact,
    prev_params,
    new_values,
    *,
    signs,
    seed: int = 0,
    device=None,
    threshold: float = DEFAULT_DRIFT_THRESHOLD,
    backend: str | None = None,
    verbose: bool = False,
):
    """:func:`delta_recompress` with the restart draws given: ``signs(t)``
    returns every tile's restart signs of tensor ``t``, (num_tiles, K,
    restarts, tile_n) (e.g. the reference's own draws)."""
    device = resolve_device(device)
    backend = backend or artifact.manifest.get("solver_backend", "auto")
    plans, leaves_prev, leaves_new = _anchor(artifact, prev_params, new_values)
    dplan = plan_delta(artifact, prev_params, new_values, threshold, device=device)
    if verbose:
        print(dplan.summary())

    pools: dict = {}
    for t in plans:
        idx = np.nonzero(dplan.masks[t.path])[0]
        if idx.size:
            pools.setdefault(t.pool_key, []).append((t, idx))

    results, pool_stats = {}, []
    for pidx, (pk, members) in enumerate(pools.items()):
        tn, td, K, method, bbo_iters = pk
        sel_t, sel_s, sel_m0 = [], [], []
        for t, idx in members:
            ji = torch.as_tensor(idx, device=device)
            sel_t.append(_tensor_tiles(leaves_new[t.path], t, device)[ji])
            sel_s.append(torch.as_tensor(signs(t), device=device)[ji])
            sel_m0.append(_prev_factors(leaves_prev, t, device)[0][ji])
        tiles, sgn, m0 = torch.cat(sel_t), torch.cat(sel_s), torch.cat(sel_m0)
        total = int(tiles.shape[0])
        chunk = auto_chunk(total, method, tn, K, bbo_iters, device)
        parts, chunk_sizes = [], []
        for ci, start in enumerate(range(0, total, chunk)):
            sl = slice(start, min(start + chunk, total))
            chunk_sizes.append(sl.stop - sl.start)
            parts.append(compress_tile_batch(
                tiles[sl], sgn[sl], K, method,
                generator=generator(device, seed, _DELTA_SALT, pidx, ci),
                bbo_iters=max(bbo_iters, 1), backend=backend, M0=m0[sl],
            ))
        M, C, _ = (torch.cat(xs) for xs in zip(*parts))
        start = 0
        for t, idx in members:
            stop = start + idx.size
            results[t.path] = (idx, M[start:stop], C[start:stop])
            start = stop
        pool_stats.append({
            "tile_n": tn, "tile_d": td, "K": K, "method": method,
            "num_tiles": total,
            "num_tensors": len(members),
            "chunks": len(chunk_sizes),
            "chunk_sizes": chunk_sizes,
            "solver_batch": max(chunk_sizes) if method == "bbo" else None,
            "bbo_iters": bbo_iters,
            "solver_calls": bbo_iters * len(chunk_sizes) if method == "bbo" else 0,
            "warm_started": True,
        })
        if verbose:
            print(f"  delta pool {method} {tn}x{td} K={K}: {total} tiles re-solved from "
                  f"{len(members)} tensors ({len(chunk_sizes)} chunk(s))")

    # -- splice re-solved tiles into the parent's stored factors -----------
    manifest = copy.deepcopy(artifact.manifest)
    new_leaves = {}
    for t in plans:
        mp_prev = leaves_prev[f"{t.path}/m_packed"]
        C_prev = leaves_prev[f"{t.path}/C"]
        if t.path not in results:
            new_leaves[t.path] = {"m_packed": mp_prev, "C": C_prev}
            continue
        idx, M_sel, C_sel = results[t.path]
        ji = torch.as_tensor(idx, device=device)
        mp_flat = mp_prev.to(device).reshape(t.num_tiles, t.tile_n, -1).clone()
        c_flat = C_prev.to(device).reshape(t.num_tiles, t.K, t.tile_d).clone()
        mp_flat[ji] = dec.pack_bits(M_sel)
        c_flat[ji] = C_sel.to(c_flat.dtype)
        new_leaves[t.path] = {"m_packed": mp_flat.reshape(mp_prev.shape),
                              "C": c_flat.reshape(C_prev.shape)}
        # the entry's residuals against the new weights and spliced factors
        tiles = _tensor_tiles(leaves_new[t.path], t, device)
        resid = tile_residuals(tiles, dec.unpack_bits(mp_flat, t.K), c_flat)
        entry = manifest["tensors"][t.path]
        entry["rel_err"] = float((resid / _norms(tiles).clamp_min(1e-30)).mean())
        entry["tile_resid"] = [float(f"{v:.8g}") for v in resid.tolist()]
        entry["leaf_index"] = t.leaf_index
        entry["bbo_iters"] = t.bbo_iters

    manifest["pools"] = pool_stats
    manifest["solver_backend"] = backend
    manifest["delta"] = {
        "parent_fingerprint": dplan.parent_fingerprint,
        "generation": int(artifact.manifest.get("delta", {}).get("generation", 0)) + 1,
        "threshold": float(threshold),
        "tiles_total": dplan.tiles_total,
        "tiles_resolved": dplan.tiles_resolved,
        "tiles_reused": dplan.tiles_total - dplan.tiles_resolved,
        "fraction_resolved": dplan.fraction_resolved,
        "tensors_touched": len(results),
        "per_tensor": {
            d.path: {
                "num_tiles": int(d.drift.size),
                "resolved": int(dplan.masks[d.path].sum()),
                "max_ratio": float(d.ratio.max()),
            }
            for d in dplan.drifts
        },
    }
    return _replace(new_values, new_leaves), CompressionArtifact(manifest)
