"""Distortion probing: fit per-tensor rate-distortion curves cheaply.

Counterpart of ``repro/compression/autotune/probe.py``.  For every tensor
in a base :class:`CompressionPlan`, trial-compress a deterministic
subsample of its tiles over a candidate grid of ``(K, tile)`` settings and
estimate the tensor's full-tensor distortion (sum of squared reconstruction
residuals, optionally weighted by calibration sensitivity) at each
setting's predicted byte cost.

Probing runs the execute stage's own pieces: the tiles come from
``execute._tensor_tiles`` and each tile's greedy restart signs from
``execute._tensor_signs`` at the candidate's K and the tensor's leaf index,
and all tensors' sampled tiles that share a candidate geometry run as
batched ``compress_tile_batch`` calls of at most ``max_pool_tiles`` tiles.
Probing *every* tile with greedy or alternating therefore reproduces
``execute_plan``: predicted distortion equals measured distortion.

The tile subsample of a (tensor, tile geometry) is one sorted draw without
replacement from a generator seeded by (seed, probe salt, leaf_index,
tile_n, tile_d), never by K, so every K candidate of a geometry is measured
on the same tiles.  :func:`probe_tensors_from` takes the subsample and the
signs as functions instead (e.g. the reference's own draws).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.compression.execute import _tensor_signs, _tensor_tiles
from repro_torch.compression.plan import CompressionPlan, TensorPlan, tree_paths
from repro_torch.core.compress import compress_tile_batch, quantize_tile_batch
from repro_torch.device import dtype_from_name, generator, resolve_device

__all__ = [
    "RDPoint",
    "ProbeResult",
    "TrialSplice",
    "candidate_settings",
    "probe_tensors",
    "probe_tensors_from",
    "DEFAULT_K_FRACTIONS",
]

# K / tile_n grid probed per tensor.  The fractions bracket the uniform
# default rank ratios in use (0.125 .. 0.75); K values collapse onto the
# same integer for small tiles and are deduplicated.  At tile_n 32 the grid
# reaches K = 28, whose 2^K sign patterns alternating cannot enumerate:
# pass ``k_fractions`` for such tiles (as the reference must).
DEFAULT_K_FRACTIONS = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875)

_PROBE_SALT = 0x70726F62  # "prob"


@dataclasses.dataclass(frozen=True)
class RDPoint:
    """One point on a tensor's rate-distortion curve.

    ``method``: "" inherits the base plan's method, "int8" is the plain-
    quantisation baseline column (K == 0 but NOT dense), "dense" the
    uncompressed fallback.  The dense point has ``bytes == orig_bytes`` and
    zero distortion."""

    tile_n: int
    tile_d: int
    K: int
    bytes: int
    distortion: float
    method: str = ""

    @property
    def dense(self) -> bool:
        return self.K == 0 and self.method in ("", "dense")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class TrialSplice:
    """Reconstructed trial tiles of one (tensor, candidate) probe, kept
    when ``probe_tensors(keep_trials=True)`` so the eval metric table can
    splice the same trial compression into the live tree."""

    indices: object    # None (every tile probed) or (S,) sorted tile indices
    recon: object      # (S, tn, td) f32 reconstruction from the stored factors
    resid2: float      # full-tensor squared-residual estimate, unweighted
    num_tiles: int     # tiles in the full tensor (extrapolation factor)


@dataclasses.dataclass(frozen=True)
class ProbeResult:
    """A tensor's probed RD curve: candidate points sorted by bytes, the
    dense fallback included, distortions already calibration-weighted."""

    path: str
    orig_bytes: int
    weight: float          # calibration weight (1.0 when uncalibrated)
    points: tuple          # RDPoint, ascending bytes

    @property
    def min_bytes(self) -> int:
        return min(p.bytes for p in self.points)


def _candidate_plan(t: TensorPlan, tn: int, td: int, K: int) -> TensorPlan:
    """``t`` re-geometried to a candidate setting (same path and
    leaf_index, so its restart signs are what execute would draw)."""
    from repro_torch.launch import costing

    r, c = t.d_in // tn, t.d_out // td
    return dataclasses.replace(
        t, tile_n=tn, tile_d=td, K=K, num_tiles=t.groups * r * c,
        pred_bytes=costing.compressed_weight_bytes(
            t.d_in, t.d_out, tn, td, K, dtype_from_name(t.dtype).itemsize, groups=t.groups
        ),
    )


def _candidate_plan_int8(t: TensorPlan, tn: int, td: int) -> TensorPlan:
    """``t`` as the int8-baseline column: per-tile quantisation at the base
    geometry, K=0, bytes from the {"q", "scale"} layout."""
    from repro_torch.launch import costing

    r, c = t.d_in // tn, t.d_out // td
    return dataclasses.replace(
        t, method="int8", tile_n=tn, tile_d=td, K=0, bbo_iters=0,
        num_tiles=t.groups * r * c,
        pred_bytes=costing.int8_weight_bytes(t.d_in, t.d_out, tn, td, groups=t.groups),
    )


def candidate_settings(
    t: TensorPlan,
    k_fractions: tuple = DEFAULT_K_FRACTIONS,
    tile_d_choices: int = 1,
    include_int8: bool = False,
) -> list:
    """Candidate (tile_n, tile_d, K) settings for one tensor: ``tile_n``
    at the base plan's, K over ``k_fractions`` of tile_n, ``tile_d`` also
    halved with ``tile_d_choices=2``; ``include_int8`` appends the int8
    baseline at the base geometry."""
    tds = [t.tile_d]
    if tile_d_choices > 1 and t.tile_d % 2 == 0 and t.tile_d // 2 >= 4:
        tds.append(t.tile_d // 2)
    out, seen = [], set()
    for td in tds:
        for frac in k_fractions:
            K = min(max(int(round(frac * t.tile_n)), 1), t.tile_n - 1)
            if (t.tile_n, td, K) in seen:
                continue
            seen.add((t.tile_n, td, K))
            out.append(_candidate_plan(t, t.tile_n, td, K))
    if include_int8:
        out.append(_candidate_plan_int8(t, t.tile_n, t.tile_d))
    return out


def probe_indices(seed: int, t: TensorPlan, ct: TensorPlan, max_tiles: int | None, device):
    """The tile subsample of one (tensor, tile geometry): None when every
    tile is probed, else ``max_tiles`` sorted distinct indices drawn by a
    generator seeded by (seed, probe salt, leaf_index, tile_n, tile_d)."""
    if not max_tiles or ct.num_tiles <= max_tiles:
        return None
    g = generator(device, seed, _PROBE_SALT, t.leaf_index, ct.tile_n, ct.tile_d)
    perm = torch.randperm(ct.num_tiles, generator=g, device=g.device)
    return torch.sort(perm[:max_tiles]).values


def probe_tensors(
    values,
    plan: CompressionPlan,
    *,
    seed: int = 0,
    device=None,
    weights: dict | None = None,
    max_probe_tiles: int | None = 16,
    tile_d_choices: int = 1,
    k_fractions: tuple = DEFAULT_K_FRACTIONS,
    probe_bbo_iters: int | None = 8,
    backend: str | None = None,
    max_pool_tiles: int | None = 4096,
    include_int8: bool = False,
    keep_trials: bool = False,
    verbose: bool = False,
):
    """Probe every tensor of ``plan`` over its candidate grid on ``device``
    (default: the GPU).

    Returns ``[ProbeResult]`` in plan order (``(probes, trials)`` with
    ``keep_trials``: trials maps ``(path, tile_n, tile_d, K, method)`` to a
    :class:`TrialSplice`).  ``weights`` maps tensor path to a calibration
    weight (missing paths weigh 1.0); ``max_probe_tiles`` bounds the
    trial-compressed tiles per (tensor, candidate) (None: every tile);
    ``probe_bbo_iters`` caps BBO's iterations in trials; ``max_pool_tiles``
    chunks each pooled solve; ``include_int8`` adds the int8 column."""
    device = resolve_device(device)
    return probe_tensors_from(
        values, plan,
        sample=lambda t, ct: probe_indices(seed, t, ct, max_probe_tiles, device),
        signs=lambda t, ct: _tensor_signs(seed, ct, device),
        seed=seed, device=device, weights=weights, tile_d_choices=tile_d_choices,
        k_fractions=k_fractions, probe_bbo_iters=probe_bbo_iters, backend=backend,
        max_pool_tiles=max_pool_tiles, include_int8=include_int8, keep_trials=keep_trials,
        verbose=verbose,
    )


def probe_tensors_from(
    values,
    plan: CompressionPlan,
    *,
    sample,
    signs,
    seed: int = 0,
    device=None,
    weights: dict | None = None,
    tile_d_choices: int = 1,
    k_fractions: tuple = DEFAULT_K_FRACTIONS,
    probe_bbo_iters: int | None = 8,
    backend: str | None = None,
    max_pool_tiles: int | None = 4096,
    include_int8: bool = False,
    keep_trials: bool = False,
    verbose: bool = False,
):
    """:func:`probe_tensors` with the draws given: ``sample(t, ct)`` the
    tile subsample of tensor ``t`` at candidate ``ct`` (None: every tile;
    the same for every K of a geometry) and ``signs(t, ct)`` the restart
    signs of all of ``ct``'s tiles, (num_tiles, K, restarts, tile_n).  BBO
    chunks draw from generators seeded by (seed, probe salt, pool, chunk)."""
    device = resolve_device(device)
    backend = backend or plan.policy.solver_backend
    weights = weights or {}
    leaves = dict(tree_paths(values))

    # -- probe jobs, pooled across tensors by candidate geometry -----------
    pools: dict = {}   # pool_key -> [(t, ct)]
    curves: dict = {t.path: [] for t in plan.tensors}
    trials: dict = {}
    for t in plan.tensors:
        for ct in candidate_settings(t, k_fractions, tile_d_choices, include_int8=include_int8):
            if probe_bbo_iters and ct.method == "bbo":
                ct = dataclasses.replace(ct, bbo_iters=min(ct.bbo_iters, probe_bbo_iters))
            pools.setdefault(ct.pool_key, []).append((t, ct))

    # -- one pooled trial compression per candidate geometry ---------------
    # the sampled tiles are cached per (tensor, tile geometry): K changes
    # neither the tiling nor the sample, only the signs
    geom_cache: dict = {}   # (path, tn, td) -> (tiles, norms2, idx)
    for pidx, (pool_key, jobs) in enumerate(sorted(pools.items())):
        tn, td, K, method, bbo_iters = pool_key
        tiles_parts, signs_parts, norms_parts = [], [], []
        for t, ct in jobs:
            gk = (t.path, ct.tile_n, ct.tile_d)
            if gk not in geom_cache:
                tiles = _tensor_tiles(leaves[t.path], ct, device).to(torch.float32)
                idx = sample(t, ct)
                if idx is not None:
                    idx = torch.as_tensor(idx, device=device)
                    tiles = tiles[idx]
                geom_cache[gk] = (tiles, (tiles * tiles).sum((1, 2)), idx)
            tiles, norms2, idx = geom_cache[gk]
            tiles_parts.append(tiles)
            norms_parts.append(norms2)
            if method != "int8":
                s = torch.as_tensor(signs(t, ct), device=device)
                signs_parts.append(s if idx is None else s[idx])
        all_tiles = torch.cat(tiles_parts)
        all_signs = torch.cat(signs_parts) if signs_parts else None
        total = all_tiles.shape[0]
        chunk = total if not max_pool_tiles else min(total, max_pool_tiles)
        err_parts, fac_parts = [], []
        for ci, start_ix in enumerate(range(0, total, chunk)):
            part = all_tiles[start_ix:start_ix + chunk]
            if method == "int8":
                fa, fb, e = quantize_tile_batch(part)
            else:
                fa, fb, e = compress_tile_batch(
                    part, all_signs[start_ix:start_ix + chunk], K, method,
                    generator=generator(device, seed, _PROBE_SALT, pidx, ci),
                    bbo_iters=max(bbo_iters, 1), backend=backend,
                )
            err_parts.append(e)
            if keep_trials:
                fac_parts.append((fa, fb))
        errs = torch.cat(err_parts)
        if keep_trials:
            fA = torch.cat([f[0] for f in fac_parts])
            fB = torch.cat([f[1] for f in fac_parts])
        if verbose:
            print(f"  probe {method} {tn}x{td} K={K}: {total} trial tiles from "
                  f"{len(jobs)} tensors")
        start = 0
        for (t, ct), norms2 in zip(jobs, norms_parts):
            n = norms2.shape[0]
            err = errs[start:start + n]
            # err is sqrt(objective)/||W_t||: the squared residual of a tile
            # is err^2 * ||W_t||^2; the sampled mean scales to the tensor
            resid2 = float(torch.mean(err.to(torch.float32) ** 2 * norms2))
            w = float(weights.get(t.path, 1.0))
            pt_method = "int8" if ct.method == "int8" else ""
            curves[t.path].append(RDPoint(
                tile_n=ct.tile_n, tile_d=ct.tile_d, K=ct.K, bytes=int(ct.pred_bytes),
                distortion=resid2 * ct.num_tiles * w, method=pt_method,
            ))
            if keep_trials:
                a, b = fA[start:start + n], fB[start:start + n]
                if method == "int8":
                    recon = a.to(torch.float32) * b       # stored: int8 q times f32 scale
                else:
                    # from the STORED factors (C cast to the tensor's dtype,
                    # as execute packs it): a splice measures what serving sees
                    recon = torch.einsum(
                        "tnk,tkd->tnd", a,
                        b.to(dtype_from_name(t.dtype)).to(torch.float32),
                    )
                trials[(t.path, ct.tile_n, ct.tile_d, ct.K, pt_method)] = TrialSplice(
                    indices=geom_cache[(t.path, ct.tile_n, ct.tile_d)][2],
                    recon=recon,
                    resid2=resid2 * ct.num_tiles,
                    num_tiles=ct.num_tiles,
                )
            start += n

    # -- RD curves: dense fallback + candidates, ascending bytes -----------
    out = []
    for t in plan.tensors:
        pts = curves[t.path] + [
            RDPoint(tile_n=0, tile_d=0, K=0, bytes=int(t.orig_bytes), distortion=0.0)
        ]
        pts.sort(key=lambda p: (p.bytes, p.distortion))
        out.append(ProbeResult(
            path=t.path, orig_bytes=t.orig_bytes, weight=float(weights.get(t.path, 1.0)),
            points=tuple(pts),
        ))
    if keep_trials:
        return out, trials
    return out
