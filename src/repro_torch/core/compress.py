"""Tile-wise compression: the per-tile numerical core.

Counterpart of ``repro/core/compress.py``.  A weight matrix W (d_in,
d_out) is cut into (tile_n x tile_d) tiles; each tile is an independent
problem W_t ~ M_t C_t with K = rank_ratio * tile_n, solved as a batch:

  greedy       the paper's original algorithm (Eq. 5)
  alternating  greedy init + exact per-row block-coordinate descent
  bbo          alternating init + nBOCS/SQ refinement (the paper's method),
               all tiles in lock-step through ``bbo.run_bbo_many``
  int8         the plain per-tile integer quantisation baseline

Whole-model compression is :mod:`repro_torch.compression` (plan/execute);
``compress_params`` is the thin wrapper over it that the reference keeps.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import bbo as bbo_lib
from repro_torch.core import decomposition as dec
from repro_torch.device import generator as make_generator

__all__ = [
    "compress_matrix",
    "compress_params",
    "CompressionReport",
    "compress_tile_batch",
    "quantize_tile_batch",
    "tile_matrix",
    "pick_tile",
    "GREEDY_RESTARTS",
]

# random restarts of each greedy rank-one step (repro's greedy default)
GREEDY_RESTARTS = 4


class CompressionReport(NamedTuple):
    compressed: list          # [(path, orig_bytes, new_bytes, rel_err)]
    skipped: list             # [(path, reason)]

    @property
    def total_ratio(self) -> float:
        ob = sum(c[1] for c in self.compressed)
        nb = sum(c[2] for c in self.compressed)
        return ob / max(nb, 1)


def pick_tile(dim: int, want: int, max_tile: int | None = None) -> int | None:
    """The divisor of ``dim`` (>= 4) whose log-ratio to ``want`` is
    smallest, within [want/4, want*4]; ties prefer the smaller divisor;
    ``max_tile`` caps the search.  Identical to ``repro``'s."""
    best, best_d = None, None
    hi = dim if max_tile is None else min(dim, max_tile)
    for t in range(4, hi + 1):
        if dim % t:
            continue
        d = abs(math.log2(t / want))
        if d > 2.0 + 1e-9:
            continue
        if best is None or d < best_d - 1e-12:
            best, best_d = t, d
    return best


def tile_matrix(W: torch.Tensor, tn: int, td: int) -> torch.Tensor:
    """(d_in, d_out) -> (r*c, tn, td) tile stack (row-major over (r, c))."""
    d_in, d_out = W.shape
    r, c = d_in // tn, d_out // td
    return W.reshape(r, tn, c, td).permute(0, 2, 1, 3).reshape(r * c, tn, td)


def compress_tile_batch(
    tiles: torch.Tensor,
    restart_signs: torch.Tensor,
    K: int,
    method: str,
    *,
    generator: torch.Generator | None = None,
    bbo_iters: int = 64,
    backend: str = "auto",
    M0: torch.Tensor | None = None,
    rows: tuple | None = None,
):
    """tiles (T, tn, td) -> (M (T, tn, K), C (T, K, td), rel_err (T,)).

    ``restart_signs`` (T, K, restarts, tn) are each tile's greedy restart
    draws, made per tensor, so a batch pooled from several tensors gives
    each tile exactly what a per-tensor run gives it.  ``generator`` drives
    the BBO refinement (method "bbo" only), which runs all T tiles in
    lock-step.  ``M0`` (T, tn, K) warm-starts each tile: the better of the
    cold and the warm descent by objective proceeds (and seeds BBO).
    ``rows`` (lo, hi, total): the tiles are rows lo:hi of a batch of
    ``total``, and BBO draws for the whole batch and keeps those rows, so
    a rank of a sharded pool gets what the whole batch gives its tiles."""
    tiles = tiles.to(torch.float32)
    T, tn, _ = tiles.shape

    M = dec.greedy_decompose_from(tiles, K, restart_signs).M
    if method in ("alternating", "bbo"):
        M = dec.alternating_decompose(tiles, K, M0=M)[0]

    if M0 is not None:
        M0 = torch.where(M0.to(torch.float32) < 0.0, -1.0, 1.0)
        if method in ("alternating", "bbo"):
            M_warm = dec.alternating_decompose(tiles, K, M0=M0)[0]
        else:
            M_warm = M0
        better = dec.objective(M_warm, tiles) < dec.objective(M, tiles)
        M = torch.where(better[:, None, None], M_warm, M)

    if method == "bbo":
        if generator is None:
            raise ValueError("compress_tile_batch(method='bbo') needs a generator")
        cfg = bbo_lib.BBOConfig(
            n=tn * K, N=tn, K=K, algo="nbocs", solver="sq", iters=bbo_iters,
            init_points=tn * K, num_sweeps=24, num_reads=4, backend=backend,
        )
        res = bbo_lib.run_bbo_many(
            cfg, lambda xs: dec.objective_from_x(xs, tiles, K),
            T if rows is None else rows[2], generator,
            warm_x=M.reshape(T, tn * K) if M0 is not None else None,
            rows=None if rows is None else slice(rows[0], rows[1]),
        )
        x_bbo = res.best_x.reshape(T, tn, K)
        better = res.best_y < dec.objective(M, tiles)
        M = torch.where(better[:, None, None], x_bbo, M)

    C = dec.least_squares_C(M, tiles)
    err = torch.sqrt(torch.clamp_min(dec.objective(M, tiles), 0.0)) / torch.clamp_min(
        torch.linalg.vector_norm(tiles, dim=(-2, -1)), 1e-30
    )
    return M, C, err


def quantize_tile_batch(tiles: torch.Tensor):
    """tiles (T, tn, td) -> (q int8, scale (T, 1, 1) f32, rel_err (T,)):
    symmetric per-tile rounding, scale = max|W_t| / 127."""
    tiles = tiles.to(torch.float32)
    amax = tiles.abs().amax(dim=(1, 2), keepdim=True)
    # the reference is jitted, and XLA folds a division by a constant into a
    # product with its f32 reciprocal (one ulp off a true division for some
    # amax); the division by the non-constant ``safe`` below it leaves alone
    scale = amax * torch.tensor(1 / 127, dtype=torch.float32)
    safe = torch.clamp_min(scale, 1e-30)
    q = torch.clamp(torch.round(tiles / safe), -127.0, 127.0).to(torch.int8)
    resid = tiles - q.to(torch.float32) * scale
    err = torch.sqrt((resid * resid).sum((1, 2))) / torch.clamp_min(
        torch.sqrt((tiles * tiles).sum((1, 2))), 1e-30
    )
    return q, scale, err


def compress_matrix(W: torch.Tensor, ccfg, *, seed: int = 0, method: str | None = None):
    """Compress one 2-D weight; returns ({"m_packed", "C"}, mean rel_err)
    or (None, reason).  Randomness comes from generators seeded by
    ``seed`` on W's device."""
    method = method or ccfg.optimizer
    if W.ndim != 2:
        return None, "not 2D"
    if W.numel() < ccfg.min_size:
        return None, "below min_size"
    tn = pick_tile(W.shape[0], 8 if method == "bbo" else ccfg.tile_n,
                   max_tile=16 if method == "bbo" else None)
    td = pick_tile(W.shape[1], ccfg.tile_d)
    if tn is None or td is None:
        return None, f"indivisible dims {tuple(W.shape)}"
    K = max(int(round(ccfg.rank_ratio * tn)), 1)
    if K >= tn:
        return None, "K >= tile_n (no compression)"
    tiles = tile_matrix(W, tn, td)
    signs = dec.draw_restart_signs(
        (tiles.shape[0],), K, GREEDY_RESTARTS, tn, make_generator(W.device, seed, 0)
    )
    M, C, errs = compress_tile_batch(
        tiles, signs, K, method, generator=make_generator(W.device, seed, 1),
        bbo_iters=ccfg.bbo_iters, backend=ccfg.solver_backend,
    )
    r, c = W.shape[0] // tn, W.shape[1] // td
    packed = dec.pack_bits(M).reshape(r, c, tn, -1)
    return {"m_packed": packed, "C": C.reshape(r, c, K, td).to(W.dtype)}, float(errs.mean())


def compress_params(values: dict, cfg, ccfg=None, *, seed: int = 0, device=None,
                    verbose: bool = False):
    """Compress the eligible linear weights of a values tree: the
    ``CompressionConfig`` (default ``cfg.compression``) becomes a one-rule
    policy, planned and executed with tiles pooled across tensors on
    ``device`` (default: the GPU).  Returns (new_values, CompressionReport)."""
    from repro_torch import compression as comp

    ccfg = ccfg or cfg.compression
    plan = comp.plan_compression(values, ccfg.to_policy())
    new_values, artifact = comp.execute_plan(plan, values, seed=seed, device=device,
                                             verbose=verbose)
    return new_values, artifact.report
