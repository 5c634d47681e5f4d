"""Execute stage: run a :class:`CompressionPlan` with cross-tensor pooling.

Counterpart of ``repro/compression/execute.py::execute_plan``.  Tiles of
every planned tensor are pooled by (tile_n, tile_d, K, method, bbo_iters)
and each pool runs as batched ``compress_tile_batch`` calls of at most
``max_pool_tiles`` tiles; for BBO each such chunk is one lock-step
``run_bbo_many`` whose every iteration is ONE annealing kernel launch over
the whole chunk.

Reproducibility contract: each tensor's greedy restart draws come from a
generator seeded by (seed, leaf_index, group slice), drawn for the whole
tensor before it is cut into chunks, so greedy/alternating output does not
depend on pooling or chunking (as ``repro``'s per-tile keys make it).  BBO
chunks draw from a generator seeded by (seed, pool, chunk): deterministic
per (plan, seed, chunking).  The port's draws are not ``repro``'s
(``torch.Generator`` is not threefry), so its results agree with ``repro``
in quality, not in bits.

``mesh`` shards each chunk's tiles over every rank of the mesh (the
reference's ``_shard_pool``): rank r solves the r-th block of the chunk's
tiles and the blocks are all-gathered.  A block's greedy draws are its
rows of the tensors' draws, and a BBO block's are its rows of what the
whole chunk draws (``compress_tile_batch(rows=)``), so the artifact is
byte-identical to the unsharded one.  A chunk whose tile count the mesh
does not divide runs replicated on every rank, and says so.
"""

from __future__ import annotations

import math
import os

import torch

from repro_torch.compression.artifact import CompressionArtifact, MANIFEST_FORMAT
from repro_torch.compression.plan import CompressionPlan, TensorPlan, tree_paths
from repro_torch.core import decomposition as dec
from repro_torch.core import features as feat
from repro_torch.core import quantized
from repro_torch.core.compress import (
    GREEDY_RESTARTS, compress_tile_batch, quantize_tile_batch, tile_matrix,
)
from repro_torch.device import dtype_name, generator, resolve_device

__all__ = [
    "execute_plan",
    "surrogate_tile_bytes",
    "auto_pool_chunk",
    "auto_chunk",
    "EIGH_MAX_BATCH",
    "tile_residuals",
    "POOL_BUDGET_ENV",
]

POOL_BUDGET_ENV = "REPRO_POOL_BUDGET_BYTES"
_DEFAULT_POOL_BUDGET = 64 << 20
_MIN_BBO_CHUNK = 64
_MAX_POOL_CHUNK = 4096
_POOL_SALT = 0x706F6F6C      # "pool", as repro folds it into the pool key
# Tiles per greedy/alternating chunk on a CUDA device: both solve their
# least squares through batched eigh (see decomposition.EIGH_MAX_BATCH).
EIGH_MAX_BATCH = dec.EIGH_MAX_BATCH


def surrogate_tile_bytes(tile_n: int, K: int, bbo_iters: int) -> int:
    """Per-tile BBO surrogate footprint in bytes: the (p, p) Gram matrix
    plus its Cholesky/solve temporaries (~3 p^2 floats) and the dataset."""
    n = tile_n * K
    p = feat.num_features(n)
    max_points = n + max(bbo_iters, 1)
    return 4 * (3 * p * p + 4 * p) + 4 * max_points * (n + 2)


def auto_pool_chunk(
    total_tiles: int, tile_n: int, K: int, bbo_iters: int,
    budget_bytes: int | None = None,
) -> int:
    """Tiles per lock-step BBO batch under the surrogate budget
    (``REPRO_POOL_BUDGET_BYTES``), split evenly when the pool exceeds it."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get(POOL_BUDGET_ENV, _DEFAULT_POOL_BUDGET))
    per_tile = surrogate_tile_bytes(tile_n, K, bbo_iters)
    cap = max(_MIN_BBO_CHUNK, min(_MAX_POOL_CHUNK, budget_bytes // per_tile))
    return _even_split(total_tiles, cap)


def _even_split(total: int, cap: int) -> int:
    """The chunk size that cuts ``total`` into the fewest chunks of at most
    ``cap`` tiles, as evenly as possible."""
    if total <= cap:
        return total
    n_chunks = -(-total // cap)
    return -(-total // n_chunks)


def auto_chunk(total_tiles: int, method: str, tile_n: int, K: int, bbo_iters: int,
               device) -> int:
    """Tiles per chunk under ``max_pool_tiles="auto"``: BBO pools by the
    surrogate budget (``auto_pool_chunk``); greedy and alternating pools on
    a CUDA device at most ``EIGH_MAX_BATCH`` (chunking does not change
    their results), elsewhere whole; int8 pools whole."""
    if method == "bbo":
        return auto_pool_chunk(total_tiles, tile_n, K, bbo_iters)
    if method in ("greedy", "alternating") and torch.device(device).type == "cuda":
        return _even_split(total_tiles, EIGH_MAX_BATCH)
    return total_tiles


def tile_residuals(tiles, M, C) -> torch.Tensor:
    """Per-tile ||W_t - M_t C_t||_F in f32 over a (T, tn, td) stack,
    against the stored (dtype-cast) C."""
    V = M.to(torch.float32) @ C.to(torch.float32)
    d = tiles.to(torch.float32) - V
    return torch.sqrt((d * d).sum((1, 2)))


def _validate(plan: CompressionPlan, leaves: dict) -> None:
    for t in plan.tensors:
        if t.path not in leaves:
            raise ValueError(f"plan tensor {t.path!r} not found in values tree")
        if tuple(leaves[t.path].shape) != t.shape:
            raise ValueError(
                f"plan/values shape mismatch at {t.path!r}: planned {t.shape}, "
                f"got {tuple(leaves[t.path].shape)}"
            )


def _tensor_tiles(leaf, t: TensorPlan, device):
    """(num_tiles, tn, td) stack across group slices (g-major)."""
    leaf = leaf.to(device)
    if len(t.shape) > 2:
        flat = leaf.reshape(t.groups, t.d_in, t.d_out)
        return torch.cat([tile_matrix(flat[g], t.tile_n, t.tile_d) for g in range(t.groups)])
    return tile_matrix(leaf, t.tile_n, t.tile_d)


def _slice_signs(seed: int, t: TensorPlan, g: int, device):
    """Greedy restart draws of every tile of group slice ``g`` of one
    tensor, (tiles_per_slice, K, restarts, tile_n), from the generator of
    (seed, leaf_index, g): what a chunk of any size takes its slice of."""
    return dec.draw_restart_signs(
        (t.num_tiles // t.groups,), t.K, GREEDY_RESTARTS, t.tile_n,
        generator(device, seed, t.leaf_index, g),
    )


def _tensor_signs(seed: int, t: TensorPlan, device):
    """Greedy restart draws of every tile of one tensor: one generator per
    (seed, leaf_index, group slice), independent of pooling."""
    return torch.cat([_slice_signs(seed, t, g, device) for g in range(t.groups)])


def _iter_chunks(members, leaves, seed, chunk, device, with_signs):
    """(tiles, signs) chunks of at most ``chunk`` tiles, walking the pool's
    tensors in order; at most one tensor's stack plus one chunk in flight."""
    buf_t, buf_s, n = [], [], 0
    for t in members:
        tiles = _tensor_tiles(leaves[t.path], t, device)
        signs = _tensor_signs(seed, t, device) if with_signs else None
        pos = 0
        while pos < t.num_tiles:
            take = min(chunk - n, t.num_tiles - pos)
            buf_t.append(tiles[pos:pos + take])
            if with_signs:
                buf_s.append(signs[pos:pos + take])
            n += take
            pos += take
            if n == chunk:
                yield torch.cat(buf_t), (torch.cat(buf_s) if with_signs else None)
                buf_t, buf_s, n = [], [], 0
    if n:
        yield torch.cat(buf_t), (torch.cat(buf_s) if with_signs else None)


def _pack_tensor(t: TensorPlan, M_seg, C_seg, dtype):
    r, c = t.d_in // t.tile_n, t.d_out // t.tile_d
    lead = t.shape[:-2]
    packed = dec.pack_bits(M_seg).reshape(*lead, r, c, t.tile_n, -1)
    return {"m_packed": packed, "C": C_seg.reshape(*lead, r, c, t.K, t.tile_d).to(dtype)}


def _pack_tensor_int8(t: TensorPlan, q_seg, scale_seg):
    r, c = t.d_in // t.tile_n, t.d_out // t.tile_d
    lead = t.shape[:-2]
    return {
        "q": q_seg.reshape(*lead, r, c, t.tile_n, t.tile_d),
        "scale": scale_seg.reshape(*lead, r, c, 1, 1),
    }


def _gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal block of rows, in rank order."""
    import torch.distributed as dist

    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _leaf_spec(w: dict) -> dict:
    return {k: {"shape": list(v.shape), "dtype": dtype_name(v.dtype)} for k, v in w.items()}


def _replace(tree, new: dict, prefix: str = ""):
    """``tree`` with the leaves at the paths of ``new`` replaced (paths as
    ``tree_paths`` names them); every other leaf is the same object."""
    if isinstance(tree, dict):
        return {k: _replace(v, new, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_replace(v, new, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return new.get(prefix, tree)


def execute_plan(
    plan: CompressionPlan,
    values,
    *,
    seed: int = 0,
    device=None,
    mesh=None,
    backend: str | None = None,
    max_pool_tiles: int | str | None = "auto",
    verbose: bool = False,
):
    """Execute ``plan`` over ``values`` on ``device`` (default: the GPU);
    returns (new_values, artifact).

    ``max_pool_tiles`` bounds the tiles per batched solve: "auto" sizes each
    BBO pool's chunk from the surrogate memory model and cuts
    greedy/alternating pools on a CUDA device to ``EIGH_MAX_BATCH`` tiles
    (whole elsewhere; see ``auto_chunk``); an int pins the bound for every
    pool; None disables chunking.  ``backend`` overrides the policy's solver
    backend (auto|cuda|torch; it must match the device).  ``mesh`` shards
    each chunk over the mesh's ranks (module docstring); every rank calls
    this with the same plan and values, on its device on the mesh."""
    if mesh is not None:
        from repro_torch.distributed.sharding import mesh_device, mesh_shape

        device = mesh_device(mesh)
        n_dev = math.prod(mesh_shape(mesh).values())
    device = resolve_device(device)
    backend = backend or plan.policy.solver_backend
    leaves = dict(tree_paths(values))
    _validate(plan, leaves)

    results, pool_stats = {}, []
    for pidx, (pool_key, members) in enumerate(plan.pools().items()):
        tn, td, K, method, bbo_iters = pool_key
        total = sum(t.num_tiles for t in members)
        if max_pool_tiles == "auto":
            chunk = auto_chunk(total, method, tn, K, bbo_iters, device)
        else:
            chunk = total if not max_pool_tiles else min(total, max_pool_tiles)
        n_chunks = -(-total // chunk)
        parts, chunk_sizes = [], []
        for ci, (ct, cs) in enumerate(_iter_chunks(
            members, leaves, seed, chunk, device, with_signs=method != "int8"
        )):
            T = int(ct.shape[0])
            chunk_sizes.append(T)
            rows = None
            if mesh is not None:
                if T % n_dev:
                    print(f"[compress] pool {method} {tn}x{td} K={K} chunk {ci}: {T} tiles "
                          f"do not divide the {n_dev}-device mesh; running replicated")
                else:
                    import torch.distributed as dist

                    per = T // n_dev
                    rows = (dist.get_rank() * per, (dist.get_rank() + 1) * per, T)
                    ct, cs = ct[rows[0]:rows[1]], None if cs is None else cs[rows[0]:rows[1]]
            if method == "int8":
                out = quantize_tile_batch(ct)
            else:
                out = compress_tile_batch(
                    ct, cs, K, method,
                    generator=generator(device, seed, _POOL_SALT, pidx, ci),
                    bbo_iters=max(bbo_iters, 1), backend=backend, rows=rows,
                )
            parts.append(out if rows is None or n_dev == 1 else tuple(map(_gather_rows, out)))
        M, C, errs = (torch.cat(xs) for xs in zip(*parts))
        start = 0
        for t in members:
            stop = start + t.num_tiles
            results[t.path] = (M[start:stop], C[start:stop], errs[start:stop])
            start = stop
        pool_stats.append({
            "tile_n": tn, "tile_d": td, "K": K, "method": method,
            "num_tiles": total,
            "num_tensors": len(members),
            "group_slices": sum(t.groups for t in members),
            "chunks": n_chunks,
            "chunk_sizes": chunk_sizes,
            "solver_batch": max(chunk_sizes) if method == "bbo" else None,
            "bbo_iters": bbo_iters,
            "solver_calls": bbo_iters * n_chunks if method == "bbo" else 0,
            "chunk_policy": "auto" if max_pool_tiles == "auto" else "fixed",
            **(
                {"surrogate_tile_bytes": surrogate_tile_bytes(tn, K, bbo_iters)}
                if method == "bbo" else {}
            ),
        })
        if verbose:
            print(f"  pool {method} {tn}x{td} K={K}: {total} tiles "
                  f"from {len(members)} tensors ({n_chunks} chunk(s))")

    new, manifest_tensors, compressed = {}, {}, []
    for t in plan.tensors:
        leaf = leaves[t.path]
        M_seg, C_seg, err_seg = results[t.path]
        err = float(err_seg.mean())
        tiles = _tensor_tiles(leaf, t, device)
        if t.method == "int8":
            w = _pack_tensor_int8(t, M_seg, C_seg)
            nb = quantized.intquant_num_bytes(w)
            d = tiles.to(torch.float32) - M_seg.to(torch.float32) * C_seg
            resid = torch.sqrt((d * d).sum((1, 2)))
        else:
            w = _pack_tensor(t, M_seg, C_seg, leaf.dtype)
            nb = quantized.compressed_num_bytes(w)
            resid = tile_residuals(tiles, M_seg, w["C"].reshape(-1, t.K, t.tile_d))
        compressed.append((t.path, t.orig_bytes, nb, err))
        manifest_tensors[t.path] = {
            "shape": list(t.shape),
            "dtype": t.dtype,
            "groups": t.groups,
            "group_dims": list(t.shape[:-2]),
            "tile_n": t.tile_n,
            "tile_d": t.tile_d,
            "K": t.K,
            "method": t.method,
            "rule": t.rule,
            "leaf_index": t.leaf_index,
            "bbo_iters": t.bbo_iters,
            "num_tiles": t.num_tiles,
            "orig_bytes": t.orig_bytes,
            "new_bytes": int(nb),
            "rel_err": err,
            "tile_resid": [float(f"{v:.8g}") for v in resid.tolist()],
            **_leaf_spec(w),
        }
        new[t.path] = w
        if verbose:
            print(f"  compressed {t.path}: x{t.orig_bytes / max(nb, 1):.1f}, "
                  f"rel_err {err:.3f}")

    ob = sum(c[1] for c in compressed)
    nb_total = sum(c[2] for c in compressed)
    manifest = {
        "format": MANIFEST_FORMAT,
        "policy": plan.policy.to_dict(),
        "solver_backend": backend,
        "tensors": manifest_tensors,
        "skipped": {p: r for p, r in plan.skipped},
        "pools": pool_stats,
        "totals": {
            "orig_bytes": int(ob),
            "new_bytes": int(nb_total),
            "ratio": ob / max(nb_total, 1),
        },
    }
    if plan.autotune is not None:
        manifest["autotune"] = plan.autotune
    return _replace(values, new), CompressionArtifact(manifest)
