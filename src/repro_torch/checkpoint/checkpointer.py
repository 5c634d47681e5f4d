"""Checkpoints in the JAX package's on-disk format.

Counterpart of the save/restore half of ``repro/checkpoint/checkpointer.py``:

    step_00000000.tmp/            # written first, renamed at the end
      MANIFEST.json               # {"step", "leaves": {path: {shape, dtype, shards}}}
      <leafpath>__shard0_0.npy    # one .npy per shard per leaf
    step_00000000/                # rename(tmp) == commit

A tree of DTensors on several ranks is written by every rank, one file
per rank and leaf (``__shard<rank>_0``, a replicated shard by each rank
that holds it, as the reference writes every addressable shard), each
listed with its global index box; rank 0 commits once every rank has
written (:func:`save`).  ``restore(..., shardings=)`` puts each leaf onto
any placement on any mesh, each rank reading only the boxes that overlap
its shard: elastic restore.  A checkpoint written by either package, on
a mesh or not, restores in the other.  bfloat16
leaves are stored as raw 2-byte data (numpy has no bfloat16: ``repro``
writes them as ``|V2``) under the manifest dtype ``"bfloat16"`` and are
reinterpreted bit for bit on restore.

The leaf-granular readers (``leaf_entries``, ``read_leaf_slice``,
``copy_leaf_files``) address any box of any leaf through memory-mapped
shard files without assembling the tree: the streaming compression
pipeline (:mod:`repro_torch.compression.streaming`) is built on them.  They
speak numpy and need no JAX: a bfloat16 leaf reads back as raw 2-byte
``|V2`` data, whichever package wrote it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time

import numpy as np
import torch

from repro_torch.device import dtype_from_name, dtype_name, resolve_device
from repro_torch.distributed.sharding import dtensor_box, is_dtensor
from repro_torch.distributed.sharding import mesh_device

__all__ = [
    "save",
    "restore",
    "latest_step",
    "available_steps",
    "save_aux",
    "load_aux",
    "step_dir",
    "to_numpy",
    "from_numpy",
    "np_dtype",
    "leaf_entries",
    "read_leaf_slice",
    "copy_leaf_files",
    "HostShard",
    "host_shard",
    "new_commit_id",
]

_STEP_RE = re.compile(r"^step_(\d+)$")
#: seconds after which an uncommitted step directory counts as abandoned: a
#: rank stops waiting for the other ranks' shards or for the commit, and the
#: manager's garbage collection deletes it
STALE_TMP_S = 3600.0


def _safe(name: str) -> str:
    return name.replace("/", "__")


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; bfloat16 becomes raw 2-byte ``|V2`` data, as numpy
    stores JAX's bfloat16."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray, dtype_str: str, device) -> torch.Tensor:
    """Tensor of the named dtype from host data; 2-byte data of any numpy
    type is reinterpreted as bfloat16 when the name says so."""
    a = np.ascontiguousarray(a).reshape(np.shape(a))     # keeps a 0-d array 0-d
    if dtype_str == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored with itemsize {a.dtype.itemsize}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    want = np.dtype(dtype_str)
    if a.dtype != want:
        a = a.view(want) if a.dtype.itemsize == want.itemsize else a.astype(want)
    return torch.from_numpy(a.copy()).to(device)


def np_dtype(name: str) -> np.dtype:
    """The numpy dtype a leaf of manifest dtype ``name`` is held in on the
    host: raw ``|V2`` for bfloat16 (numpy has none without ``ml_dtypes``)."""
    return np.dtype("V2") if name == "bfloat16" else np.dtype(name)


def _leaf_paths(tree):
    from repro_torch.compression.plan import tree_paths

    return tree_paths(tree)


class HostShard:
    """A host copy of one rank's shard of a DTensor leaf: ``data`` and its
    global ``index`` box ([[start, stop], ...]) in a leaf of ``shape``."""

    def __init__(self, data: torch.Tensor, index: list, shape: tuple):
        self.data, self.index, self.shape = data, index, tuple(shape)
        self.dtype = data.dtype


def host_shard(leaf) -> HostShard:
    """This rank's shard of a DTensor as a :class:`HostShard`."""
    box = dtensor_box(leaf)
    return HostShard(leaf.to_local().detach().to("cpu", copy=True),
                     [[b.start, b.stop] for b in box], tuple(leaf.shape))


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def new_commit_id() -> str:
    """An id for one save that every rank agrees on (rank 0 draws it; a
    collective: every rank calls it)."""
    import torch.distributed as dist

    ids = [os.urandom(6).hex()]
    if _world()[1] > 1:
        dist.broadcast_object_list(ids, src=0)
    return ids[0]


def save(directory: str, step: int, tree, commit: str | None = None) -> str:
    """Write a checkpoint of a tree of tensors; returns its path.

    A tree of DTensors (or their :class:`HostShard` copies) on several
    ranks is saved by every rank: each writes its own shards, one file each
    (``<leaf>__shard<rank>_0.npy``) with its global index box, into a
    directory named by ``commit`` (one id per save, the same on every rank:
    :func:`new_commit_id`), and lists them in ``RANK<r>.json``.  Rank 0
    waits for every rank's list, writes the manifest and renames the
    directory: the step is committed only once every rank has written.
    The other ranks return once the committed manifest carries ``commit``.
    Only files pass between the ranks, so a save may run on a worker
    thread beside the training's collectives (the ranks share the
    directory's file system).  A plain leaf is written whole, by rank 0."""
    rank, world = _world()
    os.makedirs(directory, exist_ok=True)
    final = step_dir(directory, step)
    if world > 1 and commit is None:
        commit = new_commit_id()
    tmp = final + (f".{commit}.tmp" if world > 1 else ".tmp")
    if world == 1 and os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves = {}
    for name, leaf in _leaf_paths(tree):
        if not isinstance(leaf, HostShard) and is_dtensor(leaf):
            leaf = host_shard(leaf)
        entry = {"shape": list(leaf.shape), "dtype": dtype_name(leaf.dtype), "shards": []}
        if isinstance(leaf, HostShard):
            data, index, fname = leaf.data, leaf.index, f"{_safe(name)}__shard{rank}_0.npy"
        elif rank == 0:
            data, index = leaf, [[0, int(s)] for s in leaf.shape]
            fname = f"{_safe(name)}__shard0_0.npy"
        else:
            data = None
        if data is not None:
            np.save(os.path.join(tmp, fname), to_numpy(data))
            entry["shards"].append({"file": fname, "index": [list(map(int, b)) for b in index]})
        leaves[name] = entry
    manifest = {"step": step, "leaves": leaves}
    if world > 1:
        _write_json(os.path.join(tmp, f"RANK{rank}.json"), leaves)
        if rank != 0:
            _await(lambda: _committed(final, commit), f"rank 0's commit of {final}")
            return final
        parts = [os.path.join(tmp, f"RANK{r}.json") for r in range(world)]
        _await(lambda: all(os.path.exists(p) for p in parts), f"every rank's shards of {final}")
        for p in parts[1:]:
            with open(p) as f:
                for name, entry in json.load(f).items():
                    leaves[name]["shards"].extend(entry["shards"])
        for p in parts:
            os.remove(p)
        manifest["commit"] = commit
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _write_json(path: str, obj) -> None:
    with open(path + ".part", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".part", path)


def _committed(final: str, commit: str) -> bool:
    try:
        with open(os.path.join(final, "MANIFEST.json")) as f:
            return json.load(f).get("commit") == commit
    except (OSError, ValueError):
        return False


def _await(ready, what: str) -> None:
    deadline = time.monotonic() + STALE_TMP_S
    while not ready():
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint: gave up waiting for {what}")
        time.sleep(0.01)


def save_aux(directory: str, name: str, obj: dict) -> str:
    """Atomically write an auxiliary JSON document next to the steps."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, name)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(tmp, final)
    return final


def load_aux(directory: str, name: str):
    path = os.path.join(directory, name)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def leaf_entries(directory: str, step: int) -> dict:
    """The step manifest's ``leaves`` table: name -> {shape, dtype, shards}.
    Metadata only: no tensor data is read."""
    with open(os.path.join(step_dir(directory, step), "MANIFEST.json")) as f:
        return json.load(f)["leaves"]


def _view_dtype(data: np.ndarray, want: np.dtype) -> np.ndarray:
    if data.dtype == want:
        return data
    # bfloat16 written by JAX (ml_dtypes) or the port (|V2): the same bytes
    if data.dtype.itemsize == want.itemsize:
        return data.view(want)
    return data.astype(want)


def read_leaf_slice(directory: str, step: int, name: str, index: tuple,
                    entry: dict | None = None) -> np.ndarray:
    """``leaf[index]`` (a tuple of slices, one per dim) assembled from the
    shard files through mmap: host memory is bounded by the box, not the
    leaf.  bfloat16 comes back as raw ``|V2`` data (:func:`np_dtype`).
    ``entry`` spares the manifest read when the caller holds it."""
    if entry is None:
        entry = leaf_entries(directory, step)[name]
    want = np_dtype(entry["dtype"])
    box = [
        (0 if s.start is None else s.start, dim if s.stop is None else min(s.stop, dim))
        for s, dim in zip(index, entry["shape"])
    ]
    out = np.empty([hi - lo for lo, hi in box], dtype=want)
    path = step_dir(directory, step)
    for sh in entry["shards"]:
        ov = [(max(lo, a), min(hi, b)) for (lo, hi), (a, b) in zip(box, sh["index"])]
        if any(lo >= hi for lo, hi in ov):
            continue
        data = np.load(os.path.join(path, sh["file"]), mmap_mode="r")
        src = tuple(slice(lo - a, hi - a) for (lo, hi), (a, _) in zip(ov, sh["index"]))
        dst = tuple(slice(lo - blo, hi - blo) for (lo, hi), (blo, _) in zip(ov, box))
        out[dst] = _view_dtype(np.asarray(data[src]), want)
        del data
    return out


def copy_leaf_files(directory: str, step: int, name: str, dst_dir: str, dst_name: str,
                    entry: dict | None = None) -> dict:
    """File-level copy of one leaf's shards into ``dst_dir`` under a new
    leaf name; returns the rewritten manifest entry.  No tensor is loaded."""
    if entry is None:
        entry = leaf_entries(directory, step)[name]
    src_dir = step_dir(directory, step)
    prefix = _safe(name)
    out = {"shape": entry["shape"], "dtype": entry["dtype"], "shards": []}
    for sh in entry["shards"]:
        suffix = sh["file"][len(prefix):] if sh["file"].startswith(prefix) else "__" + sh["file"]
        fname = _safe(dst_name) + suffix
        shutil.copyfile(os.path.join(src_dir, sh["file"]), os.path.join(dst_dir, fname))
        out["shards"].append({"file": fname, "index": sh["index"]})
    return out


def available_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(directory, d, "MANIFEST.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(directory: str) -> int | None:
    steps = available_steps(directory)
    return steps[-1] if steps else None


def _unflatten(pairs):
    out: dict = {}
    for path, v in pairs:
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def restore(directory: str, step: int, like_tree, device=None, shardings=None):
    """Restore into the structure of ``like_tree`` (nested dicts, NamedTuples
    and sequences of tensors or ``meta`` tensors giving shape and dtype), on
    ``device`` (default: the GPU).  Shard files are reassembled by their
    global offsets, so a checkpoint written sharded restores whole.

    ``shardings`` (a matching tree of ``NamedSharding``; or a DTensor leaf
    in ``like_tree``) puts a leaf onto any placement on a mesh, whatever
    mesh wrote it: each rank reads, through mmap, only the boxes of the
    shard files that overlap its own shard, onto its device on the mesh."""
    path = step_dir(directory, step)
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    targets = dict(_leaf_paths(shardings)) if shardings is not None else {}
    pairs = []
    for name, leaf in _leaf_paths(like_tree):
        entry = manifest["leaves"][name]
        if tuple(entry["shape"]) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint/template shape mismatch at {name!r}: "
                f"{tuple(entry['shape'])} vs {tuple(leaf.shape)}"
            )
        if dtype_from_name(entry["dtype"]) != leaf.dtype:
            raise ValueError(
                f"checkpoint/template dtype mismatch at {name!r}: "
                f"{entry['dtype']} vs {dtype_name(leaf.dtype)}"
            )
        target = targets.get(name)
        if target is not None or is_dtensor(leaf):
            mesh = target.mesh if target is not None else leaf.device_mesh
            box = target.local_box(leaf.shape) if target is not None else dtensor_box(leaf)
            data = read_leaf_slice(directory, step, name, box, entry)
            local = from_numpy(data, entry["dtype"], mesh_device(mesh))
            if target is not None:
                pairs.append((name, target.from_local(local, leaf.shape)))
            else:
                from torch.distributed.tensor import DTensor

                pairs.append((name, DTensor.from_local(
                    local, mesh, leaf.placements, run_check=False, shape=leaf.shape,
                    stride=leaf.stride())))
            continue
        device = resolve_device(device)
        full = None
        for sh in entry["shards"]:
            data = from_numpy(np.load(os.path.join(path, sh["file"])), entry["dtype"], "cpu")
            if full is None:
                if [list(ix) for ix in sh["index"]] == [[0, s] for s in entry["shape"]]:
                    full = data
                    continue
                full = torch.empty(entry["shape"], dtype=data.dtype)
            full[tuple(slice(a, b) for a, b in sh["index"])] = data
        pairs.append((name, full.to(device)))
    from repro_torch.compression.plan import tree_rebuild

    return tree_rebuild(like_tree, dict(pairs))
