"""Checkpoints in the JAX package's on-disk format.

Counterpart of the save/restore half of ``repro/checkpoint/checkpointer.py``:

    step_00000000.tmp/            # written first, renamed at the end
      MANIFEST.json               # {"step", "leaves": {path: {shape, dtype, shards}}}
      <leafpath>__shard0_0.npy    # one .npy per shard per leaf
    step_00000000/                # rename(tmp) == commit

A checkpoint written by either package restores in the other.  bfloat16
leaves are stored as raw 2-byte data (numpy has no bfloat16: ``repro``
writes them as ``|V2``) under the manifest dtype ``"bfloat16"`` and are
reinterpreted bit for bit on restore.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch

from repro_torch.device import dtype_from_name, dtype_name, resolve_device

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
]

_STEP_RE = re.compile(r"^step_(\d+)$")


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
    a = np.ascontiguousarray(a)
    if dtype_str == "bfloat16":
        if a.dtype.itemsize != 2:
            raise ValueError(f"bfloat16 leaf stored with itemsize {a.dtype.itemsize}")
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    want = np.dtype(dtype_str)
    if a.dtype != want:
        a = a.view(want) if a.dtype.itemsize == want.itemsize else a.astype(want)
    return torch.from_numpy(a.copy()).to(device)


def _leaf_paths(tree):
    from repro_torch.compression.plan import tree_paths

    return tree_paths(tree)


def save(directory: str, step: int, tree) -> str:
    """Write a checkpoint of a nested dict of tensors; returns its path."""
    os.makedirs(directory, exist_ok=True)
    final = step_dir(directory, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}}
    for name, leaf in _leaf_paths(tree):
        fname = f"{_safe(name)}__shard0_0.npy"
        np.save(os.path.join(tmp, fname), to_numpy(leaf))
        manifest["leaves"][name] = {
            "shape": list(leaf.shape),
            "dtype": dtype_name(leaf.dtype),
            "shards": [{"file": fname, "index": [[0, int(s)] for s in leaf.shape]}],
        }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


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


def restore(directory: str, step: int, like_tree, device=None):
    """Restore into the structure of ``like_tree`` (tensors or ``meta``
    tensors giving shape and dtype), on ``device`` (default: the GPU).
    Shard files are reassembled by their global offsets, so a checkpoint
    written sharded restores whole."""
    device = resolve_device(device)
    path = step_dir(directory, step)
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
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
    return _unflatten(pairs)
