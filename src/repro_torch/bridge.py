"""Carry weights between the JAX package and the port.

Both sides speak the checkpointer's flat form: numpy arrays keyed by
"/"-joined tree paths (what ``repro``'s ``compression.plan.tree_paths``
gives for a JAX values tree, or the leaves of a compressed artifact).
``to_torch`` builds the port's nested dict of tensors on a device;
``to_numpy`` flattens it back.  bfloat16 travels as ml_dtypes' bfloat16
(JAX's numpy type) or as raw 2-byte data, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import from_numpy
from repro_torch.compression.plan import tree_paths
from repro_torch.device import dtype_name, resolve_device

__all__ = ["to_torch", "to_numpy"]


def to_torch(flat: dict, device=None) -> dict:
    """{path: numpy array} -> nested dict of tensors on ``device``
    (default: the GPU)."""
    device = resolve_device(device)
    out: dict = {}
    for path, a in flat.items():
        a = np.asarray(a)
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        if a.dtype.kind == "V" and a.dtype.name != "bfloat16":
            raise ValueError(f"{path}: raw {a.dtype} data needs an explicit dtype")
        node[last] = from_numpy(a, a.dtype.name, device)
    return out


def to_numpy(tree) -> dict:
    """Nested dict of tensors -> {path: numpy array}; bfloat16 leaves come
    back as ml_dtypes' bfloat16, the type JAX arrays convert to."""
    out = {}
    for path, t in tree_paths(tree):
        t = t.detach().cpu().contiguous()
        if dtype_name(t.dtype) == "bfloat16":
            import ml_dtypes

            out[path] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[path] = t.numpy()
    return out
