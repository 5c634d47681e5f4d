"""Carry weights between the JAX package and the port.

Both sides speak the checkpointer's flat form: numpy arrays keyed by
"/"-joined tree paths (what ``repro``'s ``compression.plan.tree_paths``
gives for a JAX values tree, or the leaves of a compressed artifact).
``to_torch`` builds the port's nested dict of tensors on a device;
``to_numpy`` flattens it back.  bfloat16 travels as ml_dtypes' bfloat16
(JAX's numpy type) or as raw 2-byte data, bit for bit.  ``state_to_torch``
carries a surrogate state (``SuffStats``, ``HorseshoeState`` or
``FMState``) across, field by field; ``train_state_to_torch`` a training
state (step, params and the optimiser's moments).  With a mesh, leaves
become DTensors under the port's own placements (``shardings=`` for
``to_torch``; ``mesh=`` with the configs for ``train_state_to_torch``,
which then places by ``training.state_shardings``): each rank moves only
its shard to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import from_numpy
from repro_torch.compression.plan import tree_paths
from repro_torch.core import surrogate
from repro_torch.device import dtype_name, resolve_device

__all__ = ["to_torch", "to_numpy", "state_to_torch", "train_state_to_torch"]

_STATES = {cls.__name__: cls for cls in (
    surrogate.SuffStats, surrogate.HorseshoeState, surrogate.FMState,
)}


def _place(a: np.ndarray, dtype: str, device, sharding):
    if sharding is None:
        return from_numpy(a, dtype, device)
    from repro_torch.distributed.sharding import mesh_device

    return sharding.shard(from_numpy(a, dtype, "cpu"), mesh_device(sharding.mesh))


def to_torch(flat: dict, device=None, shardings=None) -> dict:
    """{path: numpy array} -> nested dict of tensors on ``device``
    (default: the GPU), or DTensors placed by ``shardings`` (a matching
    tree of ``NamedSharding``) on a mesh."""
    targets = dict(tree_paths(shardings)) if shardings is not None else {}
    device = None if shardings is not None else resolve_device(device)
    out: dict = {}
    for path, a in flat.items():
        a = np.asarray(a)
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        if a.dtype.kind == "V" and a.dtype.name != "bfloat16":
            raise ValueError(f"{path}: raw {a.dtype} data needs an explicit dtype")
        node[last] = _place(a, a.dtype.name, device, targets.get(path))
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


def state_to_torch(state, device=None):
    """A NamedTuple of numpy fields (a JAX state after ``np.asarray`` of each
    field) -> the port's NamedTuple of the same name, with its fields as
    tensors on ``device`` (default: the GPU)."""
    name = type(state).__name__
    cls = _STATES.get(name)
    if cls is None:
        raise TypeError(f"no port state named {name!r} ({', '.join(sorted(_STATES))})")
    device = resolve_device(device)
    return cls(**{f: torch.from_numpy(np.array(getattr(state, f))).to(device)
                  for f in cls._fields})


def train_state_to_torch(state, device=None, mesh=None, cfg=None, pcfg=None):
    """A JAX ``TrainState`` as numpy trees (e.g. ``jax.tree.map(np.asarray,
    state)``) -> the port's ``TrainState`` on ``device`` (default: the GPU):
    the step, the params and the optimiser state, adamw's ``{"m", "v"}``
    or adafactor's per-parameter ``{"v"}`` / ``{"vr", "vc"}``, each leaf
    bit for bit.  With ``mesh`` (and the ``cfg`` and ``pcfg`` it trains
    under), DTensors placed by the port's ``state_shardings``."""
    from repro_torch.training import TrainState, state_shardings

    sh = state_shardings(cfg, pcfg, mesh) if mesh is not None else None
    device = None if mesh is not None else resolve_device(device)

    def conv(tree, shard):
        if isinstance(tree, dict):
            return {k: conv(v, None if shard is None else shard[k]) for k, v in tree.items()}
        a = np.asarray(tree)
        return _place(a, a.dtype.name, device, shard)

    return TrainState(*(conv(getattr(state, f), None if sh is None else getattr(sh, f))
                        for f in TrainState._fields))
