"""Parameter trees with logical sharding axes.

Counterpart of ``repro/models/params.py``: every parameter is a
:class:`Param` (value + logical axis names); ``split`` separates a tree of
them into (values, axes).  Trees are nested dicts, as in ``repro``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Param", "param", "dense_init", "split"]


class Param(NamedTuple):
    value: torch.Tensor
    axes: tuple  # logical axis names (len == value.ndim); None entries allowed


def param(value: torch.Tensor, axes: tuple) -> Param:
    if len(axes) != value.ndim:
        raise ValueError(f"axes {axes} do not match shape {tuple(value.shape)}")
    return Param(value, axes)


def dense_init(generator, shape, axes, dtype, scale: float | None = None) -> Param:
    """Truncated-normal (+-2 sigma) fan-in init, scale 1/sqrt(fan_in) by
    default; drawn in float32 on the generator's device, then cast."""
    if scale is None:
        scale = shape[0] ** -0.5
    v = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(v, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return param((v * scale).to(dtype), axes)


def _map(fn, tree):
    if isinstance(tree, Param):
        return fn(tree)
    return {k: _map(fn, v) for k, v in tree.items()}


def split(tree):
    """params-with-axes tree -> (values tree, axes tree)."""
    return _map(lambda p: p.value, tree), _map(lambda p: p.axes, tree)
