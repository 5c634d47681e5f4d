"""Device resolution for the port's entry points and dtype names shared
with the JAX package's on-disk formats."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "dtype_name", "dtype_from_name", "generator"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU: entry points never fall back to the CPU on
    their own.  Only an explicit ``device="cpu"`` runs there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


_NAMES = {
    torch.float32: "float32",
    torch.bfloat16: "bfloat16",
    torch.float16: "float16",
    torch.float64: "float64",
    torch.uint8: "uint8",
    torch.int8: "int8",
    torch.int16: "int16",
    torch.int32: "int32",
    torch.int64: "int64",
    torch.bool: "bool",
}
_DTYPES = {v: k for k, v in _NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """numpy-style name (``"bfloat16"``, ``"uint8"``): what ``str(dtype)``
    gives in the JAX package, so plans and manifests agree byte for byte."""
    return _NAMES[dtype]


def dtype_from_name(name: str) -> torch.dtype:
    return _DTYPES[name]


def _mix(*parts: int) -> int:
    """Deterministic 63-bit hash of integers (splitmix64 chain)."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        z &= 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        z ^= z >> 31
    return z & 0x7FFFFFFFFFFFFFFF


class _MetaGenerator(torch.Generator):
    """A host generator that reports the ``meta`` device: draws onto
    ``meta`` tensors only record shapes, so ``init_model(cfg,
    device="meta")`` gives a metadata-only template (the counterpart of
    ``jax.eval_shape``) without allocating a weight."""

    @property
    def device(self):
        return torch.device("meta")


def generator(device, *parts: int) -> torch.Generator:
    """A generator on ``device`` seeded from a tuple of integers, e.g.
    ``(seed, leaf_index, group)``: the port's stand-in for ``fold_in``."""
    device = torch.device(device)
    g = _MetaGenerator("cpu") if device.type == "meta" else torch.Generator(device=device)
    g.manual_seed(_mix(*parts))
    return g
