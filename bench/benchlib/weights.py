"""Weights made from the seed, on the device, in a few large draws.

The layout (each leaf's path, shape and dtype) is the program's parameter
tree, read on the ``meta`` device, so no value comes from the program.
Every value is drawn here: one draw of normals per dtype (the served dtype
for the dense, embedding and ``C`` leaves, float32 for the router), one of
bytes for all packed sign bits, one of uniforms for the SSM's decay and step
leaves.  Each leaf is then a view of
its draw, scaled as its dense initialisation would be.
"""

from __future__ import annotations

import collections
import math

import torch

# std of a normal truncated to +-2 sigma: a dense weight's fan-in init is
# this over sqrt(d_in)
TRUNC_STD = 0.8796


def generator(device, *parts: int) -> torch.Generator:
    """A generator seeded from whole numbers (any size) by a 63-bit mix."""
    h = 0x9E3779B97F4A7C15
    for p in parts:
        h = (h ^ (int(p) & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    g = torch.Generator(device=device)
    g.manual_seed(h & 0x7FFFFFFFFFFFFFFF)
    return g


def paths(tree, prefix: str = ""):
    """(path, leaf) of every tensor of a nested dict, in insertion order."""
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from paths(v, p)
        else:
            yield p, v


def put(tree: dict, path: str, value) -> None:
    *dirs, last = path.split("/")
    for k in dirs:
        tree = tree.setdefault(k, {})
    tree[last] = value


def _kind(path: str) -> str:
    name = path.rsplit("/", 1)[-1]
    if name == "scale" or name == "D":
        return "ones"
    if name == "conv_b":
        return "zeros"
    if name in ("A_log", "dt_bias"):
        return name
    return "normal"


def make(layout: dict, compressed: dict, seed: int, device) -> dict:
    """A values tree like ``layout`` (path -> (shape, dtype)) with the leaves
    in ``compressed`` (path -> (K, tile_n, tile_d)) as ``{"m_packed",
    "C"}`` pairs.  The same seed gives the same tree."""
    device = torch.device(device)
    g = generator(device, seed, 0x77)
    specs, normal, uniform, bits = [], {}, 0, 0
    for path, (shape, dtype) in layout.items():
        if path in compressed:
            K, tn, td = compressed[path]
            *lead, d_in, d_out = shape
            r, c, kb = d_in // tn, d_out // td, -(-K // 8)
            mp = (*lead, r, c, tn, kb)
            cs = (*lead, r, c, K, td)
            specs.append((path, "compressed", (mp, cs), dtype, (K, d_in)))
            bits += math.prod(mp)
            normal[dtype] = normal.get(dtype, 0) + math.prod(cs)
            continue
        kind = _kind(path)
        specs.append((path, kind, shape, dtype, None))
        if kind == "normal":
            normal[dtype] = normal.get(dtype, 0) + math.prod(shape)
        elif kind in ("A_log", "dt_bias"):
            uniform += math.prod(shape)
    # one draw per dtype: the served dtype (dense leaves, C, embeddings) and
    # float32 (the router)
    bufs = {dt: torch.randn(n, generator=g, device=device, dtype=dt) for dt, n in normal.items()}
    uni = torch.rand(uniform, generator=g, device=device)
    raw = torch.randint(0, 256, (bits,), generator=g, device=device, dtype=torch.uint8)
    at = collections.Counter()

    def take(buf, shape):
        n = math.prod(shape)
        v = buf[at[id(buf)]:at[id(buf)] + n].view(shape)
        at[id(buf)] += n
        return v

    out: dict = {}
    for path, kind, shape, dtype, extra in specs:
        if kind == "compressed":
            (mp, cs), (K, d_in) = shape, extra
            m = take(raw, mp)
            if K % 8:
                m[..., -1] &= (1 << (K % 8)) - 1
            C = take(bufs[dtype], cs).mul_(TRUNC_STD / math.sqrt(d_in * K))
            put(out, path, {"m_packed": m, "C": C})
        elif kind == "normal":
            put(out, path, take(bufs[dtype], shape).mul_(_scale(path, shape)))
        elif kind == "ones":
            put(out, path, torch.ones(shape, dtype=dtype, device=device))
        elif kind == "zeros":
            put(out, path, torch.zeros(shape, dtype=dtype, device=device))
        elif kind == "A_log":
            # decay rates A = -exp(A_log) uniform in [1, 16]
            put(out, path, torch.log1p(15.0 * take(uni, shape)))
        else:
            # steps dt log-uniform in [1e-3, 1e-1], stored as softplus^-1(dt)
            u = take(uni, shape)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
            put(out, path, dt + torch.log(-torch.expm1(-dt)))
    return out


def _scale(path: str, shape) -> float:
    name = path.rsplit("/", 1)[-1]
    if name == "table":
        return shape[-1] ** -0.5
    if name == "conv_w":
        return 0.1
    return TRUNC_STD / math.sqrt(shape[-2])
