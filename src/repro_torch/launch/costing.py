"""Weight-compression byte costing.

The three pure byte functions of ``repro/launch/costing.py`` that
:mod:`repro_torch.compression.plan` uses to predict bytes before any solver
runs.  The rest of that module (roofline costing of compiled programs)
is not ported.
"""

from __future__ import annotations

__all__ = ["compressed_weight_bytes", "int8_weight_bytes", "dense_weight_bytes"]


def dense_weight_bytes(shape, itemsize: int) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * int(itemsize)


def compressed_weight_bytes(
    d_in: int, d_out: int, tile_n: int, tile_d: int, K: int,
    itemsize: int, groups: int = 1,
) -> int:
    """Stored bytes of the {"m_packed", "C"} form: per tile, M packs to
    tile_n * ceil(K/8) uint8 and C stays (K, tile_d) at the weight's dtype.
    Must agree with ``quantized.compressed_num_bytes`` on the result."""
    r, c = d_in // tile_n, d_out // tile_d
    m_bytes = r * c * tile_n * ((K + 7) // 8)
    c_bytes = r * c * K * tile_d * int(itemsize)
    return int(groups) * (m_bytes + c_bytes)


def int8_weight_bytes(
    d_in: int, d_out: int, tile_n: int, tile_d: int, groups: int = 1,
) -> int:
    """Stored bytes of the int8-baseline {"q", "scale"} form: per tile,
    tile_n * tile_d int8 values plus one float32 scale."""
    r, c = d_in // tile_n, d_out // tile_d
    return int(groups) * (r * c * tile_n * tile_d + r * c * 4)
