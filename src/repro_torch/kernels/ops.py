"""Kernel routing for the compressed layer.

Counterpart of ``repro/kernels/ops.py``.  ``enable_kernels()`` registers the
fused bitlinear hook into :mod:`repro_torch.core.quantized`, so every
``apply_compressed`` call runs ``kernels.bitlinear.bitlinear`` (the CUDA
kernel for CUDA tensors, its plain version for CPU ones).  Flash attention
and the schedule autotuner are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from repro_torch.core import quantized
from repro_torch.kernels.bitlinear import bitlinear

__all__ = ["enable_kernels", "disable_kernels", "apply_compressed_fused"]


def enable_kernels() -> None:
    """Route compressed layers through the fused bitlinear kernel.  The
    hook is process-global; ``disable_kernels()`` removes it."""
    quantized.register_bitlinear_fused(apply_compressed_fused)


def disable_kernels() -> None:
    quantized.clear_bitlinear()


def apply_compressed_fused(x, w):
    """y = (x @ M) @ C through the bitlinear kernel; x (..., d_in) ->
    (..., d_out) with any leading dims flattened into the kernel's T axis."""
    C = w["C"]
    if C.ndim != 4:
        raise NotImplementedError(
            "grouped compressed weights need kernel K4 (ROADMAP.md)"
        )
    n_c, td = C.shape[1], C.shape[3]
    lead = x.shape[:-1]
    y = bitlinear(x.reshape(-1, x.shape[-1]), w["m_packed"], C)
    return y.reshape(*lead, n_c * td)
