"""Plain PyTorch versions of the port's kernels.

Each is the counterpart of an oracle in ``repro/kernels/ref.py`` and repeats
its kernel's arithmetic in the same order.  The kernel wrappers take these
for CPU tensors; the tests and ``chip_smoke.py`` hold the CUDA kernels
against them.
"""

from __future__ import annotations

import torch

__all__ = ["unpack_signs", "bitlinear_ref", "sa_sweep_many_ref", "sq_sweep_many_ref"]


def unpack_signs(m_packed: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """uint8 (..., kb) LSB-first bits -> {-1,+1} (..., K) in ``dtype``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=m_packed.device)
    bits = (m_packed.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*m_packed.shape[:-1], m_packed.shape[-1] * 8)[..., :K]
    return 2 * bits.to(dtype) - 1


def bitlinear_ref(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y = (x @ M) @ C, dense.  x (T, d_in), m_packed (r, c, tn, kb) uint8,
    C (r, c, K, td) -> (T, c*td) in x's dtype.

    As the kernel (and the Pallas kernel, ``repro/kernels/bitlinear.py``)
    does, z = x @ M accumulates in f32 and is rounded to C's dtype before
    z @ C, which accumulates in f32.  For f32 C this is exactly
    ``repro.kernels.ref.bitlinear_ref``."""
    n_r, n_c, tn, _ = m_packed.shape
    K, td = C.shape[2], C.shape[3]
    T = x.shape[0]
    M = unpack_signs(m_packed, K, torch.float32)
    xt = x.to(torch.float32).reshape(T, n_r, tn)
    z = torch.einsum("trn,rcnk->trck", xt, M)
    z = z.to(C.dtype).to(torch.float32)
    y = torch.einsum("trck,rckd->tcd", z, C.to(torch.float32))
    return y.reshape(T, n_c * td).to(x.dtype)


def sa_sweep_many_ref(h, B, x0, rand, temps):
    """Metropolis SA over P problems x C chains, sequential spin sweeps.

    h (P, n), B (P, n, n) symmetric zero-diagonal, x0 (P, C, n) +-1,
    rand (P, C, S, n) uniforms, temps (P, S) -> (x (P, C, n), e (P, C)).
    Every chain consumes its uniforms in (sweep, spin) order, exactly as
    ``repro.kernels.ref.sa_sweep_many_ref``; the chains of a batch advance
    in lock-step as tensor operations."""
    h = h.to(torch.float32)
    B = B.to(torch.float32)
    x = x0.to(torch.float32).clone()
    n = x.shape[-1]
    S = temps.shape[1]
    f = h[:, None, :] + 2.0 * torch.einsum("pij,pcj->pci", B, x)
    for s in range(S):
        t = torch.clamp_min(temps[:, s].to(torch.float32), 1e-12)[:, None]
        u = rand[:, :, s, :]
        for i in range(n):
            xi = x[:, :, i]
            dE = -2.0 * xi * f[:, :, i]
            accept = (dE < 0.0) | (u[:, :, i] < torch.exp(-dE / t))
            delta = torch.where(accept, -2.0 * xi, torch.zeros_like(xi))
            f = f + (2.0 * B[:, i, :])[:, None, :] * delta[:, :, None]
            x[:, :, i] = xi + delta
    e = (x * h[:, None, :]).sum(-1) + (x * torch.einsum("pij,pcj->pci", B, x)).sum(-1)
    return x, e


def sq_sweep_many_ref(h, B, x0, rand, temperature: float = 0.1):
    """Constant-temperature (simulated quench) path of the SA version."""
    P, _, S, _ = rand.shape
    temps = torch.full((P, S), temperature, dtype=torch.float32, device=rand.device)
    return sa_sweep_many_ref(h, B, x0, rand, temps)
