"""Plain PyTorch versions of the port's kernels.

Each is the counterpart of an oracle in ``repro/kernels/ref.py`` and repeats
its kernel's arithmetic in the same order.  The kernel wrappers take these
for CPU tensors; the tests and ``chip_smoke.py`` hold the CUDA kernels
against them.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "unpack_signs",
    "bitlinear_ref",
    "bitlinear_grouped_ref",
    "flash_attention_ref",
    "sa_sweep_ref",
    "sa_sweep_many_ref",
    "sq_sweep_many_ref",
    "sqa_sweep_ref",
    "sqa_sweep_many_ref",
]


def unpack_signs(m_packed: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """uint8 (..., kb) LSB-first bits -> {-1,+1} (..., K) in ``dtype``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=m_packed.device)
    bits = (m_packed.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*m_packed.shape[:-1], m_packed.shape[-1] * 8)[..., :K]
    return 2 * bits.to(dtype) - 1


def _z_tiles(xt: torch.Tensor, m_packed: torch.Tensor, K: int, math: str, spec: str) -> torch.Tensor:
    """z = x @ M per (row tile, column tile) through the requested bit
    algebra: ``unpack`` contracts x with the {-1,+1} signs; ``bitplane``
    forms z = 2 (x @ B) - s with B the raw {0,1} bits and s x's row sum per
    r tile.  xt is f32 (float activations) or int32 (int8 activations,
    where every z is exact); ``spec`` is the einsum of x with the bits."""
    acc = xt.dtype
    if math == "bitplane":
        bits = (unpack_signs(m_packed, K, torch.int32) + 1) // 2
        zb = _contract(spec, xt, bits.to(acc))
        s = xt.sum(-1)
        return 2 * zb - s[..., None, None]
    return _contract(spec, xt, unpack_signs(m_packed, K, torch.int32).to(acc))


def _contract(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum, also for int32 operands (where CUDA's einsum has no kernel:
    the exact int32 products are summed in float64, exact below 2^53)."""
    if a.dtype == torch.int32:
        return torch.einsum(spec, a.double(), b.double()).to(torch.int32)
    return torch.einsum(spec, a, b)


def _finish(y: torch.Tensor, dtype) -> torch.Tensor:
    """The f32 accumulator in the output dtype: floats round to nearest;
    int8 is truncated toward zero and saturated to [-128, 127], as the
    Pallas kernels' f32 -> int8 cast does (a plain ``.to(int8)`` leaves
    out-of-range values undefined)."""
    if dtype == torch.int8:
        return torch.trunc(y.clamp(-128.0, 127.0)).to(torch.int8)
    return y.to(dtype)


def bitlinear_ref(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor,
                  math: str = "unpack") -> torch.Tensor:
    """y = (x @ M) @ C, dense.  x (T, d_in) f32, bf16 or int8, m_packed (r, c,
    tn, kb) uint8, C (r, c, K, td) -> (T, c*td) in x's dtype.

    As the kernels (and the Pallas kernels, ``repro/kernels/bitlinear.py``)
    do, z = x @ M accumulates in f32 (exactly in int32 for int8 x) through
    the bit algebra ``math`` ("unpack" or "bitplane"; "dot" is unpack) and
    is rounded to C's dtype before z @ C, which accumulates in f32.  For
    f32 C and x this is exactly ``repro.kernels.ref.bitlinear_ref``."""
    n_r, n_c, tn, _ = m_packed.shape
    K, td = C.shape[2], C.shape[3]
    T = x.shape[0]
    acc = torch.int32 if x.dtype == torch.int8 else torch.float32
    xt = x.to(acc).reshape(T, n_r, tn)
    z = _z_tiles(xt, m_packed, K, math, "trn,rcnk->trck")
    z = z.to(C.dtype).to(torch.float32)
    y = torch.einsum("trck,rckd->tcd", z, C.to(torch.float32))
    return _finish(y.reshape(T, n_c * td), x.dtype)


def bitlinear_grouped_ref(x: torch.Tensor, m_packed: torch.Tensor, C: torch.Tensor,
                          math: str = "unpack") -> torch.Tensor:
    """y_e = (x_e @ M_e) @ C_e per expert, dense: the grouped form of
    ``bitlinear_ref`` (``repro.kernels.ref.bitlinear_grouped_ref``).
    x (E, T, d_in), m_packed (E, r, c, tn, kb), C (E, r, c, K, td) ->
    (E, T, c*td) in x's dtype; z and the output are rounded as in
    ``bitlinear_ref``."""
    E, n_r, n_c, tn, _ = m_packed.shape
    K, td = C.shape[3], C.shape[4]
    T = x.shape[1]
    acc = torch.int32 if x.dtype == torch.int8 else torch.float32
    xt = x.to(acc).reshape(E, T, n_r, tn)
    z = _z_tiles(xt, m_packed, K, math, "etrn,ercnk->etrck")
    z = z.to(C.dtype).to(torch.float32)
    y = torch.einsum("etrck,erckd->etcd", z, C.to(torch.float32))
    return _finish(y.reshape(E, T, n_c * td), x.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = 0) -> torch.Tensor:
    """Plain masked softmax attention, ``repro.kernels.ref.flash_attention_ref``.
    q (B, H, S, hd), k/v (B, KV, S, hd) -> (B, H, S, hd) in v's dtype.  The
    scores are formed in the inputs' dtype (rounded, as JAX's einsum does)
    and softmaxed in f32; p is rounded to v's dtype before p @ v."""
    B, H, S, hd = q.shape
    rep = H // k.shape[1]
    kr = k.repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr).to(torch.float32) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= (pos[:, None] - pos[None, :]) < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), vr)


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


def sa_sweep_ref(h, B, x0, rand, temps):
    """One problem of ``sa_sweep_many_ref``: h (n,), B (n, n), x0 (C, n),
    rand (C, S, n), temps (S,) -> (x (C, n), e (C,)), as
    ``repro.kernels.ref.sa_sweep_ref``."""
    x, e = sa_sweep_many_ref(h[None], B[None], x0[None], rand[None], temps[None])
    return x[0], e[0]


def sq_sweep_many_ref(h, B, x0, rand, temperature: float = 0.1):
    """Constant-temperature (simulated quench) path of the SA version."""
    P, _, S, _ = rand.shape
    temps = torch.full((P, S), temperature, dtype=torch.float32, device=rand.device)
    return sa_sweep_many_ref(h, B, x0, rand, temps)


def sqa_sweep_many_ref(h, B, X0, rand, jperps, temperature: float = 0.05):
    """Path-integral SQA over P problems x C chains x T Trotter replicas.

    h (P, n), B (P, n, n) symmetric zero-diagonal, X0 (P, C, T, n) +-1,
    rand (P, C, S, T, n) uniforms, jperps (S,) inter-replica couplings ->
    (X (P, C, T, n), E (P, C, T)).  Every chain visits (sweep, slice, spin)
    in order and consumes its uniforms as
    ``repro.kernels.ref.sqa_sweep_many_ref`` does:

        dE = (-2 x) (F[p, i] / T + jperp_s (X[p+1, i] + X[p-1, i]))

    with replica indices mod T and F[p] = h + 2 B X[p] kept incrementally.
    T and the temperature are device tensors, so CUDA divides by them
    (PyTorch multiplies by the reciprocal of a host scalar)."""
    h = h.to(torch.float32)
    B = B.to(torch.float32)
    X = X0.to(torch.float32).clone()
    T, n = X.shape[2], X.shape[3]
    jp = jperps.to(torch.float32)
    tt = torch.tensor(float(T), dtype=torch.float32, device=X.device)
    temp = torch.tensor(temperature, dtype=torch.float32, device=X.device).clamp_min(1e-12)
    F = h[:, None, None, :] + 2.0 * torch.einsum("pij,pctj->pcti", B, X)
    for s in range(jp.shape[0]):
        for p in range(T):
            up, dn = (p + 1) % T, (p - 1) % T
            u = rand[:, :, s, p, :]
            for i in range(n):
                xi = X[:, :, p, i]
                dE = -2.0 * xi * (F[:, :, p, i] / tt + jp[s] * (X[:, :, up, i] + X[:, :, dn, i]))
                accept = (dE < 0.0) | (u[:, :, i] < torch.exp(-dE / temp))
                delta = torch.where(accept, -2.0 * xi, torch.zeros_like(xi))
                F[:, :, p, :] += (2.0 * B[:, i, :])[:, None, :] * delta[:, :, None]
                X[:, :, p, i] = xi + delta
    E = (X * h[:, None, None, :]).sum(-1) + (X * torch.einsum("pij,pctj->pcti", B, X)).sum(-1)
    return X, E


def sqa_sweep_ref(h, B, X0, rand, jperps, temperature: float = 0.05):
    """One problem of ``sqa_sweep_many_ref``: h (n,), B (n, n), X0 (C, T, n),
    rand (C, S, T, n), jperps (S,) -> (X (C, T, n), E (C, T)), as
    ``repro.kernels.ref.sqa_sweep_ref``."""
    X, E = sqa_sweep_many_ref(h[None], B[None], X0[None], rand[None], jperps, temperature)
    return X[0], E[0]
