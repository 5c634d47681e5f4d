"""The schedules of the port's annealing kernels K1 and K2, on the CPU.

K2 (``csrc/sqa_sweep.cu``) runs the rows (sweep, slice) of a chain as a
wavefront at the skew ``sqa_sweep.wavefront_schedule`` gives it; here the
plain SQA step runs in that order and must give the plain version's bits on
non-dyadic data, and the skew is held against the dependencies it must keep.
Both kernels decide a step by a threshold on x_i g (``csrc/anneal_step.cuh``);
here the threshold, found by bisection over the floats' order-preserving
keys, must make the decisions of the plain formula.  K1's lanes per chain
follow ``sa_sweep.lanes_per_chain``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import sa_sweep as sa
from repro_torch.kernels import sqa_sweep as sqa

torch.set_num_threads(1)


def _normal_problems(rng, P, C, T, S, n):
    """Normal h and B, random replicas and uniforms: sums of these are
    rounded, so a changed order of additions changes bits."""
    h = rng.standard_normal((P, n)).astype(np.float32)
    B = np.triu(rng.standard_normal((P, n, n)), 1) * 0.3
    B = (B + np.swapaxes(B, 1, 2)).astype(np.float32)
    X0 = np.where(rng.random((P, C, T, n)) < 0.5, -1.0, 1.0).astype(np.float32)
    u = rng.random((P, C, S, T, n), dtype=np.float32)
    jp = np.geomspace(2.0, 1e-3, S).astype(np.float32)
    return [torch.from_numpy(a) for a in (h, B, X0, u, jp)]


def _wavefront_sqa(h, B, X0, rand, jperps, temperature):
    """The plain SQA step (ref.sqa_sweep_many_ref's arithmetic) with row
    r = s*T + q running spin i at step d*r + i: at each step every row in
    flight reads the state, then all of them write."""
    P, C, T, n = X0.shape
    S = jperps.shape[0]
    G, d = sqa.wavefront_schedule(T, n)
    X = X0.clone()
    tt = torch.tensor(float(T))
    temp = torch.tensor(temperature).clamp_min(1e-12)
    F = h[:, None, None, :] + 2.0 * torch.einsum("pij,pctj->pcti", B, X)
    R = S * T
    for step in range(d * (R - 1) + n if R else 0):
        rows = [r for r in range(R) if 0 <= step - d * r < n]
        assert len({r % G for r in rows}) == len(rows) <= G, "two rows in flight on one group"
        moves = []
        for r in rows:
            s, q = divmod(r, T)
            i = step - d * r
            xi = X[:, :, q, i]
            dE = -2.0 * xi * (F[:, :, q, i] / tt
                              + jperps[s] * (X[:, :, (q + 1) % T, i] + X[:, :, (q - 1) % T, i]))
            accept = (dE < 0.0) | (rand[:, :, s, q, i] < torch.exp(-dE / temp))
            moves.append((q, i, xi, torch.where(accept, -2.0 * xi, torch.zeros_like(xi))))
        for q, i, xi, delta in moves:
            F[:, :, q, :] += (2.0 * B[:, i, :])[:, None, :] * delta[:, :, None]
            X[:, :, q, i] = xi + delta
    E = (X * h[:, None, None, :]).sum(-1) + (X * torch.einsum("pij,pctj->pcti", B, X)).sum(-1)
    return X, E


@pytest.mark.parametrize("n", [5, 24, 33])
@pytest.mark.parametrize("T", [1, 2, 3, 8])
def test_wavefront_order_gives_the_plain_versions_bits(T, n):
    args = _normal_problems(np.random.default_rng(T * 100 + n), 2, 3, T, 3, n)
    Xw, Ew = _wavefront_sqa(*args, temperature=0.3)
    Xr, Er = ref.sqa_sweep_many_ref(*args, temperature=0.3)
    assert torch.equal(Xw, Xr)
    assert torch.equal(Ew, Er)
    assert 0.05 < float((Xw != args[2]).float().mean()) < 0.95   # the chains moved


def _times(d, R, n):
    """Step of (row, spin) under skew d; rows outside [0, R) never run."""
    return lambda r, i: d * r + i if 0 <= r < R else None


def _keeps_dependencies(T, n, G, d, S=3):
    """Whether skew d with G groups keeps what the sequential order gives
    every step of S sweeps: the previous pass over its slice wholly done
    (its last field update one step after its last spin), X[q-1, i] and
    X[q+1, i] written by the rows before and not yet by the rows after, and
    the rows in flight on distinct groups."""
    R = S * T
    t = _times(d, R, n)
    for r in range(R):
        if r >= T and t(r - T, n - 1) + 1 > t(r, 0):
            return False
        if t(r + G, 0) is not None and t(r, n - 1) + 1 > t(r + G, 0):
            return False                        # one group, two rows at once
        for i in range(n):
            if T >= 2:
                for before, after in ((r - 1, r - 1 + T), (r - T + 1, r + 1)):
                    if t(before, i) is not None and t(before, i) >= t(r, i):
                        return False
                    if t(after, i) is not None and t(after, i) <= t(r, i):
                        return False
            elif r >= 1 and t(r - 1, i) >= t(r, i):
                return False
    return True


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 13, 16])
def test_skew_keeps_the_dependencies_and_is_least(T):
    for n in (1, 2, 5, 7, 8, 24, 33, 40):
        for G in range(1, min(T, 8) + 1):
            d = sqa.wavefront_skew(T, n, G)
            assert _keeps_dependencies(T, n, G, d), (T, n, G, d)
            assert d == 1 or not _keeps_dependencies(T, n, G, d - 1), (T, n, G, d)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 8, 16, 64])
def test_wavefront_schedule_fits_the_kernel(T):
    for n in range(1, 257):
        G, d = sqa.wavefront_schedule(T, n)
        assert G == min(T, 8)              # the paper's T = 8: every slice in flight
        assert d == sqa.wavefront_skew(T, n, G)
    assert sqa.wavefront_schedule(8, 24) == (8, 3)


@pytest.mark.parametrize("P,C,n,lanes", [
    (10240, 4, 24, 8),     # the BBO pool's solve: the card is full
    (4096, 10, 24, 4),
    (4096, 10, 100, 16),   # 8 spins per lane at most
    (25, 10, 24, 32),      # the paper's BBO loop: few chains
    (4, 10, 24, 32),
    (512, 4, 40, 32),
    (8, 10, 100, 32),
    (1, 1, 256, 32),
])
def test_lanes_per_chain(P, C, n, lanes):
    assert sa.lanes_per_chain(P, C, n) == lanes


@pytest.mark.parametrize("P,C,direct", [
    (10240, 4, True),      # the BBO pool's solve: steps decide directly
    (4096, 1, True),
    (4095, 1, False),
    (25, 10, False),       # the paper's BBO loop: thresholds off the dependent path
    (4, 10, False),
    (512, 4, False),
])
def test_direct_acceptance(P, C, direct):
    assert sa.direct_acceptance(P, C) is direct


def test_lanes_per_chain_fits_the_kernel():
    for P in (1, 25, 409, 410, 4096, 10240):
        for C in (1, 2, 3, 4, 7, 10, 16):
            for n in (1, 8, 24, 33, 64, 65, 128, 200, 256):
                L = sa.lanes_per_chain(P, C, n)
                assert L in (4, 8, 16, 32) and -(-n // L) <= 8
                assert 32 // L <= C or L == 32          # a warp holds chains of one problem


def _key(v: torch.Tensor) -> torch.Tensor:
    b = v.view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b, -(b & 0x7FFFFFFF) - 1)


def _float(k: torch.Tensor) -> torch.Tensor:
    b = torch.where(k >= 0, k, (-(k + 1)) | 0x80000000)
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


def _accepts(v, u, t):
    w = 2.0 * v
    return (w > 0.0) | (u < torch.exp(w / t))


def _threshold(u, t):
    """Least float theta with accepts(v) <=> v >= theta, by bisection over
    every key from -inf to the least positive float."""
    lo = torch.full_like(u, -0x7F800000 - 2, dtype=torch.int64)   # below -inf: rejects
    hi = torch.ones_like(u, dtype=torch.int64)                     # 1.4e-45: accepts
    for _ in range(34):
        mid = lo + (hi - lo) // 2
        ok = _accepts(_float(mid.clamp_min(-0x7F800000 - 1)), u, t)
        hi, lo = torch.where(ok, mid, hi), torch.where(ok, lo, mid)
    return _float(hi.clamp_min(-0x7F800000 - 1))


@pytest.mark.parametrize("t", [1e-12, 0.05, 0.1, 1.0, 3e38])
def test_threshold_makes_the_plain_decisions(t):
    rng = np.random.default_rng(7)
    u = torch.from_numpy(np.concatenate([
        rng.random(2000, dtype=np.float32),
        np.float32([0.0, 1e-45, 1e-30, 0.5, 1 - 2 ** -24, 1 - 2 ** -20])]))
    tt = torch.tensor(t, dtype=torch.float32)
    theta = _threshold(u, tt)
    k = _key(theta)
    for dk in range(-3, 4):                        # every float around theta
        v = _float((k + dk).clamp(-0x7F800000 - 1, 0x7F800000))
        assert torch.equal(_accepts(v, u, tt), v >= theta)
    v = torch.from_numpy(rng.standard_normal(u.shape).astype(np.float32)) * 10 * t ** 0.5
    assert torch.equal(_accepts(v, u, tt), v >= theta)
    assert not bool(_accepts(torch.tensor(float("nan")), u, tt).any())   # NaN: both reject
