"""Operations and bytes of the kernels and of a compression pass, from shapes.

This is the yardstick the roofline shares and the model FLOP utilisations
are measured against; a configuration's prefill is counted in
``work/<reference>.py`` from these pieces.  It counts what the equations need, not
what an implementation dispatches: each input byte read once, each output
byte written once, two operations per multiply-add, causal attention over
the pairs a query can see.  It imports nothing of the program.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(ops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time of a piece of work: operations over the peak rate or
    bytes over the memory rate, whichever is larger."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def compressed_ops(T: int, d_in: int, d_out: int, tn: int, K: int, td: int) -> int:
    """y = (x @ M) @ C over T rows: per tile 2 T (tn K + K td)."""
    tiles = (d_in // tn) * (d_out // td)
    return 2 * T * tiles * (tn * K + K * td)


def k3(T: int, n_r: int, n_c: int, tn: int, K: int, td: int, x_bytes: int, c_bytes: int,
       y_bytes: int) -> tuple:
    """(operations, bytes) of one K3 call: x (T, n_r tn), packed signs, C,
    y (T, n_c td)."""
    ops = compressed_ops(T, n_r * tn, n_c * td, tn, K, td)
    nbytes = (T * n_r * tn * x_bytes + n_r * n_c * tn * (-(-K // 8))
              + n_r * n_c * K * td * c_bytes + T * n_c * td * y_bytes)
    return ops, nbytes


def k4(E: int, T: int, n_r: int, n_c: int, tn: int, K: int, td: int, x_bytes: int,
       c_bytes: int, y_bytes: int) -> tuple:
    """(operations, bytes) of one K4 call: E experts of T rows each."""
    ops, nbytes = k3(T, n_r, n_c, tn, K, td, x_bytes, c_bytes, y_bytes)
    return E * ops, E * nbytes


def causal_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of a causal sequence of S, within the window."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def k5(B: int, H: int, KV: int, S: int, hd: int, window: int, itemsize: int) -> tuple:
    """(operations, bytes) of one causal attention call: q.k and p.v over
    the pairs; q, k, v read and o written once."""
    ops = 4 * B * H * hd * causal_pairs(S, window)
    nbytes = (2 * B * H * S * hd + 2 * B * KV * S * hd) * itemsize
    return ops, nbytes


def k1(P: int, C: int, S: int, n: int) -> tuple:
    """(operations, bytes) of one annealing call of P problems of n spins,
    C chains, S sweeps: per spin step a field update (n multiply-adds) and
    the acceptance (~6 operations); per chain the first field and the last
    energy (2 n^2 multiply-adds each).  Bytes: h, B, x0, the uniforms, and x
    and the energies written, all float32."""
    ops = P * C * (S * n * (2 * n + 6) + 4 * 2 * n * n)
    nbytes = 4 * (P * n + P * n * n + P * C * n + P * C * S * n + P * C * n + P * C)
    return ops, nbytes


def role(path: str) -> str:
    """A compressed tensor's role from its path in the parameter tree:
    ``groups/0/attn/wq/w`` -> ``attn/wq``, ``groups/0/moe/up`` -> ``moe/up``."""
    parts = [p for p in path.split("/") if p != "w"]
    if parts[0] in ("groups", "rem"):
        parts = parts[2:]
    return "/".join(parts)


# the compression algorithms' stated constants (the paper's method as the
# configuration runs it): greedy restarts and power iterations per rank-one
# step, alternating sweeps, and for BBO its anneal's reads and sweeps
GREEDY_RESTARTS, GREEDY_ITERS, ALTERNATING_ITERS = 4, 16, 25
BBO_READS, BBO_SWEEPS = 4, 24


def alternating_tile_ops(tn: int, K: int, td: int) -> int:
    """One tile's greedy start and alternating descent: per power iteration
    c = m^T R and m = sign(R c) (4 tn td); per alternating sweep M^T W,
    C W^T (4 tn K td), C C^T and M^T M (2 K^2 (td + tn)) and the 2^K sign
    patterns' scores (2 2^K K tn); then the last least squares."""
    greedy = K * GREEDY_RESTARTS * GREEDY_ITERS * 4 * tn * td
    sweep = 4 * tn * K * td + 2 * K * K * (td + tn) + 2 * (2 ** K) * K * tn
    return greedy + ALTERNATING_ITERS * sweep + 2 * tn * K * td


def bbo_tile_ops(tn: int, K: int, td: int, iters: int) -> int:
    """One tile's BBO refinement on top of its alternating start: per
    iteration the normal-prior surrogate's Cholesky of its p x p precision
    (2 p^3 / 3), three triangular solves and the new point's rank-one
    update (8 p^2), the anneal (``k1``) and the true cost of the proposal
    (2 tn K td)."""
    n = tn * K
    p = 1 + n + n * (n - 1) // 2
    anneal, _ = k1(1, BBO_READS, BBO_SWEEPS, n)
    per_iter = 2 * p ** 3 // 3 + 8 * p * p + anneal + 2 * tn * K * td
    return alternating_tile_ops(tn, K, td) + iters * per_iter


def compress_pass_ops(tensors: list) -> int:
    """Operations of a compression pass: ``tensors`` lists (tiles, tn, K,
    td, method, bbo_iters) per compressed tensor."""
    total = 0
    for tiles, tn, K, td, method, iters in tensors:
        one = bbo_tile_ops(tn, K, td, iters) if method == "bbo" \
            else alternating_tile_ops(tn, K, td)
        total += tiles * one
    return total
