"""The work counts against counts made by hand at small shapes."""

from __future__ import annotations

import tiny  # noqa: F401  (puts the benchmark on the path)
from work import counts, granite_moe


def test_compressed_product_counts_both_factors_per_tile():
    # 2 x 3 tiles of 4 x 8, K = 2, T = 5: per tile 2*5*(4*2 + 2*8) = 240
    assert counts.compressed_ops(5, 8, 24, 4, 2, 8) == 6 * 240


def test_k3_bytes_read_each_input_once():
    ops, nbytes = counts.k3(T=5, n_r=2, n_c=3, tn=4, K=2, td=8, x_bytes=2, c_bytes=2, y_bytes=2)
    assert ops == 6 * 240
    # x 5*8*2, signs 6 tiles * 4 rows * 1 byte, C 6*2*8*2, y 5*24*2
    assert nbytes == 80 + 24 + 192 + 240


def test_k4_is_e_times_k3():
    assert counts.k4(3, 5, 2, 3, 4, 2, 8, 2, 2, 2) == tuple(
        3 * v for v in counts.k3(5, 2, 3, 4, 2, 8, 2, 2, 2))


def test_causal_pairs_with_and_without_a_window():
    assert counts.causal_pairs(4) == 10
    assert counts.causal_pairs(5, window=2) == 3 + 3 * 2
    assert counts.causal_pairs(4, window=8) == 10


def test_k5_counts_the_visible_pairs():
    ops, nbytes = counts.k5(B=1, H=2, KV=1, S=3, hd=4, window=0, itemsize=2)
    assert ops == 4 * 2 * 4 * 6
    assert nbytes == (2 * 2 * 3 * 4 + 2 * 1 * 3 * 4) * 2


def test_k1_counts_field_updates_and_energies():
    ops, nbytes = counts.k1(P=1, C=1, S=1, n=2)
    assert ops == 1 * (2 * (2 * 2 + 6)) + 4 * 2 * 4
    assert nbytes == 4 * (2 + 4 + 2 + 2 + 2 + 1)


def test_bound_takes_the_slower_of_operations_and_bytes():
    assert counts.bound_s(counts.BF16_FLOPS, 0) == 1.0
    assert counts.bound_s(0, counts.HBM_BYTES_PER_S) == 1.0


def test_granite_prefill_sums_its_parts():
    sizes = {"hidden_size": 8, "vocab_size": 10, "num_attention_heads": 2,
             "num_key_value_heads": 1, "head_dim": 4, "num_hidden_layers": 1,
             "num_local_experts": 4, "num_experts_per_tok": 2, "intermediate_size": 8}
    tile = (4, 1, 4)
    geo = {r: tile for r in ("attn/wq", "attn/wk", "attn/wv", "attn/wo",
                             "moe/gate", "moe/up", "moe/down")}
    B, P = 1, 3
    c = counts.compressed_ops
    want = (c(3, 8, 8, *tile) + 2 * c(3, 8, 4, *tile) + c(3, 8, 8, *tile)
            + 4 * 1 * 2 * 4 * 6
            + 3 * c(6, 8, 8, *tile)
            + 2 * 3 * 8 * 4
            + 2 * 8 * 10)
    assert granite_moe.prefill_ops(sizes, geo, B, P) == want


def test_roles_from_paths():
    assert counts.role("groups/0/attn/wq/w") == "attn/wq"
    assert counts.role("groups/0/moe/up") == "moe/up"
    assert counts.role("rem/1/ssm/in_proj/w") == "ssm/in_proj"
