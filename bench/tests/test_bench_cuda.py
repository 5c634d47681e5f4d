"""On the card: each cell at a tiny size through the program's kernels (K3,
K4, K5 and the compression's batched solves), checked by the reference.
Skips without a CUDA device."""

from __future__ import annotations

import pytest

import tiny

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["granite-moe.prefill-4k"])
def test_serving_cells_on_the_card(bench_run, card, workload):
    out = tiny.tiny_run(bench_run, workload, dtype="float32", device="cuda")
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"


def test_compression_cell_on_the_card(bench_run, card):
    out = tiny.tiny_run(bench_run, "granite-moe.compress-alt", dtype="bfloat16", device="cuda")
    assert out["correct"] is True, out["checks"]


def test_traced_run_on_the_card_attributes_kernel_time(bench_run, card):
    out = tiny.tiny_run(bench_run, "granite-moe.prefill-4k", dtype="bfloat16", trace=True,
                        device="cuda")
    assert out["device"]["busy_s"] > 0
    for name in ("k3_roofline.prefill", "k4_roofline.prefill", "k5_roofline.prefill"):
        assert 0 < out["metrics"][name]["value"] <= 105, name
