"""A tiny configuration of the model and one run of a cell at that size,
for the benchmark's own tests."""

from __future__ import annotations

import importlib.util
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, os.path.join(ROOT, "src")]

TINY = {
    "granite-moe": {"num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
                    "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 64,
                    "num_local_experts": 4, "num_experts_per_tok": 2, "vocab_size": 257},
}
TINY_POLICY = {"min_size": 1024, "tile_n": 16, "tile_d": 32}
SERVE = {"batch": 2, "prompt": 48, "generate": 4, "check": 4, "check_block": 2,
         "policy": TINY_POLICY}
COMPRESS = {"check": 64, "policy": TINY_POLICY}


def load_run():
    spec = importlib.util.spec_from_file_location("bench_run", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def tiny_run(bench_run, workload: str, dtype: str = "float32", seed: int = 2**31 + 7,
             trace: bool = False, device: str = "cpu"):
    """One run of ``workload`` at a tiny size, on the CPU unless told."""
    conf = workload.split(".")[0]
    traffic = COMPRESS if "compress" in workload else SERVE
    return bench_run.run_cell(bench_run.Spec(), workload, seed, 0.2, trace, device,
                              overrides=dict(TINY[conf], torch_dtype=dtype),
                              traffic_overrides=traffic)
