"""Whole runs of each kind of cell at a tiny size on the CPU: the result
line's schema, the forbidden-module check, and faults planted in the timed
path that the check must see."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

import tiny

SERVE = ("granite-moe.prefill-4k",)
COMPRESS = ("granite-moe.compress-alt",)


def test_result_line_schema(bench_run):
    out = tiny.tiny_run(bench_run, SERVE[0])
    json.dumps(out)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert out["correct"] is True and out["attempted"] > 0 and out["failed"] == 0
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_traced_run_reports_per_layer_metrics(bench_run):
    out = tiny.tiny_run(bench_run, SERVE[0], trace=True)
    want = {"prefill_ms", "decode_ms_per_step", "prefill_mfu", "idle_pct.serve"}
    assert want <= set(out["metrics"])
    assert "breakdown" in out and {"busy_s", "window_s"} <= set(out["device"])


@pytest.mark.parametrize("workload", COMPRESS)
def test_compression_cells_run_and_check(bench_run, workload):
    out = tiny.tiny_run(bench_run, workload, dtype="bfloat16")
    assert {"compress_mparams_per_s", "compress_rel_err", "setup_s"} <= set(out["metrics"])
    assert out["correct"] is True, out["checks"]
    # random tiles hold little low-rank structure: most of W stays in the residual
    assert 0.5 < out["metrics"]["compress_rel_err"]["value"] < 0.99


@pytest.mark.parametrize("workload", SERVE + COMPRESS)
def test_a_run_loads_nothing_of_jax(workload):
    """A run of each kind in a fresh process leaves no module whose
    top-level name is JAX's, jaxlib's, flax's or the JAX package's."""
    code = ("import sys, tiny; run = tiny.load_run(); "
            f"tiny.tiny_run(run, {workload!r}, dtype='bfloat16'); "
            "print(run.forbidden_modules())")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=f"{tiny.BENCH}/tests")
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("workload", SERVE)
def test_an_altered_token_is_caught(bench_run, monkeypatch, workload):
    from repro_torch.serving import engine

    pick = engine.Engine._pick

    def wrong(self, logits, generator):
        return (pick(self, logits, generator) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine.Engine, "_pick", wrong)
    out = tiny.tiny_run(bench_run, workload)
    assert out["correct"] is False


@pytest.mark.parametrize("workload", COMPRESS)
def test_an_altered_factor_is_caught(bench_run, monkeypatch, workload):
    from repro_torch.compression import execute

    solve = execute.compress_tile_batch

    def wrong(*a, **k):
        M, C, err = solve(*a, **k)
        return M, C * 1.01, err

    monkeypatch.setattr(execute, "compress_tile_batch", wrong)
    out = tiny.tiny_run(bench_run, workload, dtype="bfloat16")
    assert out["correct"] is False


@pytest.mark.parametrize("workload", COMPRESS)
def test_an_altered_sign_is_caught(bench_run, monkeypatch, workload):
    from repro_torch.compression import execute

    solve = execute.compress_tile_batch

    def wrong(*a, **k):
        M, C, err = solve(*a, **k)
        M = M.clone()
        M[::2, 0, 0] *= -1
        return M, C, err

    monkeypatch.setattr(execute, "compress_tile_batch", wrong)
    out = tiny.tiny_run(bench_run, workload, dtype="bfloat16")
    assert out["correct"] is False and out["checks"]["m_mismatch"]["value"] > 0.4


@pytest.mark.parametrize("workload", COMPRESS)
def test_half_the_tiles_left_out_is_caught(bench_run, monkeypatch, workload):
    """The solve runs on the first half of each batch of tiles and hands the
    second half the first half's answers."""
    import torch
    from repro_torch.compression import execute

    solve = execute.compress_tile_batch

    def half(tiles, signs, *a, **k):
        h = -(-tiles.shape[0] // 2)
        M, C, err = solve(tiles[:h], signs[:h], *a, **k)
        n = tiles.shape[0]
        return tuple(torch.cat([x, x])[:n] for x in (M, C, err))

    monkeypatch.setattr(execute, "compress_tile_batch", half)
    out = tiny.tiny_run(bench_run, workload, dtype="bfloat16")
    assert out["correct"] is False


@pytest.mark.parametrize("workload", SERVE)
def test_half_the_batch_left_out_is_caught(bench_run, monkeypatch, workload):
    """The engine decodes the first half of the batch and hands the second
    half the first half's tokens."""
    import torch
    from repro_torch.serving import engine

    generate = engine.Engine.generate

    def half(self, prompts, *a, **k):
        out = generate(self, prompts, *a, **k)
        h = -(-out.shape[0] // 2)
        P = prompts.shape[1]
        return torch.cat([prompts, torch.cat([out[:h, P:], out[:h, P:]])[:out.shape[0]]], 1)

    monkeypatch.setattr(engine.Engine, "generate", half)
    out = tiny.tiny_run(bench_run, workload)
    assert out["correct"] is False


def test_forbidden_modules_compare_whole_top_level_names(bench_run, monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert bench_run.forbidden_modules() == ["repro"]


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, f"{tiny.BENCH}/run.py", "--workload", SERVE[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
