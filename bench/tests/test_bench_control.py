"""The controls at a tiny size: the reference in the lower precision put in
the program's place reads worse than the program on the same inputs.  On
the card at the cells' sizes ``bench/prove.py`` takes the readings the
limits are set from."""

from __future__ import annotations

import os

import pytest

import tiny


def cell(bench_run, workload: str, dtype: str):
    spec = bench_run.Spec()
    w = spec.workload(workload)
    traffic = dict(bench_run.read_json(tiny.BENCH, "traffic", f"{w['traffic']}.json"),
                   **(tiny.COMPRESS if "compress" in workload else tiny.SERVE))
    kind = bench_run.load_file(os.path.join(tiny.BENCH, "kinds", f"{traffic['kind']}.py"), "k")
    c = kind.Cell(spec.config(w["config"]), traffic, 2**31 + 11, "cpu",
                  dict(tiny.TINY[w["config"]], torch_dtype=dtype))
    c.setup()
    return c


@pytest.mark.parametrize("workload", ["granite-moe.prefill-4k"])
def test_fp8_control_is_off_the_best_where_the_program_is_not(bench_run, workload):
    c = cell(bench_run, workload, "float32")
    items = [c.run_item(i) for i in range(2)]
    c.free()
    got = c.check(items, control="fp8")
    assert got["program"]["served_gap"] < 1e-3
    assert got["control"]["served_gap"] > 10 * max(got["program"]["served_gap"], 1e-4)


@pytest.mark.parametrize("workload", ["granite-moe.compress-alt"])
def test_bf16_control_costs_residual_the_program_does_not(bench_run, workload):
    c = cell(bench_run, workload, "bfloat16")
    items = [c.run_item(0)]
    got = c.check(items, control="bf16")
    assert got["program"]["c_excess"] < 1.5
    assert got["control"]["c_excess"] > 3 * got["program"]["c_excess"]
    assert got["program"]["m_mismatch"] == 0 and got["control"]["m_mismatch"] > 0.05
