"""BENCHMARK.json against the contract's shape, and every file it names
found by name."""

from __future__ import annotations

import json
import os
import re

import pytest

import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_units(bench):
    assert set(bench) == TOP
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("bench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and len(w["why"]) <= 200
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_finds_its_files_by_name(bench, bench_run):
    spec = bench_run.Spec()
    for w in bench["workloads"]:
        conf = spec.config(w["config"])
        assert conf["name"] == w["config"]
        traffic = bench_run.read_json(tiny.BENCH, "traffic", f"{w['traffic']}.json")
        kind = bench_run.load_file(os.path.join(tiny.BENCH, "kinds", f"{traffic['kind']}.py"), "k")
        assert hasattr(kind, "Cell")
        limits = bench_run.read_json(tiny.BENCH, "cells", f"{w['name']}.json")["limits"]
        assert limits and all(v > 0 for v in limits.values())
        e2e = spec.metrics(w["name"], False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics(w["name"], True)


def test_every_metric_has_a_reader(bench, bench_run):
    for m in bench["end_to_end"] + bench["per_layer"]:
        reader = bench_run.load_file(os.path.join(tiny.BENCH, "metrics", f"{m['name']}.py"), "r")
        assert callable(reader.read)


def test_each_configuration_states_what_the_program_runs(bench, bench_run):
    from benchlib import port

    spec = bench_run.Spec()
    for c in bench["configs"]:
        conf = spec.config(c["name"])
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        port.model_config(conf)          # raises where a size differs
