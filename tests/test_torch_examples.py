"""The port's four examples (``examples/torch_*.py``) end to end on the CPU,
each through its ``main(argv)`` at its smallest arguments."""

import importlib.util
import os
import re
import tempfile

import pytest
import torch

from repro_torch.kernels import ops as tops

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _no_port_hooks():
    yield
    tops.disable_kernels()


def _number(pattern, text):
    m = re.search(pattern, text)
    assert m, f"{pattern!r} not in the output"
    return float(m.group(1))


def test_quickstart_bbo_no_worse_than_greedy(capsys):
    """A smaller BBO budget than the paper's (the plain annealer on the
    CPU); BBO must still end no worse than greedy, and M round-trip."""
    rc = _example("torch_quickstart").main(["--device", "cpu", "--iters", "576",
                                            "--num-sweeps", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    greedy = _number(r"greedy\s+cost\s+=\s+([0-9.]+)", out)
    bbo = _number(r"nBOCS/SA cost\s+=\s+([0-9.]+)", out)
    assert bbo <= greedy
    assert abs(_number(r"\|\|W - MC\|\|\^2 = ([0-9.]+)", out) - bbo) < 1e-5
    assert "whole-model plan" in out and "-> done." in out


def test_compress_then_serve(capsys):
    rc = _example("torch_compress_then_serve").main(["--device", "cpu", "--train-steps", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "manifest round trip" in out and "greedy-token agreement" in out
    assert "'methods': ['alternating']" in out


def test_delta_recompress(capsys):
    rc = _example("torch_delta_recompress").main(["--device", "cpu", "--train-steps", "2",
                                                  "--every", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "step 1: cold recompression" in out and "step 2: delta recompression" in out
    assert "fused vs einsum greedy tokens identical" in out


def test_delta_recompress_refuses_a_run_without_a_delta():
    with pytest.raises(SystemExit, match="need train-steps >= 2"):
        _example("torch_delta_recompress").main(["--device", "cpu", "--train-steps", "1",
                                                 "--every", "1"])


def test_train_small_trains_then_resumes(tmp_path, capsys):
    mod = _example("torch_train_small")
    argv = ["--device", "cpu", "--d-model", "64", "--layers", "1", "--seq-len", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path)]
    assert mod.main(argv + ["--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "model: " in out and "over 2 steps" in out
    assert mod.main(argv + ["--steps", "3"]) == 0       # resumes from step 2's checkpoint
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "over 3 steps" in out


def test_train_small_checkpoints_under_the_temp_dir_by_default(tmp_path, monkeypatch):
    """Without --ckpt-dir the checkpoints go to a directory of the port's
    own under the process's temp dir (TMPDIR), not to a fixed path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    argv = ["--device", "cpu", "--d-model", "64", "--layers", "1", "--seq-len", "16",
            "--batch", "2", "--steps", "1"]
    assert _example("torch_train_small").main(argv) == 0
    assert os.listdir(tmp_path / "repro_torch_train_small")
