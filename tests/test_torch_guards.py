"""Guards of the port: it imports neither JAX nor the JAX package, and its
entry points run on the GPU unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.launch.compress import compress_model
from repro_torch.models import init_model
from repro_torch.models.params import split

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_FILES = sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + [_ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                roots.add(str(arg.value).split(".")[0])
            elif isinstance(arg, ast.JoinedStr) and isinstance(arg.values[0], ast.Constant):
                roots.add(str(arg.values[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _FILES, ids=lambda p: str(p.relative_to(_ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path} imports {sorted(bad)}"


def _cpu_only():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")


def test_entry_points_refuse_the_cpu_without_device(tmp_path):
    _cpu_only()
    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    policy = CompressionPolicy(tile_d=32, min_size=1024)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_model(cfg, policy, str(tmp_path))
    values, _ = split(init_model(cfg, seed=0, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute_plan(plan_compression(values, policy), values)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("flag", [["--streaming"], ["--delta-from", "x"], ["--budget-mb", "1"],
                                  ["--autotune-kernels"]])
def test_compress_cli_refuses_unported_flags(flag, capsys):
    from repro_torch.launch.compress import main

    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen3-32b", "--reduced", *flag])
    assert e.value.code == 2
    assert "not yet ported" in capsys.readouterr().err


def test_compress_cli_needs_cuda():
    _cpu_only()
    from repro_torch.launch.compress import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--plan-only"])
