"""Guards of the port: it imports neither JAX nor the JAX package, and its
entry points run on the GPU unless the caller asks for the CPU."""

import ast
import dataclasses
import pathlib

import pytest
import torch

from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.launch.compress import compress_model
from repro_torch.models import init_model
from repro_torch.models.params import split

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_FILES = sorted((_ROOT / "src" / "repro_torch").rglob("*.py")) + [
    _ROOT / "chip_smoke.py", _ROOT / "tools" / "torch_serve_profile.py",
    _ROOT / "tools" / "torch_eigh_batch_probe.py", _ROOT / "tools" / "torch_moe_divergence.py",
    _ROOT / "tools" / "torch_grid_variants.py", _ROOT / "tools" / "torch_decode_variants.py",
    _ROOT / "tools" / "torch_decode_ab.py", _ROOT / "tools" / "torch_anneal_ab.py",
    _ROOT / "tools" / "torch_anneal_variants.py", _ROOT / "tools" / "torch_stream_ab.py",
    _ROOT / "tools" / "torch_stream_variants.py", _ROOT / "tools" / "torch_serve_ab.py",
    _ROOT / "tools" / "torch_k1_global_ab.py", _ROOT / "tools" / "torch_train_profile.py",
    _ROOT / "tools" / "torch_config_zoo_smoke.py"] + sorted((_ROOT / "examples").glob("torch_*.py"))


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


@pytest.mark.parametrize("flag", [["--streaming"], ["--delta-from", "x"]])
def test_compress_cli_refuses_unported_flags(flag, capsys):
    """``--streaming`` and ``--delta-from`` are ported: each gets past the
    flag checks and reaches the CUDA check (no flag is refused as unported)."""
    _cpu_only()
    from repro_torch.launch.compress import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", *flag])
    assert "not yet ported" not in capsys.readouterr().err


def test_compress_cli_autotune_kernels_needs_cuda(capsys):
    """``--autotune-kernels`` is ported: it gets past the "not yet ported"
    exit and reaches the CUDA check."""
    _cpu_only()
    from repro_torch.launch.compress import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--autotune-kernels"])
    assert "not yet ported" not in capsys.readouterr().err


def test_compress_cli_budget_mb_needs_cuda(capsys):
    """``--budget-mb`` is ported: it gets past the "not yet ported" exit and
    the flag checks and reaches the CUDA check."""
    _cpu_only()
    from repro_torch.launch.compress import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--budget-mb", "0.12", "--engine", "qubo",
              "--calibrate", "--objective", "eval-loss"])
    assert "not yet ported" not in capsys.readouterr().err


def test_autotune_and_eval_entry_points_refuse_the_cpu_without_device(tmp_path):
    """The budget autotuner, calibration and the eval harness run on the GPU
    unless asked for the CPU."""
    _cpu_only()
    from repro_torch.compression.autotune import (
        allocate_budget, autotune_plan, calibration_inputs, calibration_weights, probe_tensors,
    )
    from repro_torch.eval import EvalHarness

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    policy = CompressionPolicy(tile_d=32, min_size=1024)
    values, _ = split(init_model(cfg, seed=0, device="cpu"))
    plan = plan_compression(values, policy)
    for call in (
        lambda: autotune_plan(values, policy, 1 << 20),
        lambda: plan_compression(values, policy, budget_bytes=1 << 20),
        lambda: probe_tensors(values, plan),
        lambda: calibration_inputs(cfg),
        lambda: calibration_weights(values, cfg),
        lambda: EvalHarness(cfg),
        lambda: compress_model(cfg, policy, str(tmp_path), values=values, budget_bytes=1 << 20),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    probes = probe_tensors(values, plan, device="cpu", max_probe_tiles=2, k_fractions=(0.5,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        allocate_budget(probes, plan.total_bytes(), engine="qubo")
    assert not any(tmp_path.iterdir())


def test_delta_and_streaming_entry_points_refuse_the_cpu_without_device(tmp_path):
    """Delta recompression and the streaming tier run on the GPU unless asked
    for the CPU; a metadata-only source is refused by the execute first."""
    _cpu_only()
    from repro_torch.compression import (
        TreeLeafSource, delta_recompress, execute_streaming, run_compression_job,
        streaming_autotune_plan,
    )

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    policy = CompressionPolicy(tile_d=32, min_size=1024)
    values, _ = split(init_model(cfg, seed=0, device="cpu"))
    plan = plan_compression(values, policy)
    cvalues, artifact = execute_plan(plan, values, device="cpu")
    src = TreeLeafSource(values)
    out = tmp_path / "out"
    for call in (
        lambda: delta_recompress(artifact, cvalues, values),
        lambda: execute_streaming(src, plan, str(out)),
        lambda: run_compression_job(src, plan, str(out)),
        lambda: streaming_autotune_plan(src, policy, plan.total_bytes()),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    meta = TreeLeafSource(split(init_model(cfg, seed=0, device="meta"))[0])
    with pytest.raises(ValueError, match="metadata-only"):
        execute_streaming(meta, plan, str(out), device="cpu")
    assert not out.exists()


# the modules of the streaming and delta paths, which read bf16 checkpoints
# where no JAX (and so no ml_dtypes) is installed
_NO_ML_DTYPES = [f for f in _FILES if f.name != "bridge.py"]


@pytest.mark.parametrize("path", _NO_ML_DTYPES, ids=lambda p: str(p.relative_to(_ROOT)))
def test_port_imports_no_ml_dtypes(path):
    assert "ml_dtypes" not in _imported_roots(path), f"{path} imports ml_dtypes"


def test_k1_body_rule_is_the_headers():
    """kernels/sa_sweep.py's shared_body, max_spins and MAX_SPINS mirror
    csrc/anneal_step.cuh's sa_shared_body: its constants and its rule."""
    import re

    from repro_torch.kernels import sa_sweep as sa

    header = (_ROOT / "src" / "repro_torch" / "csrc" / "anneal_step.cuh").read_text()
    consts = dict(re.findall(r"^constexpr int (kSa\w+) = (\d+);$", header, re.M))
    assert {k: int(v) for k, v in consts.items()} == {
        "kSaSmemBytes": sa._SMEM_BYTES, "kSaMaxWarps": sa._MAX_WARPS,
        "kSaSharedMaxSpins": sa._SHARED_MAX_SPINS, "kSaGlobalMaxSpins": sa.MAX_SPINS,
        "kSaSplitWarps": sa._SPLIT_WARPS, "kSaSplitGroup": sa._SPLIT_GROUP,
        "kSaSmSmemBytes": sa._SM_SMEM_BYTES, "kSaBlockReservedBytes": sa._BLOCK_RESERVED,
        "kSaSplitTwoWaveSpins": sa._SPLIT_TWO_WAVES}
    rule = re.search(
        r"return n <= kSaSharedMaxSpins &&\s+4LL \* \(\(long long\)n \* n \+ \(long long\)"
        r"\(chains < kSaMaxWarps \? chains : kSaMaxWarps\) \* n\) <=\s+kSaSmemBytes;", header)
    assert rule, "sa_shared_body's rule not found in the header"
    # the mirror's boundary: 237 spins at 8 or more chains, 240 at one
    assert (sa.max_spins(8), sa.max_spins(64), sa.max_spins(1)) == (237, 237, 240)
    for C in (1, 7, 8, 9):
        assert sa.shared_body(sa.max_spins(C), C) and not sa.shared_body(sa.max_spins(C) + 1, C)


def test_k1_global_form_rule_is_the_headers():
    """kernels/sa_sweep.py's global_warps mirrors csrc/anneal_step.cuh's
    sa_global_warps: a chain split over ceil(n / (32 m)) warps, m =
    ceil(n / (32 kSaSplitWarps)) spins a lane, while the chains run in one
    wave of split blocks (as many an SM as their shared memory,
    sa_split_smem_bytes, allows), two from kSaSplitTwoWaveSpins spins on;
    else a warp a chain."""
    import re

    from repro_torch.kernels import sa_sweep as sa

    header = (_ROOT / "src" / "repro_torch" / "csrc" / "anneal_step.cuh").read_text()
    body = " ".join(header.split())
    for rule in (
        r"return n > 0 \? \(n \+ 32 \* kSaSplitWarps - 1\) / \(32 \* kSaSplitWarps\) : 1;",
        r"return \(n \+ 32 \* sa_split_spins\(n\) - 1\) / \(32 \* sa_split_spins\(n\)\);",
        r"sa_split_row_stride\(int n\) \{ return \(n \+ 6\) & ~3; \}",
        r"return 16LL \* \(\(n \+ 3\) & ~3\) \+ 2 \* 8 \* 8;",
        r"return g < 2 \? 2 : g > 8 \? 8 : \(int\)g;",
        r"return sa_split_clamp\(\(kSaSmemBytes - sa_split_fixed_bytes\(n\)\) / "
        r"\(4LL \* kSaSplitGroup \* sa_split_row_stride\(n\)\)\);",
        r"return sa_split_fixed_bytes\(n\) \+ 4LL \* kSaSplitGroup \* sa_split_groups\(n\) \* "
        r"sa_split_row_stride\(n\);",
        r"return \(int\)\(kSaSmSmemBytes / "
        r"\(sa_split_smem_bytes\(n\) \+ kSaBlockReservedBytes\)\);",
        r"sa_split_waves\(int n\) \{ return n >= kSaSplitTwoWaveSpins \? 2 : 1; \}",
        r"return chains <= \(long long\)sms \* sa_split_blocks_per_sm\(n\) \* sa_split_waves\(n\) "
        r"\? sa_split_warps\(n\) : 1;"):
        assert re.search(rule, body), rule
    # a split block takes more than half an SM at every n of the global
    # body: 8 ring groups at 238 (126 KiB), 3 at 1,024 (209 KiB)
    assert (sa.split_smem_bytes(238), sa.split_smem_bytes(1024)) == (128896, 213888)
    assert all(sa._SM_SMEM_BYTES // (sa.split_smem_bytes(n) + sa._BLOCK_RESERVED) == 1
               for n in range(238, sa.MAX_SPINS + 1))
    # the allocator's 48 chains split at every n; below 512 spins up to one
    # wave (132 chains on 132 SMs) split, one more a warp a chain (a BBO
    # chunk of 64 tiles x 4 reads at n = 256, a pool of 2,048 tiles); from
    # 512 on up to two waves (that chunk at n = 512 or 1,024 splits)
    assert [sa.global_warps(48, n, 132) for n in (238, 256, 257, 512, 513, 1000, 1024)] == \
        [8, 8, 5, 8, 6, 8, 8]
    assert (sa.global_warps(132, 511, 132), sa.global_warps(133, 511, 132)) == (8, 1)
    assert (sa.global_warps(264, 512, 132), sa.global_warps(265, 512, 132)) == (8, 1)
    assert (sa.global_warps(264, 1024, 132), sa.global_warps(265, 1024, 132)) == (8, 1)
    assert (sa.global_warps(114, 238, 114), sa.global_warps(115, 238, 114)) == (8, 1)
    assert sa.global_warps(256, 256, 132) == sa.global_warps(8192, 256, 132) == 1
    assert sa.global_warps(256, 1024, 132) == 8 and sa.global_warps(8192, 1024, 132) == 1
    assert sa.global_warps(1, 24, 132) == 1


# (T, tn, K, td, x_itemsize, c_itemsize) -> how the decode block stages C
DECODE_LAYOUTS = [
    ((4, 32, 4, 128, 2, 2), {"rs": 16, "c": "tiles", "groups": 1}),    # qwen
    ((4, 8, 3, 128, 2, 2), {"rs": 28, "c": "tiles", "groups": 1}),     # BBO wk
    ((4, 32, 4, 131, 2, 2), {"rs": 16, "c": "raw", "groups": 1}),      # zamba2
    ((4, 32, 4, 131, 4, 4), {"rs": 8, "c": "raw", "groups": 1}),
    ((13, 32, 4, 131, 2, 2), {"rs": 16, "c": "device", "groups": 2}),  # T > 4
    ((4, 32, 4, 419, 2, 2), {"rs": 16, "c": "device", "groups": 4}),   # mamba2
    ((4, 32, 4, 37, 2, 2), {"rs": 16, "c": "device", "groups": 1}),    # reduced
    ((1, 16, 9, 160, 4, 4), {"rs": 4, "c": "raw", "groups": 1}),
    ((2, 12, 3, 20, 2, 2), {"rs": 32, "c": "device", "groups": 1}),
]


@pytest.mark.parametrize("shape,want", DECODE_LAYOUTS, ids=lambda v: str(v))
def test_decode_layout_rule_is_the_headers(shape, want):
    """kernels/bitlinear.py's decode_layout mirrors csrc/bitlinear_decode.cuh's
    decode_geom: its constants, its rule for staging C raw, and where that
    puts zamba2's (td 131) and mamba2-130m's (td 419) in_proj tiles."""
    import re

    from repro_torch.kernels import bitlinear as bl

    header = (_ROOT / "src" / "repro_torch" / "csrc" / "bitlinear_decode.cuh").read_text()
    defines = dict(re.findall(r"^#define (BITLINEAR_DECODE_\w+) (\d+)$", header, re.M))
    assert int(defines["BITLINEAR_DECODE_STAGE_BYTES"]) == bl.DECODE_STAGE_BYTES
    assert re.search(rf"^constexpr int DEC_RAW_STAGE_BYTES = {bl.DECODE_RAW_STAGE_BYTES};",
                     header, re.M)
    assert re.search(rf"^constexpr int DEC_WARPS = {bl.DECODE_WARPS};", header, re.M)
    assert re.search(rf"^constexpr int DEC_RAW_COLS = {bl.DECODE_RAW_COLS};", header, re.M)
    body = " ".join(header.split())
    for rule in (r"g\.stage_c = c_tile % 16 == 0 && td <= 32 \* ring_cols\(td\);",
                 r"g\.c_slot = c_tile % 16 \? align16\(c_tile\) \+ 16 : c_tile;",
                 r"g\.raw_c = td > 32 \* ring_cols\(td\) && td <= 32 \* DEC_RAW_COLS && T <= 4 && "
                 r"\(size_t\)g\.rs \* \(g\.c_slot \+ per\) <= \(size_t\)DEC_RAW_STAGE_BYTES;"):
        assert re.search(rule, body), rule
    T, tn, K, td, xs, cs = shape
    assert bl.decode_layout(T=T, tn=tn, K=K, td=td, x_itemsize=xs, c_itemsize=cs) == want


def test_compress_cli_needs_cuda():
    _cpu_only()
    from repro_torch.launch.compress import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--plan-only"])


def test_serving_entry_points_refuse_the_cpu_without_device(tmp_path):
    _cpu_only()
    from repro_torch.launch.serve import main, serve_model
    from repro_torch.models import init_cache

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_model(cfg, ckpt_dir=str(tmp_path), batch=1, prompt_len=4, steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--steps", "2"])
    assert not any(tmp_path.iterdir())


def test_scheduler_and_page_pool_refuse_the_cpu_without_device():
    _cpu_only()
    from repro_torch.serving import Engine, PagePool, Scheduler

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagePool(cfg, num_slots=2, max_len=32, page_size=8)
    values, _ = split(init_model(cfg, seed=0, device="cpu"))
    eng = Engine(cfg, values, max_len=32, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(eng, num_slots=2, page_size=8)
    assert Scheduler(eng, num_slots=2, page_size=8, device="cpu").pool.device.type == "cpu"


def test_paper_instances_refuse_the_cpu_without_device():
    _cpu_only()
    from repro_torch.core.instances import paper_instances, random_instance, shrunk_vgg_instance

    for make in (lambda: shrunk_vgg_instance(0), lambda: random_instance(0),
                 lambda: paper_instances(1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert shrunk_vgg_instance(0, device="cpu").shape == (8, 100)


def test_moe_entry_points_refuse_the_cpu_without_device(tmp_path):
    _cpu_only()
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import init_cache

    cfg = reduced_for_smoke(get_config("granite-moe-1b-a400m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_model(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_model(cfg, compress=True, batch=1, prompt_len=4, steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compress_model(cfg, CompressionPolicy(tile_d=32, min_size=1024), str(tmp_path))
    assert not any(tmp_path.iterdir())


def test_hybrid_entry_points_refuse_the_cpu_without_device(tmp_path):
    """zamba2-1.2b (SSM groups and the shared attention block) and
    mamba2-130m build, cache and serve on the GPU unless asked for the CPU."""
    _cpu_only()
    from repro_torch.launch.serve import serve_model
    from repro_torch.models import init_cache

    for arch in ("zamba2-1.2b", "mamba2-130m"):
        cfg = reduced_for_smoke(get_config(arch))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_model(cfg, seed=0)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_cache(cfg, 1, 8)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_model(cfg, compress=True, batch=1, prompt_len=4, steps=2)
        assert init_cache(cfg, 1, 8, device="cpu")["groups"]["0"]["ssm"]["state"].device.type \
            == "cpu"
    assert not any(tmp_path.iterdir())


def test_grid_variant_switches_are_the_headers():
    """tools/torch_grid_variants.py builds its variants with -D switches;
    each must be one that csrc/bitlinear.cuh defines, so a renamed switch
    fails here instead of silently building the kernel as it is."""
    import importlib.util
    import re

    spec = importlib.util.spec_from_file_location(
        "torch_grid_variants", _ROOT / "tools" / "torch_grid_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    header = (_ROOT / "src" / "repro_torch" / "csrc" / "bitlinear.cuh").read_text()
    defined = set(re.findall(r"^#ifndef (BITLINEAR_MMA_\w+)$", header, re.M))
    named = tool.variants()
    assert named["as_built"] == ([], True)
    for name, (flags, _) in named.items():
        for flag in flags:
            macro = re.fullmatch(r"-D(\w+)=\d+", flag)
            assert macro and macro.group(1) in defined, (name, flag)


def test_decode_variant_switches_are_the_headers():
    """tools/torch_decode_variants.py builds its variants with -D switches;
    each must be one that csrc/bitlinear_decode.cuh defines."""
    import importlib.util
    import re

    spec = importlib.util.spec_from_file_location(
        "torch_decode_variants", _ROOT / "tools" / "torch_decode_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    header = (_ROOT / "src" / "repro_torch" / "csrc" / "bitlinear_decode.cuh").read_text()
    defined = set(re.findall(r"^#ifndef (BITLINEAR_DECODE_\w+)$", header, re.M))
    named = tool.variants()
    assert named["as_built"] == ([], True)
    assert {"copies_only", "body_only"} <= set(named)
    for name, (flags, _) in named.items():
        for flag in flags:
            macro = re.fullmatch(r"-D(\w+)=\d+", flag)
            assert macro and macro.group(1) in defined, (name, flag)


def test_stream_variant_switches_are_the_headers():
    """tools/torch_stream_variants.py builds its variants with -D switches;
    each must be one that csrc/bitlinear_stream.cuh defines."""
    import importlib.util
    import re

    spec = importlib.util.spec_from_file_location(
        "torch_stream_variants", _ROOT / "tools" / "torch_stream_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    header = (_ROOT / "src" / "repro_torch" / "csrc" / "bitlinear_stream.cuh").read_text()
    defined = set(re.findall(r"^#ifndef (BITLINEAR_STREAM_\w+)$", header, re.M))
    named = tool.variants()
    assert named["as_built"] == ([], True)
    assert {"copies_only", "body_only"} <= set(named)
    for name, (flags, _) in named.items():
        for flag in flags:
            macro = re.fullmatch(r"-D(\w+)=\d+", flag)
            assert macro and macro.group(1) in defined, (name, flag)


def test_stream_layout_constants_are_the_headers():
    """kernels/bitlinear.py's stream_geometry mirrors csrc/bitlinear_stream.cuh's
    layout: its constants are the header's defaults."""
    import re

    from repro_torch.kernels import bitlinear as bl

    header = (_ROOT / "src" / "repro_torch" / "csrc" / "bitlinear_stream.cuh").read_text()
    defaults = dict(re.findall(r"^#define BITLINEAR_STREAM_(\w+) (\d+)$", header, re.M))
    assert int(defaults["WARPS"]) == bl.STREAM_WARPS
    assert int(defaults["STAGES"]) == bl.STREAM_STAGES
    assert int(defaults["RING_BYTES"]) == bl.STREAM_RING_BYTES
    assert int(defaults["ROWS"]) == bl.STREAM_ROWS
    # the residency the launch bounds promise, which stream_cluster_size counts on
    assert int(defaults["MIN_BLOCKS"]) == bl.STREAM_MIN_BLOCKS
    rule = re.search(r"stream_min_blocks\(int bt\) \{\s*return BITLINEAR_STREAM_MIN_BLOCKS \? "
                     r"BITLINEAR_STREAM_MIN_BLOCKS : bt <= (\d+) \? (\d+) : (\d+);", header)
    assert rule, "stream_min_blocks's rule not found in the header"
    cut, small, large = (int(v) for v in rule.groups())
    for bt in (1, 2, 4, 8):
        assert bl.stream_min_blocks(bt) == (small if bt <= cut else large), bt


def test_grid_chunk_constants_are_the_headers():
    """kernels/bitlinear.py's grid_mma_chunk mirrors csrc/bitlinear.cuh's
    mma_ntp: the cap on a chunk's n-tile pairs is the header's default and
    the widths it picks from are the ones the header instantiates."""
    import re

    from repro_torch.kernels import bitlinear as bl

    header = (_ROOT / "src" / "repro_torch" / "csrc" / "bitlinear.cuh").read_text()
    defaults = dict(re.findall(r"^#define BITLINEAR_MMA_(\w+) (\d+)$", header, re.M))
    assert int(defaults["MAX_NTP"]) == bl.GRID_MMA_MAX_NTP
    rule = re.search(r"return need <= (\d+) \? \1 : need <= (\d+) \? \2 : need <= (\d+) "
                     r"\? \3 : (\d+);", header)
    assert rule, "mma_ntp's rule not found in the header"
    assert tuple(int(v) for v in rule.groups()) == bl.GRID_MMA_NTPS
    # every count the rule picks has a launch of its own
    for n in bl.GRID_MMA_NTPS:
        assert f"return launch_mma_kp<KSTEP, {n}, BP, ODD>(a);" in header, n


def test_anneal_variants_are_the_kernels_text():
    """tools/torch_anneal_variants.py builds K2's variants by substituting
    text of csrc/sqa_sweep.cu; each substituted text must be in the source
    once, so an edited kernel fails here instead of building a variant that
    is the kernel as it is."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_anneal_variants", _ROOT / "tools" / "torch_anneal_variants.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (_ROOT / "src" / "repro_torch" / "csrc" / "sqa_sweep.cu").read_text()
    named = tool.variants()
    assert named["as_built"] == []
    assert {"no_barrier", "no_neighbours", "no_shuffle"} <= set(named)
    for name, subs in named.items():
        for old, new in subs:
            assert source.count(old) == 1 and new != old, name


_TRAINING_MODULES = ("optim/__init__.py", "optim/adamw.py", "optim/schedules.py",
                     "optim/grad_compress.py", "data/__init__.py", "data/pipeline.py",
                     "training/__init__.py", "training/loop.py", "launch/presets.py",
                     "launch/train.py")


def test_training_modules_are_guarded():
    """The training slice's modules exist and are among the files whose
    imports are checked above (no JAX, no ``repro``)."""
    for rel in _TRAINING_MODULES:
        path = _ROOT / "src" / "repro_torch" / rel
        assert path in _FILES, rel
        assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}, rel


def test_training_entry_points_refuse_the_cpu_without_device(tmp_path):
    _cpu_only()
    from repro_torch.configs.base import ParallelConfig, ShapeConfig
    from repro_torch.data import make_pipeline
    from repro_torch.launch import train as train_cli
    from repro_torch.optim.grad_compress import CompressionCycle
    from repro_torch.training import init_train_state

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_train_state(0, cfg, ParallelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_pipeline(cfg, ShapeConfig("s", "train", 8, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CompressionCycle(CompressionPolicy(), every=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", "qwen3-32b", "--reduced", "--ckpt-dir", str(tmp_path),
                        "--max-restarts", "0"])
    assert not any(p.name.startswith("step_") for p in tmp_path.iterdir())


def test_manager_round_trips_a_named_tuple(tmp_path):
    """A ``TrainState`` (a NamedTuple of a 0-d int32 step and trees of bf16
    and f32 tensors) saves asynchronously and restores into its own type,
    every leaf byte-identical; the leaves are named by field, as JAX's
    checkpointer names them."""
    from repro_torch.checkpoint import checkpointer
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.training import TrainState, init_train_state

    cfg = dataclasses.replace(reduced_for_smoke(get_config("granite-moe-1b-a400m")),
                              dtype="bfloat16")
    for optimizer in ("adamw", "adafactor"):
        pcfg = ParallelConfig(optimizer=optimizer)
        state = init_train_state(3, cfg, pcfg, device="cpu")
        state = state._replace(step=torch.tensor(5, dtype=torch.int32))
        g = torch.Generator().manual_seed(1)
        for leaf in (t for _, t in _paths(state.opt)):
            leaf.copy_(torch.rand(leaf.shape, generator=g))
        d = tmp_path / optimizer
        mgr = CheckpointManager(str(d))
        mgr.save(5, state)
        for _, leaf in _paths(state.params):       # the saved copy is the host's
            leaf.add_(1)
        mgr.wait()
        assert mgr.last_save["step"] == 5
        names = set(checkpointer.leaf_entries(str(d), 5))
        assert "step" in names and any(n.startswith("params/") for n in names)
        assert any(n.startswith("opt/") for n in names)
        like = init_train_state(0, cfg, pcfg, device="meta")
        step, back = mgr.restore_latest(like, device="cpu")
        assert step == 5 and type(back) is TrainState
        want = init_train_state(3, cfg, pcfg, device="cpu")
        g = torch.Generator().manual_seed(1)
        for leaf in (t for _, t in _paths(want.opt)):
            leaf.copy_(torch.rand(leaf.shape, generator=g))
        want = want._replace(step=torch.tensor(5, dtype=torch.int32))
        got_pairs, want_pairs = _paths(back), _paths(want)
        assert [p for p, _ in got_pairs] == [p for p, _ in want_pairs]
        for (p, a), (_, b) in zip(got_pairs, want_pairs):
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), p


def _paths(tree):
    from repro_torch.compression.plan import tree_paths

    return tree_paths(tree)


def test_flash_attention_refuses_under_autograd():
    """K5 has no backward: the wrapper and the model-layout adapter raise
    while autograd records through q/k/v (the same rule on every device; on
    the card the kernel's output would carry no gradient), and run under
    ``torch.no_grad`` or on tensors that need none."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=g)
    k = torch.randn(1, 2, 8, 16, generator=g)
    v = torch.randn(1, 2, 8, 16, generator=g)
    for t in (q, k, v):
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention(q, k, v)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention_model_layout(q.transpose(1, 2).reshape(1, 8, 2, 2, 16),
                                             k.transpose(1, 2), v.transpose(1, 2), 0)
        with torch.no_grad():
            fa.flash_attention(q, k, v)
        t.requires_grad_(False)
    fa.flash_attention(q, k, v)
