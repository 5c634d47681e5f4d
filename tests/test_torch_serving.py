"""The port's serving path (Engine.generate, serve_model, the serve CLI, the
checkpoint manager and the artifact's serving helpers) against the JAX
package's on reduced qwen3-32b, float32, weights carried across."""

import copy
import dataclasses
import math
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.checkpoint import checkpointer as jckpt
from repro.checkpoint.manager import CheckpointManager as JManager
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.models import init_model as j_init_model
from repro.models.params import split as j_split
from repro.serving.engine import Engine as JEngine
from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.compression import CompressionArtifact
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core import quantized as tq
from repro_torch.kernels import ops as tops
from repro_torch.launch.serve import serve_model
from repro_torch.models import attention as tattn
from repro_torch.serving import Engine

torch.set_num_threads(1)

B, P, STEPS = 3, 8, 8


@pytest.fixture(autouse=True)
def _no_port_hooks():
    # the hooks are process-global: every test here starts and ends with
    # none registered, whatever an earlier test file registered explicitly
    tops.disable_kernels()
    yield
    tops.disable_kernels()


def _cfgs():
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen3-32b")), dtype="float32")
    tcfg = dataclasses.replace(reduced_for_smoke(get_config("qwen3-32b")), dtype="float32")
    return jcfg, tcfg


def _carry(jtree):
    return bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jtree)}, "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jvals = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0]
    policy = jc.CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                                  min_size=4096)
    jcv, jart = jc.execute_plan(jc.plan_compression(jvals, policy), jvals,
                                key=jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, tcfg.vocab_size, (B, P))
    return {"jcfg": jcfg, "tcfg": tcfg, "jvals": jvals, "tvals": _carry(jvals), "jcv": jcv,
            "tcv": _carry(jcv), "jart": jart, "prompts": prompts}


def _jax_tokens(m, compressed, fused=None, prompts=None, eos_id=1):
    from repro.kernels import ops as jops

    prompts = m["prompts"] if prompts is None else prompts
    eng = JEngine(m["jcfg"], m["jcv"] if compressed else m["jvals"], max_len=P + STEPS,
                  batch=len(prompts), eos_id=eos_id,
                  artifact=m["jart"] if compressed else None, use_fused_bitlinear=fused)
    out = np.asarray(eng.generate(jnp.asarray(prompts, jnp.int32), STEPS))
    jops.disable_kernels()
    return out, eng


def _port_engine(m, compressed, fused=None, eos_id=1, batch=B):
    return Engine(m["tcfg"], m["tcv"] if compressed else m["tvals"], max_len=P + STEPS,
                  batch=batch, eos_id=eos_id,
                  artifact=m["jart"].manifest if compressed else None, use_fused_bitlinear=fused)


@pytest.mark.parametrize("compressed,fused", [
    (False, None),       # dense: hooks stay off
    (False, True),       # dense with K5's plain version in the attention
    (True, None),        # the artifact turns both hooks on
    (True, False),       # compressed layers through the einsum form
])
def test_generate_tokens_identical_to_jax_engine(model, compressed, fused):
    want, jeng = _jax_tokens(model, compressed, fused)
    eng = _port_engine(model, compressed, fused)
    assert eng.fused_bitlinear == jeng.fused_bitlinear
    assert (eng.kernel_hooks[0] is not None) == bool(fused or (compressed and fused is None))
    assert tattn._FLASH_IMPL is None          # the process's hooks stay as they were
    got = eng.generate(torch.from_numpy(model["prompts"]), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.compression == jeng.compression
    assert eng.last_timing["decode_steps"] == STEPS - 1


def _counting_adapters(monkeypatch):
    """Count the calls of the K3 and K5 adapters that ``enable_kernels``
    registers (their plain versions on the CPU)."""
    calls = {"fused": 0, "flash": 0}
    fused, flash = tops.apply_compressed_fused, tops.flash_attention_model_layout

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tops, "apply_compressed_fused", counted("fused", fused))
    monkeypatch.setattr(tops, "flash_attention_model_layout", counted("flash", flash))
    return calls


def test_two_engines_generating_in_turn_each_run_their_own_kernels(model, monkeypatch):
    """An Engine with the kernels and one built with use_fused_bitlinear=False
    generate in turn: each gives the tokens and makes the kernel calls it
    makes alone, and neither building nor running one changes the
    process's hooks (JAX compiles each Engine's hooks into its steps)."""
    calls = _counting_adapters(monkeypatch)
    prompts = torch.from_numpy(model["prompts"])
    before = tops.kernel_hooks()
    alone = {}
    for fused in (None, False):
        calls.update(fused=0, flash=0)
        alone[fused] = (_port_engine(model, True, fused).generate(prompts, STEPS), dict(calls))
    per_forward = sum(math.prod(e["group_dims"]) or 1
                      for e in model["jart"].manifest["tensors"].values())
    assert alone[None][1] == {"fused": per_forward * STEPS, "flash": model["tcfg"].num_layers}
    assert alone[False][1] == {"fused": 0, "flash": 0}
    engines = {None: _port_engine(model, True), False: _port_engine(model, True, False)}
    assert tops.kernel_hooks() == before
    for _ in range(2):
        for fused, eng in engines.items():
            calls.update(fused=0, flash=0)
            assert torch.equal(eng.generate(prompts, STEPS), alone[fused][0])
            assert calls == alone[fused][1]
            assert tops.kernel_hooks() == before


def test_disable_kernels_after_an_engine_is_built_changes_nothing_it_runs(model, monkeypatch):
    calls = _counting_adapters(monkeypatch)
    prompts = torch.from_numpy(model["prompts"])
    eng = _port_engine(model, True)
    plain = _port_engine(model, True, False)
    want, made = eng.generate(prompts, STEPS), dict(calls)
    assert made["fused"] > 0 and made["flash"] == model["tcfg"].num_layers
    tops.disable_kernels()
    calls.update(fused=0, flash=0)
    assert torch.equal(eng.generate(prompts, STEPS), want) and calls == made
    # nor does a later enable_kernels() turn them on for the plain Engine
    want_plain = plain.generate(prompts, STEPS)
    tops.enable_kernels()
    calls.update(fused=0, flash=0)
    assert torch.equal(plain.generate(prompts, STEPS), want_plain)
    assert calls == {"fused": 0, "flash": 0}


def test_eos_padding_and_early_exit_identical_to_jax(model):
    # identical rows finish together, so the decode loop exits early
    prompts = np.repeat(model["prompts"][:1], 2, axis=0)
    free, _ = _jax_tokens(model, False, prompts=prompts, eos_id=10 ** 6)
    eos = int(free[0, P + 2])                  # the third generated token
    want, _ = _jax_tokens(model, False, prompts=prompts, eos_id=eos)
    eng = _port_engine(model, False, eos_id=eos, batch=2)
    got = eng.generate(torch.from_numpy(prompts), STEPS).numpy()
    np.testing.assert_array_equal(got, want)
    first = int(np.argmax(got[0, P:] == eos))
    assert first <= 2 and (got[:, P + first:] == eos).all()
    assert eng.last_timing["decode_steps"] == first


def test_sampling_draws_from_the_generator(model):
    eng = Engine(model["tcfg"], model["tvals"], max_len=P + STEPS, batch=B, temperature=1.0)
    prompts = torch.from_numpy(model["prompts"])
    a = eng.generate(prompts, STEPS, generator=torch.Generator().manual_seed(5))
    b = eng.generate(prompts, STEPS, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    greedy = eng.generate(prompts, STEPS)          # no generator: argmax
    np.testing.assert_array_equal(greedy.numpy(), _jax_tokens(model, False)[0])


def test_engine_rejects_params_that_do_not_match_the_manifest(model):
    with pytest.raises(ValueError, match="does not match the compression manifest"):
        Engine(model["tcfg"], model["tvals"], max_len=16, batch=2,
               artifact=model["jart"].manifest)
    bad = copy.deepcopy(model["jart"].manifest)
    path = next(iter(bad["tensors"]))
    bad["tensors"][path]["C"]["shape"][-1] += 1
    with pytest.raises(ValueError, match="C: shape"):
        Engine(model["tcfg"], model["tcv"], max_len=16, batch=2, artifact=bad)
    assert not tq.has_fused_bitlinear()


def test_compression_summary_reports_provenance_as_jax(model):
    manifest = copy.deepcopy(model["jart"].manifest)
    manifest["delta"] = {"parent_fingerprint": "abc", "generation": 2, "tiles_resolved": 3,
                         "tiles_reused": 5, "fraction_resolved": 0.375, "tiles_total": 8}
    manifest["autotune"] = {"budget_bytes": 1000, "engine": "greedy", "calibrated": True,
                            "predicted_distortion": 0.5, "objective": "eval_loss",
                            "eval": {"num_batches": 2, "batch": 4, "seq_len": 16, "seed": 0,
                                     "baseline_loss": 1.5, "surrogate_skip_rate": 0.6},
                            "lp_check": {"relative_gap": 0.0, "within_tolerance": True}}
    jeng = JEngine(model["jcfg"], model["jcv"], max_len=16, batch=2,
                   artifact=jc.CompressionArtifact(manifest))
    eng = Engine(model["tcfg"], model["tcv"], max_len=16, batch=2, artifact=manifest)
    assert eng.compression == jeng.compression
    assert eng.compression["delta"]["generation"] == 2


def test_artifact_serving_helpers_match_jax(model, tmp_path):
    jart = model["jart"]
    art = CompressionArtifact(jart.manifest)
    assert art.total_ratio == jart.total_ratio and art.total_bytes() == jart.total_bytes()
    assert not CompressionArtifact.exists(str(tmp_path))
    art.save(str(tmp_path))
    assert CompressionArtifact.exists(str(tmp_path)) == jc.CompressionArtifact.exists(
        str(tmp_path)) is True


def test_serve_model_from_a_jax_checkpoint_gives_jax_tokens(model, tmp_path):
    jckpt.save(str(tmp_path), 0, {"params": model["jcv"]})
    model["jart"].save(str(tmp_path))
    res = serve_model(model["tcfg"], ckpt_dir=str(tmp_path), batch=2, prompt_len=P,
                      steps=STEPS, seed=3, device="cpu", verbose=False)
    assert res.engine.compression["tensors"] == len(model["jart"].manifest["tensors"])
    assert res.engine.fused_bitlinear and res.engine.kernel_hooks[0] is not None
    want, _ = _jax_tokens(model, True, prompts=res.prompts.numpy())
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def test_serve_model_compresses_when_asked(model):
    res = serve_model(model["tcfg"], compress=True, batch=2, prompt_len=4, steps=3,
                      device="cpu", verbose=False)
    assert res.engine.compression["tensors"] > 0 and res.tokens.shape == (2, 7)


# ---------------------------------------------------------------------------
# SSM and hybrid serving: mamba2-130m, zamba2-1.2b (14 layers: two groups and
# a remainder; prompts of 40 tokens, past the shared block's reduced window
# of 32, so its cache is a ring)
# ---------------------------------------------------------------------------

HYBRIDS = {"zamba2-1.2b": {"num_layers": 14}, "mamba2-130m": {}}
HP = 40


@pytest.fixture(scope="module", params=sorted(HYBRIDS))
def hybrid(request):
    arch = request.param
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), dtype="float32",
                               **HYBRIDS[arch])
    tcfg = dataclasses.replace(reduced_for_smoke(get_config(arch)), dtype="float32",
                               **HYBRIDS[arch])
    jvals = j_split(j_init_model(jax.random.PRNGKey(1), jcfg))[0]
    policy = jc.CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                                  min_size=4096)
    jcv, jart = jc.execute_plan(jc.plan_compression(jvals, policy), jvals,
                                key=jax.random.PRNGKey(0))
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, HP))
    return {"jcfg": jcfg, "tcfg": tcfg, "jvals": jvals, "tvals": _carry(jvals), "jcv": jcv,
            "tcv": _carry(jcv), "jart": jart, "prompts": prompts}


def _list_cache_tokens(cfg, params, prompts, steps):
    """Greedy tokens from the port's prefill and decode steps over the
    unstacked (list) cache form: the SSM state and the ring the prefill
    wrote in place carry into every step."""
    from repro_torch.models import init_cache
    from repro_torch.serving.engine import make_decode_step, make_prefill

    B, P = prompts.shape
    cache = init_cache(cfg, B, P + steps, stacked=False, device="cpu")
    assert isinstance(cache["groups"], list)
    with torch.inference_mode():
        last, cache = make_prefill(cfg)(params, {"tokens": prompts}, cache)
        cur = torch.argmax(last, dim=-1)
        toks = [prompts, cur[:, None]]
        for t in range(steps - 1):
            logits, cache = make_decode_step(cfg)(params, cur, cache, P + t)
            cur = torch.argmax(logits, dim=-1)
            toks.append(cur[:, None])
    return torch.cat(toks, dim=1)


@pytest.mark.parametrize("compressed", [False, True])
def test_hybrid_generate_tokens_identical_to_jax_in_both_cache_forms(hybrid, compressed):
    """``Engine.generate`` (the stacked cache) and a decode loop over the
    list cache give JAX's engine's tokens, dense and compressed (the port's
    hooks on: K3's and K5's plain versions here; JAX's einsum form)."""
    m = hybrid
    eos = m["tcfg"].vocab_size                  # never emitted
    jeng = JEngine(m["jcfg"], m["jcv"] if compressed else m["jvals"], max_len=HP + STEPS,
                   batch=2, eos_id=eos, artifact=m["jart"] if compressed else None,
                   use_fused_bitlinear=False)
    want = np.asarray(jeng.generate(jnp.asarray(m["prompts"], jnp.int32), STEPS))
    params = m["tcv"] if compressed else m["tvals"]
    eng = Engine(m["tcfg"], params, max_len=HP + STEPS, batch=2, eos_id=eos,
                 artifact=m["jart"].manifest if compressed else None)
    assert eng.fused_bitlinear == compressed
    got = eng.generate(torch.from_numpy(m["prompts"]), STEPS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert eng.last_timing["decode_steps"] == STEPS - 1
    if compressed:
        assert eng.compression["tensors"] == len(m["jart"].manifest["tensors"])
    listed = _list_cache_tokens(m["tcfg"], params, torch.from_numpy(m["prompts"]), STEPS)
    np.testing.assert_array_equal(listed.numpy(), want)


def test_serve_cli_serves_reduced_zamba2_compressed(monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced
    --compress`` on the CPU (the CLI's device resolved to it): every
    in_proj, out_proj and shared-block weight the CLI's policy admits is
    compressed and served."""
    from repro_torch.launch import serve as serve_mod

    monkeypatch.setattr(serve_mod, "resolve_device", lambda d=None: torch.device("cpu"))
    seen = {}
    real_engine = serve_mod.Engine

    def engine(*a, **k):
        seen["engine"] = real_engine(*a, **k)
        return seen["engine"]

    monkeypatch.setattr(serve_mod, "Engine", engine)
    serve_mod.main(["--arch", "zamba2-1.2b", "--reduced", "--compress", "--steps", "4",
                    "--batch", "2"])
    eng = seen["engine"]
    out = capsys.readouterr().out
    assert "[compress]" in out and "generated: (2, 20)" in out
    paths = set(eng.artifact.manifest["tensors"])
    assert {"groups/0/ssm/in_proj/w", "groups/0/ssm/out_proj/w", "groups/5/ssm/in_proj/w",
            "shared/attn/wq/w", "shared/mlp/down/w"} <= paths
    assert eng.artifact.manifest["tensors"]["groups/0/ssm/in_proj/w"]["tile_d"] == 37
    assert eng.fused_bitlinear and eng.kernel_hooks[0] is not None


def test_serve_cli_load_curve_needs_cuda(capsys):
    """``--load-curve`` and its flags are ported: they parse and reach the
    CUDA check."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--load-curve", "--qps", "4", "16",
              "--requests", "8", "--num-slots", "2", "--page-size", "8"])
    assert "not yet ported" not in capsys.readouterr().err


def test_load_curve_prints_jax_csv_and_completes_every_request(model, capsys):
    """The sweep ``main`` and chip_smoke.py share, on the CPU: JAX's CSV
    header, one row per rate, every request completed; the page size of 8
    halves to 4, which divides max_len = 12 (PagePool refuses 8), as JAX's
    launcher does."""
    import inspect

    from repro.launch import serve as jserve
    from repro_torch.launch.serve import LOAD_CSV_HEADER, load_curve

    assert f'print("{LOAD_CSV_HEADER}")' in inspect.getsource(jserve.main)
    eng = _port_engine(model, True, batch=2)
    res = load_curve(eng, model["tcfg"], qps=[64.0, 256.0], requests=16, num_slots=4,
                     page_size=8, prompt_len=P, steps=4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == LOAD_CSV_HEADER and len(lines) == 3
    for line, r, q in zip(lines[1:], res, (64.0, 256.0)):
        assert r.qps == q and r.completed == r.n_requests == 16 and r.total_tokens == 64
        assert line.split(",")[:2] == [f"{q:g}", "16"] and len(line.split(",")) == 7
        assert 1 <= r.peak_running <= 4 and r.evictions == 0


def test_serve_cli_autotune_kernels_needs_cuda(capsys):
    """``--autotune-kernels`` is ported: it gets past the "not yet ported"
    exit and reaches the CUDA check."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "qwen3-32b", "--reduced", "--autotune-kernels"])
    assert "not yet ported" not in capsys.readouterr().err


# ---------------------------------------------------------------------------
# checkpoint manager
# ---------------------------------------------------------------------------

def test_manager_keeps_the_last_steps_and_restores_across_packages(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for step in (1, 2, 3):
        mgr.save(step, tree)
        tree["a"] += 1                      # the saved copy is taken at save()
    mgr.wait()
    assert mgr.latest_step() == 3
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    step, got = mgr.restore_latest({"a": torch.empty(2, 3), "b": {"c": torch.empty(4)}},
                                   device="cpu")
    assert step == 3 and torch.equal(got["a"], torch.arange(6.0).reshape(2, 3) + 2)
    jstep, jgot = JManager(str(tmp_path)).restore_latest(
        {"a": jnp.zeros((2, 3)), "b": {"c": jnp.zeros(4)}})
    assert jstep == 3 and np.array_equal(np.asarray(jgot["a"]), got["a"].numpy())
    mgr.save_aux("meta.json", {"x": 1})
    assert mgr.load_aux("meta.json") == {"x": 1} and mgr.load_aux("none.json") is None
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest({}) == (None, None)


def test_manager_gc_removes_only_stale_tmp_dirs(tmp_path):
    stale, fresh = tmp_path / "step_00000007.tmp", tmp_path / "step_00000008.tmp"
    stale.mkdir()
    fresh.mkdir()
    old = time.time() - 7200
    os.utime(stale, (old, old))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.zeros(2)})
    assert not stale.exists() and fresh.exists()
    CheckpointManager(str(tmp_path), async_save=False, stale_tmp_s=0.0).save(
        2, {"a": torch.zeros(2)})
    assert not fresh.exists()
