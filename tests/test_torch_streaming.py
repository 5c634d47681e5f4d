"""The port's streaming compression against its own ``execute_plan`` and
the JAX package's streaming tier (CPU): streamed leaves bit-identical to
execute, leaf reads equal to JAX's across shards, a bf16 checkpoint streamed
by a process that never imports JAX or ml_dtypes, kill-and-resume byte
identity, surrogate probing on JAX's draws, supervision as the reference's,
and the CLI's flag checks."""

import hashlib
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.checkpoint import checkpointer as jckpt
from repro.compression import execute as jexec
from repro.compression import streaming as jstream
from repro.compression.autotune import probe as jprobe
from repro_torch import bridge
from repro_torch import compression as tc
from repro_torch.checkpoint import checkpointer as tckpt
from repro_torch.compression import streaming as tstream
from repro_torch.compression.autotune import probe as tprobe
from repro_torch.compression.plan import tree_paths
from repro_torch.distributed import Heartbeat, StepTimer, run_with_restarts

torch.set_num_threads(1)

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_POLICY = dict(tile_n=16, tile_d=32, rank_ratio=0.25, min_size=1024)


def _np_values(seed=7):
    """The reference's streaming fixture as numpy: f32, a bf16 layer stack,
    f32, and a dense bias."""
    rng = np.random.default_rng(seed)
    return {
        "a/w": rng.standard_normal((64, 128)).astype(np.float32),
        "b/w": rng.standard_normal((3, 32, 64)).astype(np.float32).astype(ml_dtypes.bfloat16),
        "c/w": rng.standard_normal((64, 64)).astype(np.float32),
        "bias": np.ones((128,), np.float32),
    }


def _jax(flat):
    out: dict = {}
    for path, a in flat.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = jnp.asarray(a)
    return out


def _port_policy(method="alternating"):
    return tc.CompressionPolicy(method=method, **_POLICY)


def _dir_digest(d):
    h = hashlib.sha256()
    for root, _, files in sorted(os.walk(d)):
        for f in sorted(files):
            p = os.path.join(root, f)
            h.update(os.path.relpath(p, d).encode())
            with open(p, "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


def _output_leaf(out_dir, name):
    e = tckpt.leaf_entries(out_dir, 0)[name]
    return tckpt.read_leaf_slice(out_dir, 0, name, tuple(slice(0, s) for s in e["shape"]),
                                 entry=e)


def _assert_streamed_equals_execute(out_dir, plan, cvalues):
    flat = dict(tree_paths(cvalues))
    for t in plan.tensors:
        for k in ("m_packed", "C"):
            want = tckpt.to_numpy(flat[f"{t.path}/{k}"])
            got = _output_leaf(out_dir, f"params/{t.path}/{k}")
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (t.path, k)


# -- bit identity with execute_plan -------------------------------------------

@pytest.mark.parametrize("budget", [None, 8 * 4 * 16 * 32 * 3], ids=["default", "3_tiles"])
@pytest.mark.parametrize("method", ["alternating", "greedy"])
def test_streaming_matches_execute_plan_bitwise(tmp_path, method, budget):
    values = bridge.to_torch(_np_values(), "cpu")
    plan = tc.plan_compression(values, _port_policy(method))
    assert len(plan.tensors) == 3
    cvalues, art = tc.execute_plan(plan, values, seed=0, device="cpu")
    out = str(tmp_path / "out")
    art2, stats = tc.execute_streaming(tc.TreeLeafSource(values), plan, out, device="cpu",
                                       budget_bytes=budget)
    _assert_streamed_equals_execute(out, plan, cvalues)
    for t in plan.tensors:
        e1, e2 = art.manifest["tensors"][t.path], art2.manifest["tensors"][t.path]
        assert e1["new_bytes"] == e2["new_bytes"]
        assert abs(e1["rel_err"] - e2["rel_err"]) < 1e-5
        assert "tile_resid" not in e2 and "leaf_index" not in e2
    np.testing.assert_array_equal(_output_leaf(out, "params/bias"), np.ones(128, np.float32))
    assert stats["leaves_done_this_run"] == 4
    # at 3 tiles a chunk: a/w's 16 tiles in 6, b/w's 12 in 4, c/w's 8 in 3
    assert stats["chunks"] == (3 if budget is None else 6 + 4 + 3)
    assert not os.path.exists(os.path.join(out, tstream.STATE_NAME))
    # the streamed checkpoint restores and validates through its manifest
    back = tc.CompressionArtifact.load(out)
    params = tckpt.restore(out, 0, {"params": back.restore_template(values)},
                           device="cpu")["params"]
    assert back.validate_params(params) == []


def test_checkpoint_source_over_a_jax_bf16_checkpoint_matches_execute(tmp_path):
    """A checkpoint JAX wrote (bf16 leaves as ml_dtypes data) streams in the
    port bit-identically to the port's execute of the same values, and to
    the in-memory source."""
    flat = _np_values()
    ck = str(tmp_path / "ckpt")
    jckpt.save(ck, 0, {"step": np.int32(0), "params": _jax(flat)})
    values = bridge.to_torch(flat, "cpu")
    plan = tc.plan_compression(values, _port_policy())
    cvalues, _ = tc.execute_plan(plan, values, seed=0, device="cpu")
    src = tc.CheckpointLeafSource(ck)
    tmpl = dict(tree_paths(src.template()))
    assert tmpl["b/w"].dtype == torch.bfloat16 and tmpl["b/w"].device.type == "meta"
    assert tc.plan_compression(src.template(), _port_policy()).to_json() == plan.to_json()
    band = src.read_band("b/w", 2, 8, 24)
    assert band.dtype == torch.bfloat16
    np.testing.assert_array_equal(band.float().numpy(), flat["b/w"][2, 8:24].astype(np.float32))
    a1, _ = tc.execute_streaming(tc.TreeLeafSource(values), plan, str(tmp_path / "o1"),
                                 device="cpu")
    a2, _ = tc.execute_streaming(src, plan, str(tmp_path / "o2"), device="cpu")
    assert json.dumps(a1.manifest, sort_keys=True) == json.dumps(a2.manifest, sort_keys=True)
    _assert_streamed_equals_execute(str(tmp_path / "o2"), plan, cvalues)
    assert _dir_digest(str(tmp_path / "o1")) == _dir_digest(str(tmp_path / "o2"))


def _sharded_checkpoint(d):
    """A step whose leaves are split over several shard files (rows and
    columns), bf16 stored as ml_dtypes data, as a sharded JAX save leaves
    it."""
    rng = np.random.default_rng(3)
    full = {"w": rng.standard_normal((3, 32, 48)).astype(np.float32),
            "h": rng.standard_normal((40, 24)).astype(np.float32).astype(ml_dtypes.bfloat16)}
    step = os.path.join(d, "step_00000000")
    os.makedirs(step)
    leaves = {}
    cuts = {"w": [((0, 3), (0, 16), (0, 48)), ((0, 3), (16, 32), (0, 20)),
                  ((0, 3), (16, 32), (20, 48))],
            "h": [((0, 25), (0, 24)), ((25, 40), (0, 24))]}
    for name, boxes in cuts.items():
        shards = []
        for i, box in enumerate(boxes):
            fname = f"params__{name}__shard0_{i}.npy"
            np.save(os.path.join(step, fname), full[name][tuple(slice(a, b) for a, b in box)])
            shards.append({"file": fname, "index": [list(b) for b in box]})
        leaves[f"params/{name}"] = {"shape": list(full[name].shape),
                                    "dtype": str(full[name].dtype), "shards": shards}
    with open(os.path.join(step, "MANIFEST.json"), "w") as f:
        json.dump({"step": 0, "leaves": leaves}, f)
    return full


@pytest.mark.parametrize("name,index", [
    ("w", (slice(1, 3), slice(10, 30), slice(5, 40))),
    ("w", (slice(0, 1), slice(16, 32), slice(None))),
    ("h", (slice(20, 30), slice(None))),
    ("h", (slice(None), slice(3, 9))),
])
def test_read_leaf_slice_equals_jax_across_shards(tmp_path, name, index):
    full = _sharded_checkpoint(str(tmp_path))
    got = tckpt.read_leaf_slice(str(tmp_path), 0, f"params/{name}", index)
    want = jckpt.read_leaf_slice(str(tmp_path), 0, f"params/{name}", index)
    assert got.shape == want.shape and got.tobytes() == np.asarray(want).tobytes()
    assert got.tobytes() == full[name][index].tobytes()
    if name == "h":
        assert got.dtype == np.dtype("V2")
    # a file-level copy keeps every shard's box
    dst = tmp_path / "copy"
    dst.mkdir()
    e = tckpt.copy_leaf_files(str(tmp_path), 0, f"params/{name}", str(dst), f"params/x/{name}")
    je = jckpt.copy_leaf_files(str(tmp_path), 0, f"params/{name}", str(dst), f"params/x/{name}")
    assert e == je


_NO_JAX_PROG = r"""
import sys
import torch
from repro_torch.compression import CheckpointLeafSource, CompressionPolicy, plan_compression
from repro_torch.compression.streaming import run_compression_job
src = CheckpointLeafSource(sys.argv[1])
plan = plan_compression(src.template(), CompressionPolicy(
    method="alternating", tile_n=16, tile_d=32, rank_ratio=0.25, min_size=1024))
art, stats = run_compression_job(src, plan, sys.argv[2], device="cpu")
assert stats["restarts"] == 0, stats
assert art.manifest["tensors"]["b/w"]["C"]["dtype"] == "bfloat16"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes"))
assert not bad, bad
print("STREAM_DONE", len(art.manifest["tensors"]))
"""


def test_a_process_without_jax_or_ml_dtypes_streams_a_bf16_checkpoint(tmp_path):
    """bfloat16 by name never reaches numpy (which cannot parse it without
    ml_dtypes): the port reads JAX's bf16 shards as raw 2-byte data."""
    flat = _np_values()
    ck = str(tmp_path / "ckpt")
    jckpt.save(ck, 0, {"params": _jax(flat)})
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _NO_JAX_PROG, ck, str(tmp_path / "out")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert "STREAM_DONE 3" in r.stdout, r.stderr[-3000:]
    values = bridge.to_torch(flat, "cpu")
    plan = tc.plan_compression(values, _port_policy())
    cvalues, _ = tc.execute_plan(plan, values, seed=0, device="cpu")
    _assert_streamed_equals_execute(str(tmp_path / "out"), plan, cvalues)


# -- resume -------------------------------------------------------------------

class FlakySource(tc.TreeLeafSource):
    """One injected crash after ``fail_after`` band reads."""

    def __init__(self, tree, fail_after):
        super().__init__(tree)
        self.reads, self.fail_after = 0, fail_after

    def read_band(self, path, g, r0, r1):
        self.reads += 1
        if self.fail_after is not None and self.reads > self.fail_after:
            self.fail_after = None
            raise OSError("injected band-read failure")
        return super().read_band(path, g, r0, r1)


def test_run_compression_job_restarts_and_resumes(tmp_path):
    values = bridge.to_torch(_np_values(), "cpu")
    plan = tc.plan_compression(values, _port_policy())
    clean, _ = tc.execute_streaming(tc.TreeLeafSource(values), plan, str(tmp_path / "clean"),
                                    device="cpu")
    # reads of a block of tile rows each: a/w in one, b/w's 3 slices in
    # three, so the 5th read crashes inside c/w, after two leaves' state saved
    art, stats = tc.run_compression_job(FlakySource(values, 4), plan, str(tmp_path / "flaky"),
                                        device="cpu", max_restarts=2)
    assert stats["restarts"] == 1 and stats["resumed_leaves"] >= 1
    assert json.dumps(art.manifest, sort_keys=True) == json.dumps(clean.manifest,
                                                                  sort_keys=True)
    assert _dir_digest(str(tmp_path / "clean")) == _dir_digest(str(tmp_path / "flaky"))


def test_resume_rejects_a_mismatched_job(tmp_path):
    values = bridge.to_torch(_np_values(), "cpu")
    plan = tc.plan_compression(values, _port_policy())
    out = str(tmp_path / "out")
    with pytest.raises(OSError):
        tc.execute_streaming(FlakySource(values, 4), plan, out, seed=9, device="cpu")
    assert os.path.exists(os.path.join(out, tstream.STATE_NAME))
    tc.execute_streaming(tc.TreeLeafSource(values), plan, str(tmp_path / "clean"), device="cpu")
    _, stats = tc.execute_streaming(tc.TreeLeafSource(values), plan, out, device="cpu")
    assert stats["resumed_leaves"] == 0
    assert _dir_digest(out) == _dir_digest(str(tmp_path / "clean"))


def test_a_job_state_left_by_jax_is_not_resumed(tmp_path):
    """The job state is keyed by the seed in the port's own encoding: a
    half-done JAX job of the same plan starts afresh in the port."""
    flat = _np_values()
    jvalues = _jax(flat)
    jplan = jc.plan_compression(jvalues, jc.CompressionPolicy(method="alternating", **_POLICY))
    out = str(tmp_path / "out")

    class JFlaky(jstream.TreeLeafSource):
        reads = 0

        def read_band(self, path, g, r0, r1):
            JFlaky.reads += 1
            if JFlaky.reads > 4:
                raise OSError("injected")
            return super().read_band(path, g, r0, r1)

    with pytest.raises(OSError):
        jstream.execute_streaming(JFlaky(jvalues), jplan, out, key=jax.random.PRNGKey(0))
    state = json.load(open(os.path.join(out, tstream.STATE_NAME)))
    assert len(state["completed"]) == 1
    values = bridge.to_torch(flat, "cpu")
    plan = tc.plan_compression(values, _port_policy())
    assert plan.to_json() == jplan.to_json()
    _, stats = tc.execute_streaming(tc.TreeLeafSource(values), plan, out, device="cpu")
    assert stats["resumed_leaves"] == 0
    tc.execute_streaming(tc.TreeLeafSource(values), plan, str(tmp_path / "clean"), device="cpu")
    assert _dir_digest(out) == _dir_digest(str(tmp_path / "clean"))


_KILL_PROG = r"""
import json, sys
import numpy as np
import torch
from repro_torch.compression import CompressionPolicy, TreeLeafSource, plan_compression
from repro_torch.compression.streaming import run_compression_job
rng = np.random.default_rng(7)
values = {
    "a": {"w": torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))},
    "b": {"w": torch.from_numpy(rng.standard_normal((3, 32, 64)).astype(np.float32))
               .to(torch.bfloat16)},
    "c": {"w": torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))},
    "bias": torch.ones(128),
}
plan = plan_compression(values, CompressionPolicy(
    method="alternating", tile_n=16, tile_d=32, rank_ratio=0.25, min_size=1024))
art, stats = run_compression_job(TreeLeafSource(values), plan, sys.argv[1], device="cpu")
print("STREAM_DONE", json.dumps(stats))
"""


def test_sigkill_and_resume_byte_identical(tmp_path):
    """A child killed by SIGKILL after two leaves (``REPRO_STREAM_KILL_AFTER``)
    leaves its job state; a rerun resumes those leaves without a restart and
    the output directory equals an uninterrupted run's byte for byte."""
    env = dict(os.environ, PYTHONPATH=str(_ROOT / "src"))
    env.pop(tstream.KILL_AFTER_ENV, None)
    clean, killed = str(tmp_path / "clean"), str(tmp_path / "killed")

    def run(out, **extra):
        return subprocess.run([sys.executable, "-c", _KILL_PROG, out], env=dict(env, **extra),
                              capture_output=True, text=True, timeout=300)

    r = run(clean)
    assert "STREAM_DONE" in r.stdout, r.stderr[-3000:]
    r1 = run(killed, **{tstream.KILL_AFTER_ENV: "2"})
    assert r1.returncode == -9, (r1.returncode, r1.stderr[-3000:])
    state = json.load(open(os.path.join(killed, tstream.STATE_NAME)))
    assert len(state["completed"]) + len(state["dense"]) == 2
    r2 = run(killed)
    assert "STREAM_DONE" in r2.stdout, r2.stderr[-3000:]
    stats = json.loads(r2.stdout.split("STREAM_DONE", 1)[1])
    assert stats["resumed_leaves"] == 2 and stats["restarts"] == 0
    assert stats["leaves_done_this_run"] == 2
    assert not os.path.exists(os.path.join(killed, tstream.STATE_NAME))
    assert _dir_digest(clean) == _dir_digest(killed)


# -- surrogate probing --------------------------------------------------------

def _probe_values():
    rng = np.random.default_rng(0)
    return {"a/w": rng.standard_normal((64, 256)).astype(np.float32),
            "b/w": rng.standard_normal((64, 128)).astype(np.float32)}


def _jax_restart_signs(key, K, restarts, N):
    """The restart signs repro's greedy draws inside (decomposition.py:143)."""
    return jnp.stack([
        jnp.sign(jax.random.normal(jax.random.fold_in(jax.random.fold_in(key, k), 17),
                                   (restarts, N)))
        for k in range(K)
    ])


def _jax_draws(jplan, key, n):
    """``surrogate_probe_from``'s sample and signs: JAX's subsample of each
    (tensor, geometry) and each sampled tile's restart signs."""
    jt = {t.path: t for t in jplan.tensors}

    def sample(t, ct):
        jct = jprobe._candidate_plan(jt[t.path], ct.tile_n, ct.tile_d, ct.K)
        return np.asarray(jstream._sample_indices(key, jt[t.path], jct, n))

    def signs(ct, idx):
        keys = jexec._tensor_keys(key, ct)[np.asarray(idx)]
        return torch.from_numpy(np.array(
            jax.vmap(lambda k: _jax_restart_signs(k, ct.K, 4, ct.tile_n))(keys)))

    return sample, signs


def test_surrogate_probe_on_jax_draws_matches_jax():
    flat = _probe_values()
    jvalues, values = _jax(flat), bridge.to_torch(flat, "cpu")
    jplan = jc.plan_compression(jvalues, jc.CompressionPolicy(method="alternating", **_POLICY))
    plan = tc.plan_compression(values, _port_policy())
    key = jax.random.PRNGKey(0)
    jsur = jstream.surrogate_probe(jstream.TreeLeafSource(jvalues), jplan, key=key,
                                   sample_tiles=8)
    sample, signs = _jax_draws(jplan, key, 8)
    tsur = tstream.surrogate_probe_from(tc.TreeLeafSource(values), plan, sample=sample,
                                        signs=signs, device="cpu", sample_tiles=8)
    assert tsur.mode == jsur.mode == "data"
    np.testing.assert_allclose(np.array(tsur.factors), np.array(jsur.factors), rtol=1e-5)
    assert all(f >= 1.0 for _, f in tsur.factors)
    for a, b in zip(tsur.probes, jsur.probes, strict=True):
        assert (a.path, a.orig_bytes, a.weight) == (b.path, b.orig_bytes, b.weight)
        for pa, pb in zip(a.points, b.points, strict=True):
            assert (pa.tile_n, pa.tile_d, pa.K, pa.bytes) == (pb.tile_n, pb.tile_d, pb.K, pb.bytes)
            assert pa.distortion == pytest.approx(pb.distortion, rel=1e-5)
    assert tsur.cis.keys() == jsur.cis.keys()
    for k, ci in tsur.cis.items():
        assert ci == pytest.approx(jsur.cis[k], rel=1e-5)


def test_svd_tails_match_jax():
    tiles = np.random.default_rng(5).standard_normal((6, 16, 32)).astype(np.float32)
    got = tstream._svd_tails(torch.from_numpy(tiles), 16)
    np.testing.assert_allclose(got, jstream._svd_tails(tiles, 16), rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got[:, 0], (tiles.astype(np.float64) ** 2).sum((1, 2)),
                               rtol=1e-9)
    assert np.all(np.diff(got, axis=1) <= 1e-9)


def test_surrogate_probe_brackets_exact_and_keeps_k_order():
    values = bridge.to_torch(_probe_values(), "cpu")
    plan = tc.plan_compression(values, _port_policy())
    sur = tc.surrogate_probe(tc.TreeLeafSource(values), plan, device="cpu", sample_tiles=8)
    exact = tprobe.probe_tensors(values, plan, device="cpu", max_probe_tiles=8)
    for ps, pe in zip(sur.probes, exact, strict=True):
        s = {(p.tile_n, p.tile_d, p.K): p.distortion for p in ps.points if not p.dense}
        e = {(p.tile_n, p.tile_d, p.K): p.distortion for p in pe.points if not p.dense}
        assert s.keys() == e.keys()
        for cand, d in s.items():
            assert 0.1 < d / e[cand] < 10.0, (ps.path, cand)
        ks = sorted(s)
        assert [s[k] for k in ks] == sorted((s[k] for k in ks), reverse=True)


def test_streaming_autotune_respects_budget_and_executes(tmp_path):
    rng = np.random.default_rng(1)
    flat = {**_probe_values(), "c/w": rng.standard_normal((32, 128)).astype(np.float32)}
    values = bridge.to_torch(flat, "cpu")
    budget = 40 * 1024
    res = tc.streaming_autotune_plan(tc.TreeLeafSource(values), _port_policy(), budget,
                                     device="cpu")
    assert res.allocation.total_bytes <= budget
    meta = res.plan.autotune
    assert meta["probe"]["mode"] == "surrogate" and meta["probe"]["source"] == "data"
    art, _ = tc.execute_streaming(tc.TreeLeafSource(values), res.plan, str(tmp_path / "o"),
                                  device="cpu")
    assert art.total_bytes() <= budget and art.manifest["autotune"] == meta
    res2 = tc.streaming_autotune_plan(tc.TreeLeafSource(values), _port_policy(), budget,
                                      device="cpu")
    assert res2.plan.to_json() == res.plan.to_json()


def test_boundary_fallback_uses_exact_probe():
    values = bridge.to_torch({k: v for k, v in _probe_values().items()}, "cpu")
    plan = tc.plan_compression(values, _port_policy())
    sur = tc.surrogate_probe(tc.TreeLeafSource(values), plan, device="cpu", sample_tiles=2)
    from repro_torch.compression.autotune import allocate_budget

    alloc = allocate_budget(sur.probes, 10**12, engine="greedy")
    budget = (sum(min(p.bytes for p in pr.points) for pr in sur.probes) + alloc.total_bytes) // 2
    res = tc.streaming_autotune_plan(tc.TreeLeafSource(values), _port_policy(), budget,
                                     device="cpu", sample_tiles=2)
    meta = res.plan.autotune["probe"]
    assert meta["boundary"] and meta["exact_fallback"] == meta["boundary"]
    assert res.allocation.total_bytes <= budget


def test_metadata_only_template_plans_and_is_refused_by_execute(tmp_path):
    from repro_torch.configs import get_config, reduced_for_smoke
    from repro_torch.models import init_model
    from repro_torch.models.params import split

    cfg = reduced_for_smoke(get_config("qwen3-32b"))
    meta = split(init_model(cfg, seed=0, device="meta"))[0]
    real = split(init_model(cfg, seed=0, device="cpu"))[0]
    pol = tc.CompressionPolicy(tile_n=16, tile_d=32, rank_ratio=0.25, min_size=4096)
    assert [(p, tuple(v.shape), v.dtype) for p, v in tree_paths(meta)] == \
        [(p, tuple(v.shape), v.dtype) for p, v in tree_paths(real)]
    src = tc.TreeLeafSource(meta)
    assert not src.data_available and src.describe() == "tree:metadata-only"
    plan = tc.plan_compression(src.template(), pol)
    assert plan.diff(tc.plan_compression(real, pol)) == []
    res = tc.streaming_autotune_plan(src, pol, int(0.75 * plan.total_bytes()), device="cpu",
                                     k_fractions=(0.125, 0.25), engine="qubo")
    assert res.plan.autotune["probe"]["source"] == "synthetic"
    assert res.plan.autotune["probe"]["exact_fallback"] == []
    assert res.allocation.total_bytes <= int(0.75 * plan.total_bytes())
    with pytest.raises(ValueError, match="metadata-only"):
        tc.execute_streaming(src, plan, str(tmp_path / "out"))
    with pytest.raises(ValueError, match="metadata-only"):
        src.read_band(plan.tensors[0].path, 0, 0, 16)
    assert not (tmp_path / "out").exists()


def test_streaming_cli_passes_the_references_default_k_grid(monkeypatch, capsys):
    """``--streaming --budget-mb`` calls the autotuner without ``k_fractions``,
    as the reference's CLI does: at tile_n 32 its grid reaches K = 28, in both
    packages (a known difference from what alternating can enumerate)."""
    import repro_torch.launch.compress as lc

    seen = {}

    def fake(source, policy, budget, **kw):
        seen.update(kw, source=source.describe())
        raise SystemExit(0)

    monkeypatch.setattr(lc, "resolve_device", lambda d=None: torch.device("cpu"))
    monkeypatch.setattr(tstream, "streaming_autotune_plan", fake)
    with pytest.raises(SystemExit):
        lc.main(["--arch", "qwen3-32b", "--reduced", "--streaming", "--metadata-only",
                 "--plan-only", "--budget-mb", "1", "--engine", "qubo"])
    assert seen["source"] == "tree:metadata-only" and "k_fractions" not in seen
    jt = jc.plan_compression({"l": {"w": jnp.zeros((64, 128))}},
                             jc.CompressionPolicy(min_size=1)).tensors[0]
    tt = tc.plan_compression({"l": {"w": torch.zeros(64, 128)}},
                             tc.CompressionPolicy(min_size=1)).tensors[0]
    assert tt.tile_n == jt.tile_n == 32
    assert [c.K for c in tprobe.candidate_settings(tt)] == \
        [c.K for c in jprobe.candidate_settings(jt)] == [4, 8, 12, 16, 20, 24, 28]


# -- the CLI's flag checks ------------------------------------------------------

@pytest.mark.parametrize("flags,message", [
    (["--delta-from", "x", "--streaming"], "do not apply with --delta-from"),
    (["--delta-from", "x", "--budget-mb", "1"], "do not apply with --delta-from"),
    (["--delta-from", "x", "--autotune-kernels"], "do not apply with --delta-from"),
    (["--delta-threshold", "1.1"], "only applies with --delta-from"),
    (["--metadata-only"], "only apply with --streaming"),
    (["--sample-tiles", "4"], "only apply with --streaming"),
    (["--streaming", "--budget-mb", "1", "--calibrate"], "does not compose with --streaming"),
    (["--streaming", "--budget-mb", "1", "--probe-tiles", "4"], "use --sample-tiles"),
    (["--streaming", "--metadata-only"], "add --plan-only"),
    (["--streaming", "--metadata-only", "--plan-only", "--ckpt-dir", "x"],
     "mutually exclusive sources"),
    (["--streaming", "--budget-mb", "1", "--objective", "eval-loss"],
     "does not compose with --streaming"),
])
def test_compress_cli_delta_and_streaming_flag_checks(flags, message, capsys):
    from repro_torch.launch.compress import main

    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen3-32b", "--reduced", *flags])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


# -- fault tolerance, as tests/test_fault_paths.py holds the reference's ----------

@pytest.mark.parametrize("exc", [SystemExit, KeyboardInterrupt])
def test_run_with_restarts_reraises_deliberate_shutdown(exc):
    calls = []

    def quitting(attempt):
        calls.append(attempt)
        raise exc()

    with pytest.raises(exc):
        run_with_restarts(quitting, max_restarts=3)
    assert calls == [0]


def test_run_with_restarts_retries_then_gives_up():
    calls, seen = [], []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise RuntimeError(f"boom {attempt}")

    assert run_with_restarts(flaky, max_restarts=3,
                             on_failure=lambda a, e: seen.append((a, str(e)))) == 2
    assert calls == [0, 1, 2] and seen == [(0, "boom 0"), (1, "boom 1")]
    with pytest.raises(RuntimeError, match="boom"):
        run_with_restarts(lambda a: (_ for _ in ()).throw(RuntimeError("boom")), max_restarts=1)


def test_step_timer_and_heartbeat(tmp_path):
    t = StepTimer()
    with pytest.raises(RuntimeError, match="before start"):
        t.stop()
    t.start()
    assert t.stop() >= 0.0 and not t.is_straggler(10.0) and t.is_straggler(0.0)
    path = str(tmp_path / "hb.json")
    assert not Heartbeat.is_alive(path)
    hb = Heartbeat(path, interval_s=3600.0)
    hb.beat(3, {"phase": "x"})
    hb.beat(4)                      # inside the interval: not written
    with open(path) as f:
        assert json.load(f)["step"] == 3
    assert Heartbeat.is_alive(path) and not Heartbeat.is_alive(path, timeout_s=-1.0)
