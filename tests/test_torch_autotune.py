"""The port's kernel schedule autotuner (``repro_torch.kernels.autotune``)
against the JAX package's: keys, heuristics, resolution and its log, the
``repro.kernel_schedules/v1`` table, timed search, and tables crossing
between the two packages into a served Engine."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.kernels import autotune as jat
from repro.models import init_model as j_init_model
from repro.models.params import split as j_split
from repro_torch import bridge
from repro_torch.compression import CompressionPolicy, execute_plan, plan_compression
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.core import decomposition as tdec
from repro_torch.kernels import autotune as at
from repro_torch.kernels import bitlinear as tbl
from repro_torch.kernels import ops as tops
from repro_torch.kernels.autotune import Schedule
from repro_torch.models import init_model
from repro_torch.models.params import split
from repro_torch.serving import Engine

torch.set_num_threads(1)

H100 = "NVIDIA H100 80GB HBM3"
BUDGET = 232448                  # an H100's opt-in shared memory per block


@pytest.fixture(autouse=True)
def _clean_state():
    """The caches, memo and logs of both packages are process-global."""
    for m in (at, jat):
        m.clear_schedules()
        m.clear_log()
    yield
    for m in (at, jat):
        m.clear_schedules()
        m.clear_log()
    tops.disable_kernels()


def _operands(seed, nr, nc, tn, K, td, T, E=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    lead = (E,) if E else ()
    M = np.where(rng.random(lead + (nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    mp = tdec.pack_bits(torch.from_numpy(M))
    C = torch.from_numpy((rng.standard_normal(lead + (nr, nc, K, td)) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(lead + (T, nr * tn)).astype(np.float32))
    return x.to(dtype), mp, C.to(dtype)


# ---------------------------------------------------------------------------
# keys, schedules, heuristics
# ---------------------------------------------------------------------------


def test_schedule_dict_roundtrip_matches_jax():
    s = Schedule(mode="grid", math="bitplane", block_t=64, r_chunk=4)
    assert Schedule.from_dict(s.to_dict()) == s
    assert s.to_dict() == jat.Schedule(**s.to_dict()).to_dict()
    assert s.kwargs() == jat.Schedule(**s.to_dict()).kwargs()
    assert Schedule.from_dict({"mode": "jnp"}) == Schedule(mode="jnp")


def test_t_bucket_matches_jax():
    Ts = list(range(1, 70)) + [127, 128, 129, 511, 512, 513, 4096, 100_000]
    assert [at.t_bucket(t) for t in Ts] == [jat.t_bucket(t) for t in Ts]


@pytest.mark.parametrize("kind,E", [("bitlinear", 0), ("bitlinear_grouped", 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("T", [1, 3, 4, 13, 512, 4096])
def test_schedule_key_is_byte_identical_to_jax(kind, E, dtype, T):
    sig = dict(n_r=160, n_c=200, tn=32, K=4, td=128, T=T, E=E)
    # the CPU's key: device "cpu", mode "interpret", in both packages
    assert at.schedule_key(kind, dtype=getattr(torch, dtype), **sig) == \
        jat.schedule_key(kind, dtype=getattr(jax.numpy, dtype), **sig)
    assert at.schedule_key(kind, dtype=dtype, **sig) == jat.schedule_key(kind, dtype=dtype, **sig)
    assert at.device_kind() == jat.device_kind() == "cpu"
    assert at.pallas_mode() == jat.pallas_mode() == "interpret"
    # the card's: its name and "compiled", given explicitly to both
    card = dict(device=H100, mode="compiled")
    assert at.schedule_key(kind, dtype=getattr(torch, dtype), **sig, **card) == \
        jat.schedule_key(kind, dtype=dtype, **sig, **card)


def test_heuristic_on_the_cpu_is_jax_s_interpret_default():
    sig = dict(n_r=2, n_c=2, tn=16, kb=1, K=4, td=32, T=4, x_itemsize=4, c_itemsize=4)
    assert at.heuristic("bitlinear", interpret=True, **sig) == \
        Schedule(**jat.heuristic("bitlinear", interpret=True, **sig).to_dict()) == \
        Schedule("jnp", "dot")


@pytest.fixture
def layout(monkeypatch):
    """A block's shared memory comes from the built CUDA library, which the
    CPU has not; here a stand-in with the layout's growing terms: decode's
    eight stages of a 4 KiB target (one tile with its T rows of x at least)
    and its four warps' T rows of 128-column partial sums, which grow with T
    and not with n_r; stream's layout as its Python mirror computes it
    (``bitlinear.stream_geometry``: a ring of r_chunk-tile stages, at most
    32 rows of x).  The real layout is held on the card
    (``tests/test_torch_cuda.py``)."""
    def smem_bytes(mode, *, T, n_r, tn, K, td, x_itemsize, c_itemsize, r_chunk=1):
        if mode == "decode":
            return 8 * max(4096, K * td * c_itemsize + T * tn * x_itemsize) + 4 * T * 128 * 4
        if mode == "stream":
            return tbl.stream_geometry(T=T, tn=tn, K=K, td=td, x_itemsize=x_itemsize,
                                       c_itemsize=c_itemsize, r_chunk=r_chunk)["smem"]
        return 0
    monkeypatch.setattr(tbl, "smem_bytes", smem_bytes)


def test_heuristic_on_the_card_uses_the_shared_memory_budget(layout):
    """The card's cost model: decode (K3 and K4) at decode-sized T while its
    block fits the shared-memory budget, else the grid."""
    gate = dict(n_r=160, n_c=200, tn=32, kb=1, K=4, td=128, x_itemsize=2, c_itemsize=2,
                interpret=False, smem_budget=BUDGET)
    assert at.heuristic("bitlinear", T=4, **gate) == Schedule("decode", "bitplane")
    assert at.heuristic("bitlinear_grouped", T=4, **gate) == Schedule("decode", "bitplane")
    assert at.heuristic("bitlinear", T=4096, **gate) == Schedule("grid", "unpack", 64, 1)
    assert at.heuristic("bitlinear_grouped", T=1280, **gate).mode == "grid"
    # the measured cutoff: decode up to 4 rows
    assert at.heuristic("bitlinear", T=1, **gate).mode == "decode"
    assert at.heuristic("bitlinear_grouped", T=1, **gate).mode == "decode"
    assert at.heuristic("bitlinear", T=5, **gate).mode == "grid"
    assert at.heuristic("bitlinear_grouped", T=5, **gate).mode == "grid"
    # over the budget: the grid, whatever T
    tight = dict(gate, smem_budget=4096)
    assert at.heuristic("bitlinear", T=4, **tight).mode == "grid"
    assert at.heuristic("bitlinear_grouped", T=4, **tight).mode == "grid"
    # down (d_in 25,600): the decode block does not grow with d_in, so it
    # decodes like gate; above the cutoff the grid
    down = dict(gate, n_r=800, n_c=40)
    assert at.heuristic("bitlinear", T=4, **down).mode == "decode"
    assert at.heuristic("bitlinear_grouped", T=4, **down).mode == "decode"
    assert at.heuristic("bitlinear_grouped", T=16, **down).mode == "grid"


def test_candidates_on_the_card_hold_no_plain_version_and_no_duplicates(layout):
    sig = dict(n_r=48, n_c=4, tn=32, kb=1, K=4, td=128, x_itemsize=2, c_itemsize=2,
               smem_budget=BUDGET)
    for kind in ("bitlinear", "bitlinear_grouped"):
        for T in (1, 4, 16, 512):
            cands = at.candidates(kind, T=T, **sig)
            assert cands and all(s.mode != "jnp" for s in cands)
            assert len(set(cands)) == len(cands)
            assert all(48 % s.r_chunk == 0 for s in cands)
            assert any(s.mode == "stream" for s in cands) == (kind == "bitlinear")
            assert any(s.mode == "decode" for s in cands) == (T <= 16)
            assert {s.math for s in cands} == {"unpack", "bitplane"}
    # block_t past T (rounded up to 8) makes the same launch: one value
    assert {s.block_t for s in at.candidates("bitlinear", T=72, **sig)
            if s.mode == "grid"} == {64, 72}
    # on the CPU every mode is the plain version: only its formulations
    assert {s.mode for s in at.candidates("bitlinear", T=4, interpret=True, **sig)} == {"jnp"}


# ---------------------------------------------------------------------------
# resolve: cache vs heuristic, memo and log
# ---------------------------------------------------------------------------


def test_resolve_heuristic_then_cache_hit():
    sig = dict(n_r=2, n_c=2, tn=16, kb=1, K=4, td=32, T=3, dtype=torch.float32)
    s0 = at.resolve("bitlinear", **sig)
    assert at.last_resolutions()[-1] == {
        "key": at.schedule_key("bitlinear", n_r=2, n_c=2, tn=16, K=4, td=32, T=3,
                               dtype=torch.float32),
        "schedule": s0.to_dict(), "source": "heuristic"}
    key = at.schedule_key("bitlinear", n_r=2, n_c=2, tn=16, K=4, td=32, T=3,
                          dtype=torch.float32)
    tuned = Schedule(mode="grid", math="bitplane", block_t=64, r_chunk=2)
    assert at.load_schedules({"format": at.SCHEDULES_FORMAT,
                              "entries": {key: tuned.to_dict()}}) == 1
    assert at.resolve("bitlinear", **sig) == tuned
    assert at.last_resolutions()[-1]["source"] == "cache"


def test_fused_adapters_resolve_once_per_signature():
    """PyTorch runs eagerly: the adapters resolve on every call through a
    memo, and the log gets one entry per new signature (JAX's trace-time
    behaviour); installing a table clears the memo."""
    x, mp, C = _operands(0, 2, 2, 16, 4, 32, T=5)
    w = {"m_packed": mp, "C": C}
    want = tops.apply_compressed_fused(x, w, mode="jnp")
    for _ in range(3):
        torch.testing.assert_close(tops.apply_compressed_fused(x, w), want)
    tops.apply_compressed_fused(x[:2], w)
    log = at.last_resolutions()
    assert [r["source"] for r in log] == ["heuristic", "heuristic"]
    assert len({r["key"] for r in log}) == 2
    key = log[0]["key"]
    at.load_schedules({"format": at.SCHEDULES_FORMAT,
                       "entries": {key: Schedule("jnp", "bitplane").to_dict()}})
    torch.testing.assert_close(tops.apply_compressed_fused(x, w), want, rtol=1e-5, atol=1e-5)
    assert at.last_resolutions()[-1] == {"key": key, "source": "cache",
                                         "schedule": Schedule("jnp", "bitplane").to_dict()}
    # grouped: E is part of the key; an explicit schedule bypasses resolution
    xg, mpg, Cg = _operands(1, 1, 2, 8, 3, 16, T=2, E=3)
    tops.apply_compressed_grouped_fused(xg, {"m_packed": mpg, "C": Cg})
    assert at.last_resolutions()[-1]["key"].split("|")[1::4] == ["bitlinear_grouped", "E3"]
    n = len(at.last_resolutions())
    tops.apply_compressed_grouped_fused(xg, {"m_packed": mpg, "C": Cg},
                                        schedule=Schedule("decode", "bitplane"))
    assert len(at.last_resolutions()) == n


def test_load_schedules_refuses_unknown_format_and_the_plain_version_on_a_card():
    with pytest.raises(ValueError, match="format"):
        at.load_schedules({"format": "bogus/v9", "entries": {}})
    key = at.schedule_key("bitlinear", n_r=2, n_c=2, tn=16, K=4, td=32, T=4,
                          dtype=torch.bfloat16, device=H100, mode="compiled")
    with pytest.raises(ValueError, match="jnp"):
        at.load_schedules({"format": at.SCHEDULES_FORMAT,
                           "entries": {key: Schedule("jnp", "dot").to_dict()}})
    assert at.export_schedules()["entries"] == {}
    # a kernel schedule for the card, and the plain version on the CPU, load
    cpu_key = at.schedule_key("bitlinear", n_r=2, n_c=2, tn=16, K=4, td=32, T=4,
                              dtype=torch.bfloat16)
    assert at.load_schedules({"format": at.SCHEDULES_FORMAT, "entries": {
        key: Schedule("decode", "bitplane").to_dict(),
        cpu_key: Schedule("jnp", "dot").to_dict()}}) == 2


def test_export_load_roundtrip():
    key = at.schedule_key("bitlinear_grouped", n_r=1, n_c=1, tn=8, K=3, td=16, T=1,
                          dtype=torch.bfloat16, E=4)
    at.load_schedules({"format": at.SCHEDULES_FORMAT,
                       "entries": {key: Schedule("decode", "bitplane").to_dict()}})
    table = at.export_schedules()
    assert table["format"] == at.SCHEDULES_FORMAT
    assert table["tuned_on"] == {"device": "cpu", "pallas_mode": "interpret"}
    at.clear_schedules()
    assert at.load_schedules(table) == 1
    sig = dict(n_r=1, n_c=1, tn=8, kb=1, K=3, td=16, T=1, dtype=torch.bfloat16, E=4)
    assert at.resolve("bitlinear_grouped", **sig) == Schedule("decode", "bitplane")


# ---------------------------------------------------------------------------
# timed search
# ---------------------------------------------------------------------------


def test_tune_on_explicit_schedules():
    x, mp, C = _operands(2, 2, 2, 16, 4, 32, T=4)
    scheds = [Schedule("jnp", "dot"), Schedule("grid", "bitplane", 64, 2),
              Schedule("stream", "unpack")]
    best, trials = at.tune(x, mp, C, repeats=1, iters=2, schedules=scheds)
    assert [t["schedule"] for t in trials] == [s.to_dict() for s in scheds]
    timed = [t for t in trials if "seconds" in t]
    assert best.to_dict() == min(timed, key=lambda t: t["seconds"])["schedule"]
    best, _ = at.tune(x, mp, C, repeats=1, iters=2)          # the CPU's candidates
    assert best.mode == "jnp"


def test_tune_grouped_routes_by_ndim():
    x, mp, C = _operands(3, 1, 2, 8, 3, 16, T=2, E=3)
    best, trials = at.tune(x, mp, C, repeats=1, iters=2,
                           schedules=[Schedule("jnp", "dot"), Schedule("stream", "unpack"),
                                      Schedule("jnp", "bitplane")])
    assert best.mode == "jnp"
    assert all(t["schedule"]["mode"] != "stream" for t in trials)


# ---------------------------------------------------------------------------
# tables across the two packages
# ---------------------------------------------------------------------------

BATCH, PROMPT = 2, 8
JNP_SCHEDULES = [("jnp", "dot"), ("jnp", "unpack")]


@pytest.fixture(scope="module")
def qwen():
    """Reduced qwen3-32b in float32, compressed by JAX, weights carried to
    the port."""
    jcfg = dataclasses.replace(j_reduced(j_get_config("qwen3-32b")), dtype="float32")
    tcfg = dataclasses.replace(reduced_for_smoke(get_config("qwen3-32b")), dtype="float32")
    jvals = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0]
    policy = jc.CompressionPolicy(method="alternating", tile_n=16, tile_d=32, rank_ratio=0.5,
                                  min_size=4096)
    jcv, jart = jc.execute_plan(jc.plan_compression(jvals, policy), jvals,
                                key=jax.random.PRNGKey(0))
    from repro.compression.plan import tree_paths

    tcv = bridge.to_torch({p: np.asarray(v) for p, v in tree_paths(jcv)}, "cpu")
    return tcfg, tcv, jart


def _serve(tcfg, tcv, manifest):
    eng = Engine(tcfg, tcv, max_len=PROMPT + 3, batch=BATCH, artifact=manifest)
    at.clear_log()
    prompts = torch.from_numpy(np.random.default_rng(0).integers(0, tcfg.vocab_size,
                                                                 (BATCH, PROMPT)))
    eng.generate(prompts, 3)
    return eng, at.last_resolutions()


def test_jax_tuned_table_resolves_from_cache_in_the_port_engine(qwen):
    """A table JAX's tune_artifact builds on the CPU serves the port's
    Engine: every resolution of prefill and decode comes from the cache
    and its key is in the table."""
    tcfg, tcv, jart = qwen
    manifest = copy.deepcopy(jart.manifest)
    table = jat.tune_artifact(manifest, T_values=(BATCH, BATCH * PROMPT), repeats=1, iters=1,
                              schedules=[jat.Schedule(*s) for s in JNP_SCHEDULES])
    assert manifest["kernel_schedules"] is table and table["entries"]
    eng, log = _serve(tcfg, tcv, manifest)
    assert eng.kernel_schedules == eng.compression["kernel_schedules"] == len(table["entries"])
    assert log and all(r["source"] == "cache" for r in log), log
    assert {r["key"] for r in log} <= set(table["entries"])


def test_engine_without_a_table_uses_the_heuristic(qwen):
    tcfg, tcv, jart = qwen
    eng, log = _serve(tcfg, tcv, copy.deepcopy(jart.manifest))
    assert eng.kernel_schedules == 0 and "kernel_schedules" not in eng.compression
    assert log and all(r["source"] == "heuristic" for r in log)


def test_port_tuned_table_loads_in_jax():
    """The port's tune_artifact on a port-compressed manifest; JAX's
    load_schedules takes the table and resolves the same signatures from
    its cache."""
    cfg = dataclasses.replace(reduced_for_smoke(get_config("qwen3-32b")), dtype="float32")
    values, _ = split(init_model(cfg, seed=0, device="cpu"))
    policy = CompressionPolicy(method="greedy", tile_n=16, tile_d=32, rank_ratio=0.5,
                               min_size=4096)
    _, art = execute_plan(plan_compression(values, policy), values, device="cpu")
    table = at.tune_artifact(art, T_values=(1, 4), repeats=1, iters=1, device="cpu",
                             schedules=[Schedule(*s) for s in JNP_SCHEDULES])
    assert art.manifest["kernel_schedules"] is table
    assert table["tuned_on"] == {"device": "cpu", "pallas_mode": "interpret"}
    assert jat.load_schedules(table) == len(table["entries"])
    for key, entry in table["entries"].items():
        kind, _, _, geo, E, T, dtype = key.split("|")[1:]
        n_r, rest = geo[1:].split("c")
        n_c, rest = rest.split("n")
        tn, rest = rest.split("k")
        K, td = rest.split("d")
        s = jat.resolve(kind, n_r=int(n_r), n_c=int(n_c), tn=int(tn), kb=(int(K) + 7) // 8,
                        K=int(K), td=int(td), T=int(T[1:]), dtype=dtype, E=int(E[1:]))
        assert s.to_dict() == entry
    assert all(r["source"] == "cache" for r in jat.last_resolutions())


def test_tune_artifact_needs_a_device_on_the_cpu_only_host(qwen):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        at.tune_artifact(copy.deepcopy(qwen[2].manifest))
