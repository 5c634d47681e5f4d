"""The port's continuous-batching tier (serving/kv_pages.py, scheduler.py,
frontend.py, loadgen.py) against the JAX package's on reduced configs,
float32, the same weights carried across with ``bridge``."""

import dataclasses
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compression as jc
from repro.compression.plan import tree_paths as j_tree_paths
from repro.configs import get_config as j_get_config
from repro.configs import reduced_for_smoke as j_reduced
from repro.models import init_model as j_init_model
from repro.models.params import split as j_split
from repro.serving import Engine as JEngine
from repro.serving import PagePool as JPagePool
from repro.serving import Scheduler as JScheduler
from repro.serving.loadgen import poisson_arrivals as j_poisson_arrivals
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_for_smoke
from repro_torch.kernels import ops as tops
from repro_torch.models import init_cache
from repro_torch.serving import (
    Engine,
    PagePool,
    Scheduler,
    ServeFrontend,
    poisson_arrivals,
    run_load,
)
from repro_torch.serving.kv_pages import tree_flatten

torch.set_num_threads(1)

EOS_NEVER = 500          # > reduced vocab (257): generation never stops early


@pytest.fixture(autouse=True)
def _no_port_hooks():
    yield
    tops.disable_kernels()


def _cfgs(arch, **over):
    return (dataclasses.replace(j_reduced(j_get_config(arch)), **over),
            dataclasses.replace(reduced_for_smoke(get_config(arch)), **over))


@pytest.fixture(scope="module")
def models():
    """models(arch, compressed=False) -> namespace of both packages' configs
    and the same weights (JAX's, carried to the port), built once."""
    cache = {}

    def get(arch, compressed=False):
        if (arch, compressed) not in cache:
            jcfg, tcfg = _cfgs(arch)
            jvals = j_split(j_init_model(jax.random.PRNGKey(0), jcfg))[0]
            art = None
            if compressed:
                policy = jc.CompressionPolicy(method="alternating", tile_n=16, tile_d=32,
                                              rank_ratio=0.5, min_size=4096)
                jvals, art = jc.execute_plan(jc.plan_compression(jvals, policy), jvals,
                                             key=jax.random.PRNGKey(0))
            tvals = bridge.to_torch({p: np.asarray(v) for p, v in j_tree_paths(jvals)}, "cpu")
            cache[arch, compressed] = types.SimpleNamespace(
                jcfg=jcfg, tcfg=tcfg, jvals=jvals, tvals=tvals, art=art)
        return cache[arch, compressed]

    return get


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=L).astype(np.int32) for L in lengths]


def _jax_scheduler(m, max_len, **kw):
    eng = JEngine(m.jcfg, m.jvals, max_len=max_len, batch=1, eos_id=EOS_NEVER,
                  artifact=m.art, use_fused_bitlinear=False if m.art is not None else None)
    return JScheduler(eng, max_len=max_len, **kw)


def _port_scheduler(m, max_len, **kw):
    eng = Engine(m.tcfg, m.tvals, max_len=max_len, batch=1, eos_id=EOS_NEVER,
                 artifact=m.art.manifest if m.art is not None else None)
    return Scheduler(eng, max_len=max_len, device="cpu", **kw)


# ---------------------------------------------------------------------------
# load generator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,qps,seed", [(16, 4.0, 1), (0, 4.0, 0), (100, 0.5, 7), (3, 64.0, 2)])
def test_poisson_arrivals_bit_identical_to_jax(n, qps, seed):
    got = poisson_arrivals(n, qps, seed=seed)
    np.testing.assert_array_equal(got, j_poisson_arrivals(n, qps, seed=seed))
    assert got.shape == (n,) and np.all(np.diff(got) >= 0)


def test_poisson_arrivals_validates_rate():
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="qps must be > 0"):
            poisson_arrivals(16, qps=bad)
    with pytest.raises(ValueError, match="n must be >= 0"):
        poisson_arrivals(-1, qps=1.0)


# ---------------------------------------------------------------------------
# page pool
# ---------------------------------------------------------------------------

def test_page_pool_alloc_free_invariants_as_jax(models):
    m = models("qwen3-32b")
    pools = (PagePool(m.tcfg, num_slots=2, max_len=32, page_size=8, num_pages=5, device="cpu"),
             JPagePool(m.jcfg, num_slots=2, max_len=32, page_size=8, num_pages=5))
    for pool in pools:
        assert pool.num_free == 4  # page 0 is scratch
        assert pool.pages_needed(1) == 1 and pool.pages_needed(8) == 1
        assert pool.pages_needed(9) == 2
    steps = [("ensure", 0, 9, True), ("ensure", 0, 9, True), ("ensure", 1, 16, True),
             ("ensure", 0, 17, False), ("release", 1), ("ensure", 0, 32, True)]
    for op in steps:
        for pool in pools:
            if op[0] == "ensure":
                assert pool.ensure(op[1], op[2]) is op[3]
            else:
                pool.release(op[1])
        np.testing.assert_array_equal(pools[0].table, pools[1].table)
        assert pools[0].num_free == pools[1].num_free
        assert [pools[0].slot_pages(s) for s in (0, 1)] == [pools[1].slot_pages(s) for s in (0, 1)]
    assert pools[0].pages_high_water == pools[1].pages_high_water == 4
    assert (pools[0].table[1] == 0).all()  # freed slot points at scratch
    with pytest.raises(ValueError):
        pools[0].ensure(0, 33)             # beyond max_len
    with pytest.raises(ValueError, match="multiple of page_size"):
        PagePool(m.tcfg, num_slots=2, max_len=30, page_size=8, device="cpu")


# (arch, config overrides, max_len, paged leaves, resident leaves): zamba2's
# shared-block KV is paged while max_len fits its window of 32, a resident
# ring past it; llama4 at 3 layers has an ungrouped attention remainder
VIEW_CASES = [("qwen3-32b", {}, 32, 2, 0), ("zamba2-1.2b", {}, 32, 2, 12),
              ("zamba2-1.2b", {}, 64, 0, 14), ("mamba2-130m", {}, 32, 0, 2),
              ("llama4-maverick-400b-a17b", {"num_layers": 3}, 32, 6, 0)]


def _j_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(tuple(str(p.key) for p in path), leaf) for path, leaf in flat]


def _random_like(rng, shapes_dtypes):
    return [rng.standard_normal(s).astype(d) for s, d in shapes_dtypes]


def _assert_trees_equal(tview, jview):
    t, j = tree_flatten(tview), _j_leaves(jview)
    assert [p for p, _ in t] == [p for p, _ in j]
    for (path, a), (_, b) in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(path))


@pytest.mark.parametrize("arch,over,max_len,n_paged,n_resident", VIEW_CASES,
                         ids=lambda v: str(v) if not isinstance(v, dict) else "")
def test_page_pool_views_exactly_jax(arch, over, max_len, n_paged, n_resident):
    """The same pools, resident state and tables through both packages'
    gather, gather_slot, scatter_decode, scatter_prefill, update_resident and
    update_resident_slot give the same bits (the scratch page 0 apart: the
    writes of masked slots and pad tokens collide there in either order)."""
    jcfg, tcfg = _cfgs(arch, **over)
    B, page = 3, 8
    tp = PagePool(tcfg, num_slots=B, max_len=max_len, page_size=page, device="cpu")
    jp = JPagePool(jcfg, num_slots=B, max_len=max_len, page_size=page)
    assert (sum(tp._paged), len(tp._paged) - sum(tp._paged)) == (n_paged, n_resident)
    assert tp._paged == jp._paged and tp._lead == jp._lead

    # the view template is init_cache's tree and JAX's
    tmpl = tree_flatten(tp.view_template())
    want = tree_flatten(init_cache(tcfg, B, max_len, device="meta"))
    jt = _j_leaves(jp.view_template())
    assert [p for p, _ in tmpl] == [p for p, _ in want] == [p for p, _ in jt]
    for (_, a), (_, b), (_, c) in zip(tmpl, want, jt):
        assert tuple(a.shape) == tuple(b.shape) == tuple(c.shape) and a.dtype == b.dtype

    rng = np.random.default_rng(3)
    for k in jp.pools:
        a = rng.standard_normal(jp.pools[k].shape).astype(np.float32)
        jp.pools[k], tp.pools[k] = jnp.asarray(a), torch.from_numpy(a.copy())
    for i, r in enumerate(jp.resident):
        if r is not None:
            a = rng.standard_normal(r.shape).astype(np.float32)
            jp.resident[i], tp.resident[i] = jnp.asarray(a), torch.from_numpy(a.copy())
    for slot, n in ((0, 12), (2, max_len - 3)):
        assert tp.ensure(slot, n) and jp.ensure(slot, n)
    np.testing.assert_array_equal(tp.table, jp.table)
    tables = torch.from_numpy(tp.table.astype(np.int64))

    def clone_pools():
        return {k: v.clone() for k, v in tp.pools.items()}

    def clone_resident():
        return [None if r is None else r.clone() for r in tp.resident]

    _assert_trees_equal(tp.gather(tp.pools, tp.resident, tables),
                        jp.gather(jp.pools, jp.resident, jp.device_table()))
    _assert_trees_equal(tp.gather_slot(tp.pools, tp.resident, tables[2], 2),
                        jp.gather_slot(jp.pools, jp.resident, jnp.asarray(jp.table[2]),
                                       jnp.int32(2)))

    shapes = [(tuple(leaf.shape), np.float32) for _, leaf in jt]
    new = _random_like(rng, shapes)
    tnew = tp.view_template()
    tnew = _fill(tnew, new)
    jnew = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp.view_template()),
                                        [jnp.asarray(a) for a in new])
    pos = np.array([11, 0, max_len - 4], np.int32)
    active = np.array([True, False, True])
    got = tp.scatter_decode(clone_pools(), tnew, tables, torch.from_numpy(pos.astype(np.int64)),
                            torch.from_numpy(active))
    want = jp.scatter_decode(jp.pools, jnew, jp.device_table(), jnp.asarray(pos),
                             jnp.asarray(active))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy()[1:], np.asarray(want[k])[1:])
    got = tp.update_resident(clone_resident(), tnew, torch.from_numpy(active))
    want = jp.update_resident(jp.resident, jnew, jnp.asarray(active))
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    one = [(s[:lead] + (1,) + s[lead + 1:], d)
           for (s, d), lead in zip(shapes, jp._lead)]
    new1 = _random_like(rng, one)
    tnew1 = _fill(init_cache(tcfg, 1, max_len, device="cpu"), new1)
    jnew1 = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp.view_template()),
                                         [jnp.asarray(a) for a in new1])
    start, real, chunk = 8, 5, 8           # three pad tokens go to the scratch page
    got = tp.scatter_prefill(clone_pools(), tnew1, tables[2], start, real, chunk)
    want = jp.scatter_prefill(jp.pools, jnew1, jnp.asarray(jp.table[2]), jnp.int32(start),
                              jnp.int32(real), chunk)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy()[1:], np.asarray(want[k])[1:])
    got = tp.update_resident_slot(clone_resident(), tnew1, 1)
    want = jp.update_resident_slot(jp.resident, jnew1, jnp.int32(1))
    for a, b in zip(got, want):
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _fill(tree, arrays):
    """The port's tree with its leaves (in flattened order) set to ``arrays``."""
    from repro_torch.serving.kv_pages import tree_unflatten

    paths = [p for p, _ in tree_flatten(tree)]
    return tree_unflatten(paths, [torch.from_numpy(a.copy()) for a in arrays])


def test_page_pool_gather_hands_out_clones_and_gather_slot_views():
    """The resident-state rule of the port's in-place model: a forward on
    ``gather``'s tree cannot touch the pool's resident rows, while a
    forward on ``gather_slot``'s writes its slot's rows and no other."""
    _, tcfg = _cfgs("mamba2-130m")
    pool = PagePool(tcfg, num_slots=2, max_len=32, page_size=8, device="cpu")
    view = pool.gather(pool.pools, pool.resident, pool.device_table())
    for _, leaf in tree_flatten(view):
        leaf.fill_(1.0)
    assert all(float(r.abs().max()) == 0.0 for r in pool.resident)
    view = pool.gather_slot(pool.pools, pool.resident, pool.device_table()[1], 1)
    for _, leaf in tree_flatten(view):
        leaf.fill_(1.0)
    for r in pool.resident:                # (G, B, ...): slot 1 written, slot 0 not
        assert float(r[:, 1].min()) == 1.0 and float(r[:, 0].abs().max()) == 0.0
    pool.reset_slot_state(1)
    assert all(float(r.abs().max()) == 0.0 for r in pool.resident)


# ---------------------------------------------------------------------------
# scheduler tokens against JAX's scheduler on the same submissions
# ---------------------------------------------------------------------------

def _same_run(m, prompts, max_tokens, max_len, **kw):
    js = _jax_scheduler(m, max_len, **kw)
    want = js.generate_batch(prompts, max_tokens=max_tokens)
    ts = _port_scheduler(m, max_len, **kw)
    got = ts.generate_batch(prompts, max_tokens=max_tokens)
    assert got == want
    assert dataclasses.asdict(ts.stats) == dataclasses.asdict(js.stats)
    assert ts.pool.pages_in_use == 0 and ts.pool.pages_high_water == js.pool.pages_high_water
    return ts, js


def test_scheduler_tokens_equal_jax_dense_ragged_queued_chunked(models):
    """More requests than slots, ragged prompts, pow2-chunked prefill."""
    m = models("qwen3-32b")
    prompts = _prompts(m.tcfg.vocab_size, [4, 6, 9, 5], seed=1)
    ts, _ = _same_run(m, prompts, 5, 32, num_slots=2, page_size=8, prefill_chunk=8)
    assert ts._chunked_prefill
    assert ts.stats.completed == 4 and ts.stats.peak_running <= 2
    assert ts.stats.prefill_chunks > len(prompts)      # the 9-token prompt took two


def test_scheduler_tokens_equal_jax_moe_fused(models):
    """granite-moe compressed, the port through K4's (and K3's) plain
    versions: exact-length prefill, and the idle slot's dummy row routes
    too (capacity couples the rows), as in JAX."""
    m = models("granite-moe-1b-a400m", compressed=True)
    prompts = _prompts(m.tcfg.vocab_size, [4, 7], seed=2)
    ts, _ = _same_run(m, prompts, 4, 32, num_slots=2, page_size=8)
    assert not ts._chunked_prefill and ts.engine.fused_bitlinear
    assert ts.stats.prefill_chunks == 2


def test_scheduler_runs_its_engines_kernels_whatever_the_process_registers(models,
                                                                          monkeypatch):
    """A Scheduler's prefill chunks and decode ticks run with its Engine's
    hooks, after a disable_kernels() as before it, and leave the process's
    hooks as they were."""
    calls = []
    fused = tops.apply_compressed_fused

    def counting(x, w, **kw):
        calls.append(x.shape[0])
        return fused(x, w, **kw)

    monkeypatch.setattr(tops, "apply_compressed_fused", counting)
    m = models("qwen3-32b", compressed=True)
    prompts = _prompts(m.tcfg.vocab_size, [4, 6], seed=3)
    runs = []
    for off in (False, True):
        ts = _port_scheduler(m, 32, num_slots=2, page_size=8, prefill_chunk=8)
        if off:
            tops.disable_kernels()
        before = tops.kernel_hooks()
        calls.clear()
        runs.append((ts.generate_batch(prompts, max_tokens=4), list(calls)))
        assert tops.kernel_hooks() == before
    assert runs[0][1] and runs[0] == runs[1]


@pytest.mark.parametrize("arch,max_len", [("zamba2-1.2b", 32), ("zamba2-1.2b", 64),
                                          ("mamba2-130m", 32)])
def test_scheduler_tokens_equal_jax_hybrid(models, arch, max_len):
    """3 prompts on 2 slots: the first tick admits two requests and
    prefills one, so the other waits in ``prefill`` through a decode tick
    that feeds its slot a dummy token; its resident SSM, conv and ring state
    must stay zero (the port's forward writes the state in place)."""
    m = models(arch)
    prompts = _prompts(m.tcfg.vocab_size, [16, 16, 16], seed=4)
    ts, _ = _same_run(m, prompts, 8, max_len, num_slots=2, page_size=8)
    assert not ts._chunked_prefill and ts.stats.peak_running == 2


def test_both_packages_refuse_a_prompt_the_ssd_chunks_cannot_split(models):
    """37 tokens at the reduced SSD chunk of 16: JAX's reshape raises
    TypeError, the port's chunk rule ValueError; the request keeps its state
    and pages in both."""
    m = models("zamba2-1.2b")
    (prompt,) = _prompts(m.tcfg.vocab_size, [37], seed=5)
    for sched, err in ((_jax_scheduler(m, 64, num_slots=2, page_size=8), TypeError),
                       (_port_scheduler(m, 64, num_slots=2, page_size=8), ValueError)):
        req = sched.submit(prompt, max_tokens=4)
        with pytest.raises(err):
            sched.step()
        assert req.state == "prefill" and sched.pool.pages_in_use == 5


@pytest.mark.parametrize("arch,temperature", [("qwen3-32b", 0.0), ("qwen3-32b", 0.8),
                                              ("zamba2-1.2b", 0.0), ("zamba2-1.2b", 0.8)])
def test_eviction_recomputes_identically(models, arch, temperature):
    """A pool too small for both sequences forces preemption; the evicted
    request is recomputed from its prompt and gives the tokens of a run on
    a full pool, greedy or sampled (draw i from the request's seed and i)
    and, greedy, JAX's scheduler's under the same cut."""
    m = models(arch)
    if arch == "qwen3-32b":     # each needs pages_needed(12 + 8) = 5 of 4; 6 usable
        lens, kw = [10, 12], dict(page_size=4, prefill_chunk=8)
        cut = 7
    else:                       # prompts take 4 + 4 pages; finishing both takes 12
        lens, kw = [16, 16], dict(page_size=4)
        cut = 9
    prompts = _prompts(m.tcfg.vocab_size, lens, seed=3)
    full = _port_scheduler(m, 32, num_slots=2, **kw)
    want = full.generate_batch(prompts, max_tokens=8, temperature=temperature)
    assert full.stats.evictions == 0
    ts = _port_scheduler(m, 32, num_slots=2, num_pages=cut, **kw)
    got = ts.generate_batch(prompts, max_tokens=8, temperature=temperature)
    assert got == want
    assert ts.stats.evictions > 0 and ts.pool.pages_in_use == 0
    if temperature == 0.0:
        js = _jax_scheduler(m, 32, num_slots=2, num_pages=cut, **kw)
        assert js.generate_batch(prompts, max_tokens=8) == got
        assert js.stats.evictions == ts.stats.evictions
    else:
        greedy = _port_scheduler(m, 32, num_slots=2, **kw).generate_batch(prompts, 8)
        assert got != greedy                # the draws took effect


def test_eviction_can_thrash_as_in_jax(models):
    """The reference's victim rule (the most recently admitted *other*
    request) lets two growing requests evict each other tick after tick
    when the pool holds one of them but not both: three 16-token prompts, 12
    new tokens, 2 slots, 5 usable pages of 8.  The port copies it: after 40
    ticks both packages are in the same state, still working."""
    m = models("qwen3-32b")
    prompts = _prompts(m.tcfg.vocab_size, [16, 16, 16], seed=10)
    runs = []
    for sched in (_jax_scheduler(m, 32, num_slots=2, page_size=8, num_pages=6),
                  _port_scheduler(m, 32, num_slots=2, page_size=8, num_pages=6)):
        reqs = [sched.submit(p, 12) for p in prompts]
        for _ in range(40):
            sched.step()
        assert sched.has_work() and sched.stats.completed == 0
        runs.append((dataclasses.asdict(sched.stats),
                     [(r.state, r.evictions, r.tokens) for r in reqs]))
    assert runs[0] == runs[1]
    assert runs[1][0]["evictions"] >= 15


def test_scheduler_submit_validation(models):
    m = models("qwen3-32b")
    sched = _port_scheduler(m, 32, num_slots=1, page_size=8, num_pages=3)
    with pytest.raises(ValueError, match="exceeds max_len"):
        sched.submit(np.zeros(30, np.int32), max_tokens=8)
    with pytest.raises(ValueError, match="can never fit"):
        sched.submit(np.zeros(20, np.int32), max_tokens=8)
    with pytest.raises(ValueError, match="max_tokens"):
        sched.submit(np.zeros(4, np.int32), max_tokens=0)
    assert sched.submit(np.zeros(4, np.int32), max_tokens=2, temperature=1.0).seed == 0
    assert sched.committed_pages() == (1, 2)
    embeds = types.SimpleNamespace(cfg=reduced_for_smoke(get_config("musicgen-medium")))
    with pytest.raises(NotImplementedError, match="embed-input"):
        Scheduler(embeds, device="cpu")


# ---------------------------------------------------------------------------
# front end + load generator
# ---------------------------------------------------------------------------

def test_frontend_futures_and_backpressure(models):
    m = models("qwen3-32b")
    # 3 usable pages of 4; each request commits pages_needed(4+4)=2, so a
    # second concurrent submit oversubscribes and must block
    sched = _port_scheduler(m, 16, num_slots=2, page_size=4, num_pages=4, prefill_chunk=8)
    prompts = _prompts(m.tcfg.vocab_size, [4, 4], seed=6)
    fe = ServeFrontend(sched, auto_start=False)
    fut0 = fe.submit(prompts[0], max_tokens=4, eos_id=EOS_NEVER)
    with pytest.raises(TimeoutError):
        fe.submit(prompts[1], max_tokens=4, eos_id=EOS_NEVER, timeout=0.05)
    fe.start()
    r0 = fut0.result(timeout=300)
    assert len(r0.tokens) == 4
    fut1 = fe.submit(prompts[1], max_tokens=4, eos_id=EOS_NEVER, timeout=300)
    assert len(fut1.result(timeout=300).tokens) == 4
    fe.close()
    with pytest.raises(RuntimeError, match="closed"):
        fe.submit(prompts[0], max_tokens=1)
    assert fe.ticks == sched.stats.steps and fe.busy_s > 0


def test_frontend_concurrent_submitters_and_load(models):
    """More client threads than cores under a short switch interval: every
    future resolves once, with its own request's tokens; then run_load's
    statistics."""
    m = models("qwen3-32b")
    sched = _port_scheduler(m, 32, num_slots=2, page_size=8, prefill_chunk=8)
    prompts = _prompts(m.tcfg.vocab_size, [4, 6, 5, 4], seed=8)
    want = _port_scheduler(m, 32, num_slots=2, page_size=8, prefill_chunk=8).generate_batch(
        prompts, 3)
    n = 12
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ServeFrontend(sched, overcommit=2.0) as fe:
            results = {}

            def client(i):
                results[i] = fe.submit(prompts[i % 4], max_tokens=3, eos_id=EOS_NEVER,
                                       timeout=300).result(timeout=300)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            assert sorted(results) == list(range(n))
            assert len({r.rid for r in results.values()}) == n
            assert all(r.tokens == want[i % 4] for i, r in results.items())
            assert sched.stats.completed == sched.stats.submitted == n

            sched.stats.reset()
            res = run_load(fe, prompts, max_tokens=3, qps=50.0, eos_id=EOS_NEVER)
    finally:
        sys.setswitchinterval(interval)
    assert res.completed == 4 and res.total_tokens == 12
    assert res.goodput_toks_per_s > 0 and res.offered_toks_per_s == 150.0
    assert res.p99_latency_s >= res.p50_latency_s >= 0
    assert res.p50_latency_s >= res.p50_ttft_s
    assert 1 <= res.peak_running <= 2 and res.evictions == 0
    assert res.ticks >= res.decode_ticks >= 3 and res.mean_tick_ms > 0


def test_frontend_worker_error_fails_every_waiter(models):
    """The 37-token prompt the SSD cannot split fails in the worker: its
    future and every other waiting one get the ValueError, and later
    submits are refused."""
    m = models("zamba2-1.2b")
    sched = _port_scheduler(m, 64, num_slots=2, page_size=8)
    bad, good = _prompts(m.tcfg.vocab_size, [37, 16], seed=9)
    fe = ServeFrontend(sched, auto_start=False)
    futs = [fe.submit(bad, max_tokens=2), fe.submit(good, max_tokens=2)]
    fe.start()
    for f in futs:
        with pytest.raises(ValueError, match="chunk"):
            f.result(timeout=300)
    with pytest.raises(RuntimeError, match="worker died"):
        fe.submit(good, max_tokens=2)
    fe.close()
