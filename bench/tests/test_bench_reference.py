"""The plain references against the equations and against the program at a
tiny size, on the CPU in float32."""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

import tiny
from benchlib import port, weights
from reference import compress as rc
from reference import common as ref
from reference import granite_moe


def test_routing_groups_follow_the_prompt_then_one_token_each():
    assert granite_moe.routing_groups(48, 51, 1024) == [(0, 48), (48, 1), (49, 1), (50, 1)]
    assert granite_moe.routing_groups(3584, 3584, 1024) == [(s, 512) for s in range(0, 3584, 512)]


def test_moe_capacity_drops_the_later_slots():
    # every token routes both slots to expert 0 and 1: capacity int(0.5*4*2/2) = 2
    x = torch.ones(1, 4, 2)
    router = torch.tensor([[1.0, 0.5], [1.0, 0.5]])
    eye = torch.eye(2)[None].repeat(2, 1, 1)
    out = granite_moe.moe(x, router, eye, eye, eye, k=2, cf=0.5, groups=[(0, 4)],
                  prec=ref.Precision())
    # the first two tokens keep both experts; the last two lose both
    assert (out[0, :2].abs().sum(-1) > 0).all() and (out[0, 2:] == 0).all()


def test_unpack_and_dense_follow_the_bit_order():
    m = torch.tensor([[0b0101], [0b1010]], dtype=torch.uint8)
    assert ref.unpack_signs(m, 4).tolist() == [[1, -1, 1, -1], [-1, 1, -1, 1]]
    C = torch.arange(8.0).reshape(1, 1, 4, 2)
    W = ref.dense({"m_packed": m.reshape(1, 1, 2, 1), "C": C})
    M = ref.unpack_signs(m, 4)
    assert torch.equal(W, M @ C[0, 0])


@pytest.mark.parametrize("conf", ["granite-moe"])
def test_reference_logits_match_the_program_in_f32(bench_run, conf):
    """The reference's logits over a prompt and its continuation against the
    program's plain forward (no kernels, no cache) on the same weights."""
    from repro_torch.models import forward

    spec = bench_run.Spec()
    c = spec.config(conf)
    cfg, sizes = port.model_config(c, dict(tiny.TINY[conf], torch_dtype="float32"))
    if conf == "granite-moe":
        # a capacity small enough to drop slots
        cfg = cfg.__class__(**{**cfg.__dict__, "capacity_factor": 0.5})
        sizes["capacity_factor"] = 0.5
    plan = port.plan(cfg, tiny.TINY_POLICY)
    params = weights.make(port.layout(cfg), {t.path: (t.K, t.tile_n, t.tile_d)
                                             for t in plan.tensors}, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, sizes["vocab_size"], (2, 32), generator=g)
    with torch.no_grad():
        want, _, _ = forward(params, {"tokens": toks}, cfg)
    got = granite_moe.logits(sizes, params, toks, 32, list(range(32)), ref.Precision())
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_fp8_control_rounds_every_product():
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(2))
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    lo = ref.Precision("fp8")
    got = lo.mm(x, lo.weight(w))
    rel = ((got - x @ w).norm() / (x @ w).norm()).item()
    assert 1e-3 < rel < 0.2


def test_c_excess_is_one_for_the_rounded_optimum_and_more_for_the_control():
    g = torch.Generator().manual_seed(4)
    W = torch.randn(64, 32, 128, generator=g).to(torch.bfloat16)
    M = torch.where(torch.randn(64, 32, 4, generator=g) > 0, 1.0, -1.0)
    weight = 1 << torch.arange(4, dtype=torch.uint8)
    bits = ((M > 0).to(torch.uint8) * weight).sum(-1, keepdim=True)
    Copt = rc.optimal_c(M, W.float())
    got, best = rc.c_excess(bits.to(torch.uint8), Copt.to(torch.bfloat16), W.float())
    assert math.isclose(got, best)
    got_c, best_c = rc.c_excess(bits.to(torch.uint8), rc.control_c(M, W.float()), W.float())
    assert got_c > 3 * best_c


def test_tiles_are_row_major_per_slice():
    W = torch.arange(2 * 4 * 6.0).reshape(2, 4, 6)
    t = rc.tiles(W, 2, 3)
    assert t.shape == (8, 2, 3)
    assert torch.equal(t[1], W[0, 0:2, 3:6]) and torch.equal(t[4], W[1, 0:2, 0:3])


def test_weights_repeat_for_a_seed_and_differ_across_seeds(bench_run):
    c = bench_run.Spec().config("granite-moe")
    cfg, _ = port.model_config(c, dict(tiny.TINY["granite-moe"], torch_dtype="float32"))
    lay = port.layout(cfg)
    comp = {t.path: (t.K, t.tile_n, t.tile_d) for t in port.plan(cfg, tiny.TINY_POLICY).tensors}
    a, b, d = (weights.make(lay, comp, s, "cpu") for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    pa, pb, pd = (dict(weights.paths(t)) for t in (a, b, d))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert any(not torch.equal(pa[k], pd[k]) for k in pa if k.endswith("C"))
    # unused bits of a packed byte are zero, as packing leaves them
    for k, v in pa.items():
        if k.endswith("m_packed"):
            assert int(v.max()) < 16


def test_leaf_indices_are_the_plans(bench_run):
    c = bench_run.Spec().config("granite-moe")
    cfg, _ = port.model_config(c, dict(tiny.TINY["granite-moe"], torch_dtype="bfloat16"))
    order = rc.leaf_indices(port.layout(cfg))
    plan = port.plan(cfg, tiny.TINY_POLICY)
    assert [order[t.path] for t in plan.tensors] == [t.leaf_index for t in plan.tensors]


def test_restarts_and_decomposition_follow_the_program_at_the_cells_tile():
    """At 32 x 128, K = 4: the restarts are the program's draws, the float64
    decomposition gives the program's M on every tile, and the bfloat16 one
    departs from it on many."""
    from repro_torch.core import decomposition as dec
    from repro_torch.device import generator

    n, tn, td, K = 256, 32, 128, 4
    W = (torch.randn(n, tn, td, generator=torch.Generator().manual_seed(6)) / 32).bfloat16()
    signs = rc.restart_signs("cpu", n, K, tn, 2**40 + 3, 7, 1)
    want = dec.draw_restart_signs((n,), K, rc.RESTARTS, tn, generator("cpu", 2**40 + 3, 7, 1))
    assert torch.equal(signs, want.double())
    Wf = W.float()
    M = dec.alternating_decompose(Wf, K, M0=dec.greedy_decompose_from(Wf, K, want).M)[0]
    assert torch.equal(rc.decompose(W, signs), M.double())
    low = rc.decompose(W, signs, dtype=torch.bfloat16)
    assert (low.double() != M.double()).flatten(1).any(1).float().mean() > 0.1
    assert torch.allclose(rc.residual(M, W), dec.objective(M.double(), W.double()))
