"""The f32 rank shares of zamba2's ``ssm_attn`` layer, and the whole f32
layer, against the same layer in f64 (``tools/torch_ssm_share_error.py``),
at the reduced width on the CPU."""

import importlib.util
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# of max|update| of the f64 layer: 16 f32 ulps (2^-23 each) of the largest
# update; both sit near 4e-7 at this size, reduction order's few ulps
F64_TOL = 16 * 2.0 ** -23

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tool():
    path = os.path.join(ROOT, "tools", "torch_ssm_share_error.py")
    spec = importlib.util.spec_from_file_location("torch_ssm_share_error", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["f32", "all", "all_shared"])
@pytest.mark.parametrize("m", [2, 4])
def test_shares_and_whole_layer_lie_within_f32_rounding_of_f64(tool, m, variant):
    """Reduced zamba2 (d_model 64), 2 x 64 tokens: the joined shares and
    the whole layer each within F64_TOL of the f64 layer, with every sum in
    f32, with the SSM block's three sums over ``model`` in f64, and with the
    shared block's products in f64 too."""
    recs = tool.errors("reduced", (m,), torch.device("cpu"), 2, 64, variants=(variant,),
                       say=lambda s: None)
    rec = recs[0]
    assert (rec["m"], rec["variant"], rec["passes"] > 1) == (m, variant, True)
    assert 0 < rec["whole_vs_f64"] <= F64_TOL, rec
    assert 0 < rec["shares_vs_f64"] <= F64_TOL, rec
    assert rec["shares_vs_whole"] <= 2 * F64_TOL, rec


def test_the_f64_layer_computes_in_f64(tool):
    """Every f32 cast of the reference is f64 for f64 inputs, and the
    stand-in group sums f64 in f64: the f64 layer whole and as four ranks'
    f64 shares, whose sums run in other orders, agree far below f32
    rounding."""
    cfg = tool.config("reduced")
    layer = {k: tool.wider(v) for k, v in tool.build(cfg, torch.device("cpu"), 2, 32).items()}
    y = tool.whole(cfg, layer)
    joined, _ = tool.shares(cfg, layer, 4)
    assert y.dtype == joined.dtype == torch.float64
    scale = float((y - layer["x"]).abs().max())
    assert float((joined - y).abs().max()) <= 1e-12 * scale
