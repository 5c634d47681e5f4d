"""The decode schedule's host side: the rule that splits r across a
thread-block cluster (``bitlinear.decode_cluster_size``) and the launch
counts by cluster size.  The kernel itself is held on the card
(``tests/test_torch_cuda.py``)."""

import pytest

from repro_torch.kernels import bitlinear as bl

H100_SMS = 132
WAVE = bl.DECODE_BLOCKS_PER_SM * H100_SMS   # the blocks an H100 runs at once

# (E, n_c, n_r) of chip_smoke.py's decode calls at tile 32 x 128 (8 x 128 for
# the BBO attn/w[kv]): qwen3-32b's tensors, then granite-moe-1b-a400m's
# expert stacks (32 experts)
SHAPES = {
    "qwen/head": (1, 1187, 160), "qwen/wq": (1, 64, 160), "qwen/wk": (1, 8, 640),
    "qwen/wo": (1, 40, 256), "qwen/gate": (1, 200, 160), "qwen/down": (1, 40, 800),
    "granite/gate": (32, 4, 32), "granite/down": (32, 8, 16),
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cluster_size_fills_one_wave_of_blocks(name):
    E, n_c, n_r = SHAPES[name]
    S = bl.decode_cluster_size(E * n_c, n_r, H100_SMS)
    sizes = list(range(1, bl.DECODE_PORTABLE_CLUSTER + 1)) + [bl.DECODE_MAX_CLUSTER]
    assert S in sizes and S <= max(1, n_r // bl.DECODE_MIN_TILES)
    # the split never runs a second wave of blocks ...
    assert S == 1 or E * n_c * S <= WAVE
    # ... and the next larger size would, or would leave a block too few r tiles
    bigger = [s for s in sizes if s > S]
    assert not bigger or E * n_c * bigger[0] > WAVE or n_r // bigger[0] < bl.DECODE_MIN_TILES


def test_cluster_size_on_the_main_path_shapes():
    want = {"qwen/head": 1, "qwen/wq": 5, "qwen/wk": 16, "qwen/wo": 8, "qwen/gate": 1,
            "qwen/down": 8, "granite/gate": 1, "granite/down": 1}
    got = {k: bl.decode_cluster_size(E * n_c, n_r, H100_SMS) for k, (E, n_c, n_r) in SHAPES.items()}
    assert got == want


@pytest.mark.parametrize("blocks,n_r,sms,want", [(1, 3, 132, 1), (1, 64, 132, 2),
                                                 (8, 640, 132, 16), (8, 10_000, 132, 16),
                                                 (396, 1000, 132, 1), (198, 1000, 132, 2),
                                                 (199, 1000, 132, 1), (8, 640, 16, 6),
                                                 (40, 800, 132, 8), (8, 480, 132, 8)])
def test_cluster_size_caps(blocks, n_r, sms, want):
    assert bl.decode_cluster_size(blocks, n_r, sms) == want


def test_reset_counts_clears_the_cluster_counts():
    for fn in (bl.bitlinear, bl.bitlinear_grouped):
        fn.decode_clusters[4] = 3
        fn.tensor_core_launches = 2
    bl.reset_counts()
    for fn in (bl.bitlinear, bl.bitlinear_grouped):
        assert fn.decode_clusters == {} and fn.tensor_core_launches == 0
        assert fn.launches == 0 and not any(fn.by_schedule.values())


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gbytes,ms,want", [(1.0, 1.0, 1000.0), (0.0335, 0.01, 3350.0),
                                            (0.194, 0.1065, 1821.6)])
def test_decode_calls_report_gigabytes_per_second(gbytes, ms, want):
    """chip_smoke.py's decode_calls line: a call that moves ``gbytes`` GB in
    ``ms`` device milliseconds reports gbytes / ms * 1000 GB/s, on the
    scale of the card's 3,350 GB/s."""
    import types

    smoke = _chip_smoke()
    bytes_ms = gbytes * 1e9 / smoke.HBM_BYTES_PER_S * 1e3   # the bound's byte time
    assert smoke.gbps(bytes_ms, ms) == pytest.approx(want, rel=1e-4)
    fake = types.SimpleNamespace(decode_cluster_size=bl.decode_cluster_size,
                                 device_sms=lambda dev: H100_SMS)
    row = smoke.decode_call(fake, None, "decode", "qwen/head", 1, 1187, 160, bytes_ms, ms)
    assert row == {"tensor": "qwen/head", "S": 1, "GBps": pytest.approx(want, rel=1e-4)}
    assert smoke.decode_call(fake, None, "grid", "qwen/head", 1, 1187, 160, bytes_ms, ms) == {}
