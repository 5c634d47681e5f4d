"""K3's stream schedule on the CPU: what the card's kernel
(``csrc/bitlinear_stream.cuh``) stages through a tensor map, how its launch
splits r across a cluster, and its block's geometry, from the Python
mirrors in ``repro_torch.kernels.bitlinear`` (the card tests hold them to
the built library); and the plain version at every r_chunk against the JAX
package's stream kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.core import decomposition as tdec
from repro_torch.kernels import bitlinear as bl

H100_SMS = 132
H100_SM_SMEM = 233472   # shared memory per SM
BUDGET = 232448          # an H100's opt-in shared memory per block
BF16 = dict(x_itemsize=2, c_itemsize=2)

# (d_in, d_out, tn, K) of the main path's K3 tensors: qwen3-32b's eight
# (tile 32 x 128, K = 4; the BBO attn/w[kv] 8 x 128, K = 3) and
# granite-moe-1b-a400m's four attention projections (32 x 128, K = 4)
QWEN = {"head": (5120, 151936, 32, 4), "wq": (5120, 8192, 32, 4), "wk": (5120, 1024, 8, 3),
        "wv": (5120, 1024, 8, 3), "wo": (8192, 5120, 32, 4), "gate": (5120, 25600, 32, 4),
        "up": (5120, 25600, 32, 4), "down": (25600, 5120, 32, 4)}
GRANITE = {"wq": (1024, 1024, 32, 4), "wk": (1024, 512, 32, 4), "wv": (1024, 512, 32, 4),
           "wo": (1024, 1024, 32, 4)}
TD = 128


def _maps(**kw):
    return bl.stream_tensor_maps(**{"td": TD, "r_chunk": 1, **BF16, **kw})


@pytest.mark.parametrize("c_itemsize", [2, 4])
@pytest.mark.parametrize("T", [1, 4, 37, 300, 4096])
def test_qwen_and_granite_tiles_stage_every_part(T, c_itemsize):
    """32 x 128 tiles at K = 4: a C row is 256 or 512 bytes, an M tile 32
    bytes, a tile row of bf16 x 64 bytes, and the x box covers at most
    STREAM_ROWS rows, so T = 37 and T > 256 stage x too."""
    for rc in (1, 2, 4, 8, 16):
        assert _maps(T=T, tn=32, K=4, r_chunk=rc, x_itemsize=2, c_itemsize=c_itemsize) == \
            {"C": True, "M": True, "x": True}


def test_bbo_tiles_read_m_from_device_memory():
    """The BBO attn/w[kv] tiles (8 x 128, K = 3): an M tile is 8 bytes, under
    TMA's 16-byte inner box, so M is read from device memory; C's rows (768
    bytes) and bf16 or f32 x's tile rows (16, 32 bytes) go through maps, int8
    x's (8 bytes) does not."""
    assert _maps(T=4, tn=8, K=3) == {"C": True, "M": False, "x": True}
    assert _maps(T=4, tn=8, K=3, x_itemsize=4, c_itemsize=4) == \
        {"C": True, "M": False, "x": True}
    assert _maps(T=4, tn=8, K=3, x_itemsize=1) == {"C": True, "M": False, "x": False}


def test_tensor_map_rule():
    assert bl.tensor_map_ok(2, (128, 4, 1, 8), (256, 1024, 8192))
    assert not bl.tensor_map_ok(1, (8, 1, 2), (8, 64))              # 8-byte inner box
    assert not bl.tensor_map_ok(2, (257, 1), (1024,))               # a box dimension > 256
    assert not bl.tensor_map_ok(2, (8, 300), (16,))
    assert not bl.tensor_map_ok(2, (8, 4), (40,))                   # stride not 16-byte
    assert not bl.tensor_map_ok(2, (8, 4), (16,), base=8)           # base not 16-byte aligned
    assert bl.tensor_map_ok(1, (16, 256), (16,), base=32)
    # r_chunk past 256 breaks every part's box
    assert _maps(T=4, tn=32, K=4, r_chunk=257) == {"C": False, "M": False, "x": False}
    # C's rows: td x itemsize; 20 bf16 columns are 40 bytes
    assert not bl.stream_tensor_maps(T=4, tn=32, K=4, td=20, r_chunk=1, **BF16)["C"]
    assert bl.stream_tensor_maps(T=4, tn=32, K=4, td=24, r_chunk=1, **BF16)["C"]


@pytest.mark.parametrize("rc", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(QWEN) + [f"granite_{n}" for n in sorted(GRANITE)])
def test_cluster_size_fills_a_wave_in_whole_r_chunks(name, rc):
    """S splits a column tile's r chunks: each block keeps whole chunks and
    at least STREAM_MIN_TILES r tiles, the blocks stay within one wave of
    resident blocks, and they cover every SM unless a cap stopped S."""
    d_in, d_out, tn, K = GRANITE[name[8:]] if name.startswith("granite_") else QWEN[name]
    n_r, n_c = d_in // tn, d_out // TD
    rc = bl.resolve_r_chunk(n_r, rc)
    g = bl.stream_geometry(T=4, tn=tn, K=K, td=TD, r_chunk=rc, **BF16)
    blocks = n_c * g["col_chunks"] * g["row_blocks"]
    per_sm = bl.stream_blocks_per_sm(g["bt"], g["smem"], H100_SM_SMEM)
    assert per_sm == min(bl.stream_min_blocks(g["bt"]), H100_SM_SMEM // (g["smem"] + 1024))
    S = bl.stream_cluster_size(blocks, n_r, rc, H100_SMS, per_sm)
    chunks = n_r // rc
    assert S in (1, 2, 3, 4, 5, 6, 7, 8, 16)
    assert S <= chunks
    assert S == 1 or n_r // S >= bl.STREAM_MIN_TILES
    assert S == 1 or blocks * S <= per_sm * H100_SMS
    capped = S in (chunks, max(1, n_r // bl.STREAM_MIN_TILES), 16)
    assert blocks * S >= H100_SMS or capped
    # the chunks of the blocks of a cluster partition the column tile's
    bounds = [chunks * s // S for s in range(S + 1)]
    assert bounds[0] == 0 and bounds[-1] == chunks and all(
        b1 - b0 >= 1 for b0, b1 in zip(bounds, bounds[1:]))


def test_cluster_size_examples():
    per_sm = bl.stream_blocks_per_sm(4, 20_000, H100_SM_SMEM)
    assert per_sm == 3
    # qwen's head has 1,187 column tiles: more than a wave already
    assert bl.stream_cluster_size(1187, 160, 1, H100_SMS, per_sm) == 1
    # the BBO wk/wv (n_c 8, n_r 640): 16, non-portable
    assert bl.stream_cluster_size(8, 640, 1, H100_SMS, per_sm) == 16
    # granite's (n_r 32): four blocks of STREAM_MIN_TILES (8) r tiles
    assert bl.stream_cluster_size(8, 32, 1, H100_SMS, per_sm) == 4
    # a block taking the most shared memory: one per SM
    assert bl.stream_blocks_per_sm(4, 200_000, H100_SM_SMEM) == 1
    assert bl.stream_cluster_size(64, 160, 1, H100_SMS, 1) == 2
    # fewer chunks than the rule's S: S = the chunks
    assert bl.stream_cluster_size(8, 640, 160, H100_SMS, per_sm) == 4


@pytest.mark.parametrize("bt,smem,want", [(1, 20_000, 3), (4, 20_000, 3), (8, 20_000, 2),
                                          (8, 100_000, 2), (4, 100_000, 2), (8, 150_000, 1)])
def test_blocks_per_sm_is_the_launch_bounds_and_the_sm(bt, smem, want):
    """An SM holds what the kernel's launch bounds promise for its register
    group (3 blocks up to 4 rows, 2 for 8-row groups) and what its shared
    memory holds, 1 KiB reserved per block: the rule never counts more
    resident blocks than the header lets the registers give."""
    assert bl.stream_blocks_per_sm(bt, smem, H100_SM_SMEM) == want
    assert want <= bl.stream_min_blocks(bt)


@pytest.mark.parametrize("xs,cs", [(2, 2), (4, 4), (1, 4), (2, 4)])
@pytest.mark.parametrize("rc", [1, 2, 4, 8])
@pytest.mark.parametrize("T", [1, 4, 37, 4096])
def test_stage_geometry(T, rc, xs, cs):
    """A stage holds one r chunk, each part 128-byte aligned; the ring has a
    multiple of STREAM_WARPS stages (a slot's next stage is the same
    warp's), up to STREAM_STAGES, within STREAM_RING_BYTES where more than
    STREAM_WARPS stages; a block covers at most STREAM_ROWS rows, in register
    groups of up to 8."""
    g = bl.stream_geometry(T=T, tn=32, K=4, td=TD, x_itemsize=xs, c_itemsize=cs, r_chunk=rc)
    rows = min(T, bl.STREAM_ROWS)
    assert g["rows"] == rows and g["row_blocks"] == -(-T // rows)
    assert g["cols"] == 128 and g["col_chunks"] == 1 and g["cbox"] == TD
    c_b = -(-rc * 4 * TD * cs // 128) * 128
    m_b = -(-rc * 32 // 128) * 128
    x_b = -(-rows * rc * 32 * xs // 128) * 128
    assert g["stage_bytes"] == c_b + m_b + x_b and g["stage_bytes"] % 128 == 0
    assert bl.STREAM_WARPS <= g["stages"] <= bl.STREAM_STAGES
    assert g["stages"] % bl.STREAM_WARPS == 0
    assert g["stages"] == bl.STREAM_WARPS or \
        g["stages"] * g["stage_bytes"] <= bl.STREAM_RING_BYTES
    slots = bl.STREAM_WARPS * rows * 128 * 4
    zbuf = bl.STREAM_WARPS * rc * 4 * min(8, 1 << (rows - 1).bit_length()) * 4
    assert g["smem"] == g["stages"] * g["stage_bytes"] + zbuf + slots + 16 * g["stages"]
    # the main path's bf16 blocks fit the card at every r_chunk; the block
    # stops growing with T past STREAM_ROWS rows
    if (xs, cs) == (2, 2) or T <= 4:
        assert g["smem"] <= BUDGET
    if T > bl.STREAM_ROWS:
        assert g["smem"] == bl.stream_geometry(T=bl.STREAM_ROWS, tn=32, K=4, td=TD,
                                               x_itemsize=xs, c_itemsize=cs,
                                               r_chunk=rc)["smem"]


def test_stage_geometry_of_narrow_and_wide_c():
    # td <= 32: one 32-column chunk; td = 160: two 128-column chunks, the
    # second's box reaching past td (zeros)
    g = bl.stream_geometry(T=4, tn=16, K=3, td=32, r_chunk=2, **BF16)
    assert (g["cols"], g["col_chunks"], g["cbox"]) == (32, 1, 32)
    g = bl.stream_geometry(T=4, tn=16, K=9, td=160, r_chunk=2, **BF16)
    assert (g["cols"], g["col_chunks"], g["cbox"]) == (128, 2, 128)
    # nothing staged: the stages are barriers only
    g = bl.stream_geometry(T=4, tn=8, K=3, td=20, r_chunk=1, x_itemsize=1, c_itemsize=2)
    assert not any(g["maps"].values()) and g["stage_bytes"] == 0


@pytest.mark.parametrize("rc", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_stream_matches_jax_stream_kernel_at_every_r_chunk(dtype, rc):
    """The port's stream schedule on the CPU (its plain version) against
    JAX's _stream_kernel in interpret mode at the r_chunk values chip_smoke
    holds the card's kernel to."""
    rng = np.random.default_rng(rc)
    T, nr, nc, tn, K, td = 5, 8, 2, 8, 3, 32
    M = np.where(rng.random((nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    mp = tdec.pack_bits(torch.from_numpy(M))
    C = (rng.standard_normal((nr, nc, K, td)) * 0.2).astype(np.float32)
    x = rng.standard_normal((T, nr * tn)).astype(np.float32)
    jd, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    xj, Cj = jnp.asarray(x).astype(jd), jnp.asarray(C).astype(jd)
    xt = torch.from_numpy(np.array(xj, np.float32)).to(tdt)
    Ct = torch.from_numpy(np.array(Cj, np.float32)).to(tdt)
    for math in ("unpack", "bitplane"):
        yj = jops.bitlinear(xj, jnp.asarray(mp.numpy()), Cj, interpret=True, mode="stream",
                            math=math, r_chunk=rc)
        yt = bl.bitlinear(xt, mp, Ct, mode="stream", math=math, r_chunk=rc)
        tol = 1e-5 if dtype == "float32" else 2e-2 * float(np.abs(np.asarray(
            yj, np.float32)).max())
        np.testing.assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32), rtol=0,
                                   atol=tol)
    assert bl.bitlinear.launches == 0
