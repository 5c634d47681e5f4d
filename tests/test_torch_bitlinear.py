"""The port's compressed layer (bitlinear plain versions for every schedule,
bit algebra and activation dtype, the fused hook and its gradient, the int8
baseline apply) against the JAX package's Pallas kernels in interpret mode,
its oracle and its custom VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantized as jq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import decomposition as tdec
from repro_torch.core import quantized as tq
from repro_torch.kernels import bitlinear as tbl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_port_hooks():
    yield
    tops.disable_kernels()


def _weights(seed, nr, nc, tn, K, td):
    rng = np.random.default_rng(seed)
    M = np.where(rng.random((nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    mp = tdec.pack_bits(torch.from_numpy(M)).numpy()
    C = (rng.standard_normal((nr, nc, K, td)) * 0.2).astype(np.float32)
    return mp, C


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("T,nr,nc,tn,K,td", [
    (1, 2, 3, 8, 3, 32),       # decode, paper-scale tile (tn=8, K=3)
    (13, 2, 2, 16, 4, 64),     # ragged T
    (20, 3, 2, 16, 9, 32),     # K > 8: two packed bytes
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bitlinear_matches_jax_kernel_and_ref(T, nr, nc, tn, K, td, dtype):
    mp, C = _weights(T * K, nr, nc, tn, K, td)
    x = np.random.default_rng(T).standard_normal((T, nr * tn)).astype(np.float32)
    jd, td_ = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    # inputs rounded once to the working dtype, identical on both sides
    xj, Cj = _to_jax(x, jd), _to_jax(C, jd)
    xt = _to_torch(np.asarray(xj, np.float32), td_)
    Ct = _to_torch(np.asarray(Cj, np.float32), td_)
    yt = tbl.bitlinear(xt, torch.from_numpy(mp), Ct)
    assert yt.dtype == td_ and tuple(yt.shape) == (T, nc * td)
    yt = yt.float().numpy()
    refs = [jref.bitlinear_ref(xj, jnp.asarray(mp), Cj)] + [
        jops.bitlinear(xj, jnp.asarray(mp), Cj, block_t=8, interpret=True, mode=m)
        for m in ("grid", "decode")
    ]
    for yj in refs:
        yj = np.asarray(yj, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(yt, yj, rtol=1e-4, atol=1e-4)
        else:
            assert np.abs(yt - yj).max() <= 2e-2 * np.abs(yj).max()
    assert tbl.bitlinear.launches == 0


def test_apply_compressed_einsum_and_decompress_match_jax():
    mp, C = _weights(3, 2, 2, 16, 4, 32)
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(np.float32)
    wj = {"m_packed": jnp.asarray(mp), "C": jnp.asarray(C)}
    wt = {"m_packed": torch.from_numpy(mp), "C": torch.from_numpy(C)}
    np.testing.assert_allclose(
        tq.apply_compressed(torch.from_numpy(x), wt).numpy(),
        np.asarray(jq.apply_compressed_einsum(jnp.asarray(x), wj)), rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(tq.decompress(wt).numpy(), np.asarray(jq.decompress(wj)),
                               rtol=1e-6, atol=1e-6)
    assert tq.compressed_num_bytes(wt) == jq.compressed_num_bytes(wj)
    assert tq.dense_num_bytes(wt) == jq.dense_num_bytes(wj)


def test_fused_gradient_matches_jax_custom_vjp():
    mp, C = _weights(7, 3, 2, 8, 3, 16)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 24)).astype(np.float32)
    g = rng.standard_normal((2, 4, 32)).astype(np.float32)

    jops.enable_kernels(interpret=True)
    try:
        def loss(xx, cc):
            y = jq.apply_compressed(xx, {"m_packed": jnp.asarray(mp), "C": cc})
            return jnp.sum(y * jnp.asarray(g))

        dxj, dCj = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(C))
    finally:
        jops.disable_kernels()

    tops.enable_kernels()
    assert tq.has_fused_bitlinear()
    xt = torch.from_numpy(x).requires_grad_()
    Ct = torch.from_numpy(C).requires_grad_()
    y = tq.apply_compressed(xt, {"m_packed": torch.from_numpy(mp), "C": Ct})
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Ct.grad.numpy(), np.asarray(dCj), rtol=1e-4, atol=1e-5)


def test_bitlinear_rejects_what_is_not_ported():
    mp, C = _weights(0, 1, 1, 8, 3, 16)
    with pytest.raises(NotImplementedError, match="float16"):
        tbl.bitlinear(torch.zeros(2, 8, dtype=torch.float16), torch.from_numpy(mp),
                      torch.from_numpy(C))
    with pytest.raises(ValueError, match="inconsistent"):
        tbl.bitlinear(torch.zeros(2, 9), torch.from_numpy(mp), torch.from_numpy(C))
    with pytest.raises(ValueError, match="mode"):
        tbl.bitlinear(torch.zeros(2, 8), torch.from_numpy(mp), torch.from_numpy(C), mode="x")
    # the grouped kernel K4 refuses the same, stream (no grouped stream, as
    # in JAX) and an expert-count mismatch
    grouped = {"m_packed": torch.zeros(2, 1, 1, 8, 1, dtype=torch.uint8),
               "C": torch.zeros(2, 1, 1, 3, 16)}
    with pytest.raises(NotImplementedError, match="float16"):
        tbl.bitlinear_grouped(torch.zeros(2, 1, 8, dtype=torch.float16), grouped["m_packed"],
                              grouped["C"])
    with pytest.raises(ValueError, match="stream"):
        tbl.bitlinear_grouped(torch.zeros(2, 1, 8), grouped["m_packed"], grouped["C"],
                              mode="stream")
    with pytest.raises(ValueError, match="inconsistent"):
        tbl.bitlinear_grouped(torch.zeros(3, 1, 8), grouped["m_packed"], grouped["C"])
    with pytest.raises(ValueError, match="grouped apply"):
        tq.apply_compressed(torch.zeros(3, 1, 8), grouped)


# ---------------------------------------------------------------------------
# every schedule x bit algebra x activation dtype against JAX's Pallas kernels
# ---------------------------------------------------------------------------

# (T, n_r, n_c, tn, K, td, int8 C scale): decode-sized T with the BBO tile
# (tn = 8, K = 3); a ragged T with K = 9 (two packed bytes, K % 8 != 0); and
# a C large enough that most int8 outputs saturate
SHAPES = [(1, 2, 3, 8, 3, 32, 16), (13, 2, 2, 16, 9, 32, 16), (5, 2, 3, 16, 4, 32, 256)]
GROUPED_SHAPES = [(2, 1, 2, 3, 8, 3, 32, 16), (3, 13, 2, 2, 16, 9, 32, 256)]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


def _inputs(seed, lead, T, nr, nc, tn, K, td, dtype, c_scale, c_dtype=None):
    """numpy inputs for both packages.  int8 activations take C on the grid
    k/256 (|k| <= c_scale): z is an exact integer and every product z*C and
    partial sum is exact in float32, so the truncated int8 output does not
    depend on the order of the f32 sum (the kernels and the plain version
    sum in different orders).  Float inputs are rounded once to the working
    dtype, identically on both sides."""
    rng = np.random.default_rng(seed)
    M = np.where(rng.random(lead + (nr, nc, tn, K)) < 0.5, -1.0, 1.0).astype(np.float32)
    mp = tdec.pack_bits(torch.from_numpy(M)).numpy()
    if dtype == "int8":
        x = rng.integers(-128, 128, lead + (T, nr * tn)).astype(np.int8)
        C = (rng.integers(-c_scale, c_scale + 1, lead + (nr, nc, K, td)) / 256).astype(np.float32)
        c_dtype = c_dtype or "float32"
    else:
        x = rng.standard_normal(lead + (T, nr * tn)).astype(np.float32)
        C = (rng.standard_normal(lead + (nr, nc, K, td)) * 0.2).astype(np.float32)
        c_dtype = c_dtype or dtype
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    Cj = jnp.asarray(C).astype(getattr(jnp, c_dtype))
    xt = (torch.from_numpy(x) if dtype == "int8"
          else _to_torch(np.asarray(xj, np.float32), getattr(torch, dtype)))
    Ct = _to_torch(np.asarray(Cj, np.float32), getattr(torch, c_dtype))
    return (xj, jnp.asarray(mp), Cj), (xt, torch.from_numpy(mp), Ct)


def _same(yt, yj, dtype):
    yj = np.asarray(yj)
    assert str(yt.dtype).split(".")[-1] == yj.dtype.name == dtype
    if dtype == "int8":
        np.testing.assert_array_equal(yt.numpy(), yj)
    else:
        np.testing.assert_allclose(yt.float().numpy(), yj.astype(np.float32),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "T{}_r{}c{}n{}k{}d{}_c{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("math", ["unpack", "bitplane"])
@pytest.mark.parametrize("mode", ["grid", "decode", "stream"])
def test_plain_bitlinear_matches_jax_schedule(mode, math, dtype, shape):
    T, nr, nc, tn, K, td, c_scale = shape
    (xj, mpj, Cj), (xt, mpt, Ct) = _inputs(T * K, (), T, nr, nc, tn, K, td, dtype, c_scale)
    yj = jops.bitlinear(xj, mpj, Cj, block_t=8, interpret=True, mode=mode, math=math)
    _same(tbl.bitlinear(xt, mpt, Ct, block_t=8, mode=mode, math=math), yj, dtype)
    assert tbl.bitlinear.launches == 0


@pytest.mark.parametrize("shape", GROUPED_SHAPES,
                         ids=lambda s: "E{}_T{}_r{}c{}n{}k{}d{}_c{}".format(*s))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("math", ["unpack", "bitplane"])
@pytest.mark.parametrize("mode", ["grid", "decode"])
def test_plain_grouped_bitlinear_matches_jax_schedule(mode, math, dtype, shape):
    E, T, nr, nc, tn, K, td, c_scale = shape
    (xj, mpj, Cj), (xt, mpt, Ct) = _inputs(E * T * K, (E,), T, nr, nc, tn, K, td, dtype, c_scale)
    yj = jops.bitlinear_grouped(xj, mpj, Cj, block_t=8, interpret=True, mode=mode, math=math)
    _same(tbl.bitlinear_grouped(xt, mpt, Ct, block_t=8, mode=mode, math=math), yj, dtype)
    assert tbl.bitlinear_grouped.launches == 0


@pytest.mark.parametrize("math", ["unpack", "bitplane"])
def test_plain_int8_with_bf16_c_matches_jax(math):
    """int8 activations with a bfloat16 C: z is rounded to bf16 (exact here,
    |z| <= 256) before z @ C, in every schedule."""
    (xj, mpj, Cj), (xt, mpt, Ct) = _inputs(5, (), 4, 2, 3, 8, 3, 32, "int8", 64, "bfloat16")
    for mode in ("grid", "stream"):
        yj = jops.bitlinear(xj, mpj, Cj, block_t=8, interpret=True, mode=mode, math=math)
        _same(tbl.bitlinear(xt, mpt, Ct, mode=mode, math=math), yj, "int8")
    (xj, mpj, Cj), (xt, mpt, Ct) = _inputs(6, (2,), 3, 2, 2, 8, 3, 32, "int8", 64, "bfloat16")
    yj = jops.bitlinear_grouped(xj, mpj, Cj, block_t=8, interpret=True, mode="decode", math=math)
    _same(tbl.bitlinear_grouped(xt, mpt, Ct, mode="decode", math=math), yj, "int8")


def test_int8_output_truncates_toward_zero_and_saturates():
    """The plain version's int8 output is the f32 accumulator truncated
    toward zero and saturated to [-128, 127], as the Pallas kernels give."""
    x = torch.tensor([[1, 0, 0, 0, 0, 0, 0, 0]], dtype=torch.int8)
    mp = torch.full((1, 1, 8, 1), 0b111, dtype=torch.uint8)        # M[:, k] = +1
    C = torch.tensor([[[[1.880, -3.862, 188.0, -386.2]] * 3]]).reshape(1, 1, 3, 4) / 3
    y = ref.bitlinear_ref(x, mp, C)
    assert y.dtype == torch.int8 and y.tolist() == [[1, -3, 127, -128]]
    yj = jops.bitlinear(jnp.asarray(x.numpy()), jnp.asarray(mp.numpy()), jnp.asarray(C.numpy()),
                        block_t=8, interpret=True, mode="grid")
    np.testing.assert_array_equal(np.asarray(yj), y.numpy())


def test_jax_jnp_schedule_disagrees_with_its_kernels_on_int8():
    """Fixture for ROADMAP Queue 3: JAX's ``jnp`` schedule on int8
    activations casts C to int8 (unpack: zeros for |C| < 1, int8
    wrap-around for larger C) or returns float32 zeros (bitplane), where
    every Pallas kernel gives the saturated f32 result.  The port's plain
    version, which ``mode="jnp"`` runs, follows the kernels."""
    (xj, mpj, Cj), (xt, mpt, Ct) = _inputs(3, (), 5, 2, 3, 16, 4, 32, "int8", 16)
    kern = np.asarray(jops.bitlinear(xj, mpj, Cj, block_t=8, interpret=True, mode="grid"))
    assert np.abs(kern.astype(np.int32)).max() > 0
    unpack = np.asarray(jops.bitlinear(xj, mpj, Cj, interpret=True, mode="jnp"))
    assert unpack.dtype == np.int8 and not unpack.any()                  # C -> int8 = 0
    bitplane = np.asarray(jops.bitlinear(xj, mpj, Cj, interpret=True, mode="jnp",
                                         math="bitplane"))
    assert bitplane.dtype == np.float32 and not bitplane.any()
    big = Cj * 64                                                        # |C| up to 4
    kern_big = np.asarray(jops.bitlinear(xj, mpj, big, block_t=8, interpret=True, mode="grid"))
    wrap = np.asarray(jops.bitlinear(xj, mpj, big, interpret=True, mode="jnp"))
    assert (np.abs(kern_big.astype(np.int32)) == 128).sum() + (kern_big == 127).sum() > 0
    assert not np.array_equal(wrap, kern_big)
    for math in ("unpack", "bitplane"):
        np.testing.assert_array_equal(
            tbl.bitlinear(xt, mpt, Ct, mode="jnp", math=math).numpy(), kern)
        np.testing.assert_array_equal(
            tbl.bitlinear(xt, mpt, Ct * 64, mode="jnp", math=math).numpy(), kern_big)


@pytest.mark.parametrize("grouped", [False, True], ids=["4d", "grouped_5d"])
def test_apply_intquant_and_dequantize_match_jax(grouped):
    rng = np.random.default_rng(11)
    lead = (3,) if grouped else ()
    q = rng.integers(-127, 128, lead + (2, 3, 8, 16)).astype(np.int8)
    scale = (rng.random(lead + (2, 3, 1, 1)) * 0.05).astype(np.float32)
    x = rng.standard_normal(lead + (4, 5, 16)).astype(np.float32)
    wj = {"q": jnp.asarray(q), "scale": jnp.asarray(scale)}
    wt = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
    np.testing.assert_allclose(tq.apply_intquant(torch.from_numpy(x), wt).numpy(),
                               np.asarray(jq.apply_intquant(jnp.asarray(x), wj)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tq.dequantize(wt).numpy(), np.asarray(jq.dequantize(wj)),
                               rtol=1e-6, atol=1e-7)
    assert tq.intquant_num_bytes(wt) == jq.intquant_num_bytes(wj)


def test_partial_bitlinear_hook_feeds_the_einsum_form():
    """``register_bitlinear`` (the partial z = x @ M hook) is used by the
    einsum form, as in JAX; ``clear_bitlinear`` removes it."""
    mp, C = _weights(4, 2, 2, 8, 3, 16)
    w = {"m_packed": torch.from_numpy(mp), "C": torch.from_numpy(C)}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 16)).astype(np.float32))
    calls = []

    def z_hook(xt, m_packed, K):
        calls.append(tuple(xt.shape))
        M = ref.unpack_signs(m_packed, K, xt.dtype)
        return torch.einsum("...rn,rcnk->...rck", xt, M)

    want = tq.apply_compressed_einsum(x, w)
    tq.register_bitlinear(z_hook)
    try:
        torch.testing.assert_close(tq.apply_compressed_einsum(x, w), want)
    finally:
        tq.clear_bitlinear()
    assert calls == [(3, 2, 8)]
    with pytest.raises(ValueError, match="clear_bitlinear"):
        tq.register_bitlinear(None)


@pytest.mark.parametrize("T,tn,K,td,sizes,want", [
    (4096, 32, 4, 128, (2, 2), True),      # the policies' tile, prefill
    (4096, 32, 4, 131, (2, 2), True),      # zamba2's in_proj: td no multiple of 16
    (4096, 32, 4, 419, (2, 2), True),      # mamba2-130m's in_proj
    (40, 32, 4, 37, (2, 2), True),         # the reduced configs' in_proj
    (5, 32, 4, 17, (2, 2), True),          # one n-tile of padding, just above SMALL_T
    (4, 32, 4, 128, (2, 2), False),        # T <= SMALL_T: the small FMA block
    (4096, 32, 4, 128, (4, 2), False),     # f32 x
    (4096, 32, 4, 128, (2, 4), False),     # f32 C
    (4096, 16, 9, 160, (2, 2), False),     # K > 8
    (4096, 12, 3, 128, (2, 2), False),     # tn no multiple of 8
    # odd tile widths keep the FMA body for the same reasons
    (4096, 32, 4, 131, (4, 2), False),     # f32 x
    (4096, 32, 4, 131, (1, 2), False),     # int8 x
    (4096, 32, 4, 419, (2, 4), False),     # f32 C
    (4096, 32, 9, 131, (2, 2), False),     # K > 8
    (4096, 12, 4, 131, (2, 2), False),     # tn no multiple of 8
    (4, 32, 4, 131, (2, 2), False),        # T <= SMALL_T
    (1, 32, 4, 37, (2, 2), False),         # T = 1
])
def test_grid_tensor_core_rule_mirrors_the_library(T, tn, K, td, sizes, want):
    """``grid_on_tensor_cores`` is ``csrc/bitlinear.cuh::grid_on_mma``'s rule
    (the card tests hold it to each launch's report): bf16 x and C above
    SMALL_T rows, K <= 8, tn % 8 == 0, at any tile width."""
    assert tbl.grid_on_tensor_cores(T, tn, K, td, *sizes) is want


@pytest.mark.parametrize("td,cols,chunks", [
    (17, 48, 1), (37, 48, 1), (64, 64, 1), (96, 128, 1), (128, 128, 1), (131, 144, 1),
    (160, 128, 2), (419, 144, 3), (1, 48, 1), (144, 144, 1), (145, 128, 2),
])
def test_grid_mma_chunk_pads_td_to_whole_n_tiles(td, cols, chunks):
    """The tensor-core grid's column chunk: td padded to a multiple of 16 in
    the fewest chunks of at most 144 columns, each an instantiated width."""
    assert tbl.grid_mma_chunk(td) == (cols, chunks)
    assert cols % 16 == 0 and cols // 16 in tbl.GRID_MMA_NTPS and cols * chunks >= td
    assert cols <= 16 * tbl.GRID_MMA_MAX_NTP
