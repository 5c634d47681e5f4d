"""The port's flash attention (K5's plain version on the CPU), its model-
layout adapter and the plain chunked attention against the JAX package's
Pallas kernel (interpret mode), oracle and chunked loop."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_port_hooks():
    yield
    tops.disable_kernels()


def _pair(rng, shape, dtype):
    """The same values on both sides, rounded once to the working dtype."""
    a = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    t = torch.from_numpy(np.array(j, np.float32)).to(getattr(torch, dtype))
    return j, t


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# the shapes and tolerances of tests/test_kernels.py::test_flash_attention_matches_ref
@pytest.mark.parametrize("B,H,KV,S,hd,win,bq", [
    (2, 4, 2, 128, 32, 0, 64),
    (1, 8, 8, 256, 64, 64, 64),    # MHA + sliding window
    (2, 4, 1, 128, 16, 0, 32),     # MQA
    (1, 2, 2, 64, 128, 32, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax_kernel_and_ref(B, H, KV, S, hd, win, bq, dtype):
    rng = np.random.default_rng(B * S + hd)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in
                                    ((B, H, S, hd), (B, KV, S, hd), (B, KV, S, hd)))
    ot = tops.flash_attention(qt, kt, vt, window=win)
    assert ot.dtype == qt.dtype and tuple(ot.shape) == (B, H, S, hd)
    tol = 2e-5 if dtype == "float32" else 5e-2
    for oj in (jops.flash_attention(qj, kj, vj, window=win, interpret=True, block_q=bq,
                                    block_k=bq),
               jref.flash_attention_ref(qj, kj, vj, win)):
        np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)
    assert tfa.flash_attention.launches == 0        # CPU tensors: the plain version


@pytest.mark.parametrize("win", [0, 6])
def test_adapter_head_order_matches_jax_adapter(win):
    """Model layout q (B, S, KV, rep, hd): query head (g, r) reads kv head g,
    through the port's adapter as through the JAX one."""
    B, S, KV, rep, hd = 2, 16, 2, 3, 16
    rng = np.random.default_rng(win)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, "float32") for s in
                                    ((B, S, KV, rep, hd), (B, S, KV, hd), (B, S, KV, hd)))
    tops.enable_kernels()
    assert tattn._FLASH_IMPL is tops.flash_attention_model_layout
    ot = tattn._FLASH_IMPL(qt, kt, vt, win)
    jops.enable_kernels(interpret=True)
    oj = jattn._FLASH_IMPL(qj, kj, vj, win)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=2e-5, atol=2e-5)
    for g in range(KV):
        for r in range(rep):
            one = tops.flash_attention(qt[:, None, :, g, r].contiguous(),
                                       kt[:, None, :, g].contiguous(),
                                       vt[:, None, :, g].contiguous(), win)
            np.testing.assert_allclose(_np(ot[:, :, g, r]), _np(one[:, 0]), rtol=1e-6,
                                       atol=1e-6)
    tops.disable_kernels()
    assert tattn._FLASH_IMPL is None


@pytest.mark.parametrize("win", [0, 12])
@pytest.mark.parametrize("causal_skip", [False, True])
def test_chunked_attention_matches_jax(win, causal_skip):
    B, S, KV, rep, hd, qc = 2, 32, 2, 2, 16, 8
    rng = np.random.default_rng(7 + win)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, "float32") for s in
                                    ((B, S, KV, rep, hd), (B, S, KV, hd), (B, S, KV, hd)))
    ot = tattn._chunked_attention(qt, kt, vt, win, qc, causal_skip=causal_skip)
    oj = jattn._chunked_attention(qj, kj, vj, win, qc, causal_skip=causal_skip)
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=1e-5, atol=1e-5)
    # the skip changes which chunks are visited, not the result; and the
    # chunked loop is the flash kernel's function
    other = tattn._chunked_attention(qt, kt, vt, win, qc, causal_skip=not causal_skip)
    np.testing.assert_allclose(_np(ot), _np(other), rtol=1e-6, atol=1e-6)
    flat = tops.flash_attention_model_layout(qt, kt, vt, win)
    np.testing.assert_allclose(_np(ot), _np(flat), rtol=1e-5, atol=1e-5)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 16)
    kv = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="inconsistent"):
        tfa.flash_attention(q, kv, kv)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(NotImplementedError, match="head_dim 24"):
        z = torch.zeros(1, 2, 8, 24)
        tfa.flash_attention(z, z, z)


def _old_contiguous_adapter(qh, k, v, win):
    """The model-layout adapter as it was: contiguous (B, H, S, hd) copies in,
    o transposed back out."""
    B, S, KV, rep, hd = qh.shape
    q = qh.reshape(B, S, KV * rep, hd).transpose(1, 2).contiguous()
    o = tops.flash_attention(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                             win)
    return o.transpose(1, 2).reshape(B, S, KV, rep, hd)


@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("win", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_adapter_matches_contiguous_path_and_jax_kernel(dtype, win, rep):
    """The adapter now hands the kernel strided views and takes o in the
    model's layout; on the plain version it gives the old contiguous path's
    numbers, and the JAX Pallas kernel's (interpret mode) on the same inputs."""
    B, S, KV, hd = 2, 16, 2, 16
    rng = np.random.default_rng(31 + win + rep)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(rng, s, dtype) for s in
                                    ((B, S, KV, rep, hd), (B, S, KV, hd), (B, S, KV, hd)))
    ot = tops.flash_attention_model_layout(qt, kt, vt, win)
    assert ot.dtype == qt.dtype and tuple(ot.shape) == (B, S, KV, rep, hd)
    assert ot.is_contiguous()
    np.testing.assert_allclose(_np(ot), _np(_old_contiguous_adapter(qt, kt, vt, win)),
                               rtol=1e-6, atol=1e-6)
    qf = jnp.transpose(qj.reshape(B, S, KV * rep, hd), (0, 2, 1, 3))
    oj = jops.flash_attention(qf, jnp.transpose(kj, (0, 2, 1, 3)), jnp.transpose(vj, (0, 2, 1, 3)),
                              window=win, interpret=True, block_q=8, block_k=8)
    oj = jnp.transpose(oj, (0, 2, 1, 3)).reshape(B, S, KV, rep, hd)
    tol = 2e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(_np(ot), _np(oj), rtol=tol, atol=tol)
    assert tfa.flash_attention.launches == 0        # CPU tensors: the plain version


def test_flash_attention_writes_into_out():
    """``out`` receives o (any strided (B, H, S, hd) view) and is returned;
    an out of another shape or dtype is refused."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    buf = torch.zeros(1, 8, 4, 16)
    out = tfa.flash_attention(q, k, v, 3, out=buf.transpose(1, 2))
    assert out.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(_np(buf.transpose(1, 2)), _np(tfa.flash_attention(q, k, v, 3)))
    with pytest.raises(ValueError, match="out"):
        tfa.flash_attention(q, k, v, out=torch.zeros(1, 4, 8, 8))
    with pytest.raises(ValueError, match="out"):
        tfa.flash_attention(q, k, v, out=torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16))
