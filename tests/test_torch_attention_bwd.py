"""The port's plain packed-attention backward vs the JAX Pallas backward
kernels (interpret mode), and vs torch autograd through the forward twin.

The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against this plain version there);
on a CPU tensor the Function's backward runs the plain version and launches
nothing. fp32 everywhere here, so the tolerance (rtol 2e-4, atol 2e-5) is
that of two summation orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import pallas_attention as jpa
from aa_clip_iqm_tpu_torch.ops import packed_attention as pa

HEADS, HD = 2, 64
SCALE = HD ** -0.5
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    jpa.INTERPRET = True
    yield
    jpa.INTERPRET = False


def _inputs(seed, seq_len, batch=1):
    rng = np.random.default_rng(seed)
    w = HEADS * HD
    qkv = rng.standard_normal((batch, seq_len, 3 * w)).astype(np.float32)
    g = rng.standard_normal((batch, seq_len, w)).astype(np.float32)
    return qkv, g


# 256: no padding in the JAX kernel; 300: its ragged tail; valid_len: keys
# masked short of the length.
CASES = [(256, None), (300, None), (300, 290), (256, 200)]


@pytest.mark.parametrize("seq_len,valid_len", CASES)
def test_plain_backward_matches_pallas_kernel(seq_len, valid_len):
    qkv, g = _inputs(seq_len, seq_len)
    ref = jpa._flash_packed_bwd_kernelized(jnp.asarray(qkv), jnp.asarray(g), HEADS,
                                           SCALE, valid_len)
    out = pa.flash_mha_packed_bwd_reference(torch.from_numpy(qkv), torch.from_numpy(g),
                                            HEADS, SCALE, valid_len=valid_len)
    assert out.shape == qkv.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seq_len,valid_len", [(256, None), (300, 290)])
def test_plain_vv_backward_matches_pallas_kernel(seq_len, valid_len):
    qkv, g = _inputs(seq_len + 1, seq_len)
    ref = jpa._flash_packed_vv_bwd_kernelized(jnp.asarray(qkv), jnp.asarray(g), HEADS,
                                              SCALE, valid_len)
    out = pa.flash_mha_packed_bwd_reference(torch.from_numpy(qkv), torch.from_numpy(g),
                                            HEADS, SCALE, vv=True, valid_len=valid_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    assert not out[..., :2 * HEADS * HD].any()      # q and k columns get none


@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len,valid_len", [(77, None), (130, 100)])
def test_function_backward_matches_autograd_of_the_twin(vv, seq_len, valid_len):
    qkv, g = _inputs(7, seq_len, batch=2)
    t = torch.from_numpy(qkv).requires_grad_(True)
    (ref,) = torch.autograd.grad(
        pa.flash_mha_packed_reference(t, HEADS, SCALE, vv, valid_len), t,
        torch.from_numpy(g))
    pa.reset_launches()
    out = pa.flash_mha_packed(t, HEADS, SCALE, vv=vv, valid_len=valid_len)
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES) == (0, 0)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)


def test_bf16_backward_rounds_where_the_kernel_does():
    """In bf16 the plain backward rounds P and dS to bf16 before their
    products, as the Pallas kernel does: they agree to bf16 accuracy, held
    at 2% of the gradient's largest entry."""
    qkv, g = _inputs(11, 256)
    jq, jg = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    ref = np.asarray(jpa._flash_packed_bwd_kernelized(jq, jg, HEADS, SCALE, None),
                     np.float32)
    out = pa.flash_mha_packed_bwd_reference(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16(), HEADS, SCALE)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.02 * np.abs(ref).max())


def test_no_graph_without_grad():
    qkv, _ = _inputs(3, 20)
    t = torch.from_numpy(qkv)
    assert pa.flash_mha_packed(t, HEADS, SCALE).grad_fn is None
    with torch.no_grad():
        t.requires_grad_(True)
        assert pa.flash_mha_packed(t, HEADS, SCALE).grad_fn is None
