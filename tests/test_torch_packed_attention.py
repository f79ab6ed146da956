"""Port's packed-qkv attention twin vs the JAX Pallas kernel (interpret mode).

The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against this twin there); on a CPU
tensor the wrapper runs the twin and launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import pallas_attention as pa
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import packed_attention as tpa
from aa_clip_iqm_tpu_torch.ops.compare import bf16_close, bf16_error
from aa_clip_iqm_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    pa.INTERPRET = True
    yield
    pa.INTERPRET = False


def _qkv(seed, b, seq_len, w):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, seq_len, 3 * w)).astype(np.float32)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len", [256, 300])
def test_twin_matches_jax_kernel(seq_len, vv, valid):
    b, heads, hd = 2, 2, 64
    qkv = _qkv(seq_len + 2 * vv + valid, b, seq_len, heads * hd)
    valid_len = seq_len - 20 if valid else None
    scale = hd ** -0.5
    ref = np.asarray(pa.flash_mha_packed(jnp.asarray(qkv), heads, scale, vv,
                                         valid_len))
    before = profiling.counters()
    out = tpa.flash_mha_packed(torch.from_numpy(qkv), heads, scale, vv=vv,
                               valid_len=valid_len)
    assert _build.launches(before) == {}
    assert out.shape == (b, seq_len, heads * hd) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("vv", [False, True])
def test_twin_matches_jax_reference_bf16(vv):
    """bf16 in, bf16 out: same rounding points as _packed_reference."""
    b, heads, hd, seq_len = 1, 4, 32, 77
    qkv = _qkv(5, b, seq_len, heads * hd)
    ref = pa._packed_reference(jnp.asarray(qkv, jnp.bfloat16), heads,
                               hd ** -0.5, vv, valid_len=70)
    out = tpa.flash_mha_packed_reference(
        torch.from_numpy(qkv).to(torch.bfloat16), heads, hd ** -0.5, vv=vv,
        valid_len=70)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2)


def test_wrapper_refuses_other_devices():
    qkv = torch.empty((1, 8, 3 * 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.flash_mha_packed(qkv, 1, 0.125)


@pytest.mark.parametrize("valid", [None, "one", "short"])
@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len", [129, 200, 300, 1370])
def test_walk_stages_match_jax_kernel_twin_and_lse(seq_len, vv, valid):
    """The plain version of the forward kernel's tile walk on the packed
    layout: in fp32 against JAX's packed kernel (``_row_kernel_grouped``,
    interpret mode) at rtol 2e-4 / atol 2e-5; in bf16 against the twin within
    the kernels' gate (6 ulps, RMS 1), and its log-sum-exp against
    ``packed_lse_reference`` to 1e-5 relative. ``valid``: keys at or past 1
    or L - 70 masked."""
    b, heads, hd = 2, 2, 64
    valid_len = {None: None, "one": 1, "short": seq_len - 70}[valid]
    qkv = _qkv(seq_len + 3 * vv + 7, b, seq_len, heads * hd)
    scale = hd ** -0.5
    ref = np.asarray(pa.flash_mha_packed(jnp.asarray(qkv), heads, scale, vv, valid_len))
    out = tpa.flash_mha_packed_stages(torch.from_numpy(qkv), heads, scale, vv, valid_len)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)
    qb = torch.from_numpy(qkv).to(torch.bfloat16)
    out, lse = tpa.flash_mha_packed_stages(qb, heads, scale, vv, valid_len, with_lse=True)
    twin = tpa.flash_mha_packed_reference(qb, heads, scale, vv, valid_len)
    assert out.dtype == torch.bfloat16 and bf16_close(out, twin), bf16_error(out, twin)
    want = tpa.packed_lse_reference(qb, heads, scale, vv, valid_len)
    assert lse.shape == (b, heads, seq_len)
    assert ((lse - want).abs() <= 1e-5 * want.abs()).all()
