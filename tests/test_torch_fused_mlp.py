"""Port's fused LN -> MLP -> residual twin vs the JAX Pallas kernel
(interpret mode, bf16) and the JAX XLA chain (fp32); the plain versions of
the three stages the kernel runs, against both.

The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against this twin there); on a CPU
tensor the wrapper runs the twin and launches nothing.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import layers as jlayers
from aa_clip_iqm_tpu.ops import pallas_mlp as pm
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import fused_mlp
from aa_clip_iqm_tpu_torch.ops import gemm as tgemm
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops.compare import bf16_close, bf16_error
from aa_clip_iqm_tpu_torch.utils import profiling

SHAPES = [(130, 128, 512), (640, 256, 1024)]
ACTS = ["gelu", "quick_gelu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    pm.INTERPRET = True
    yield
    pm.INTERPRET = False


def _params(seed, m, d, h):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    ln = {"scale": 1.0 + 0.1 * w(d), "bias": 0.1 * w(d)}
    mlp = {"c_fc": {"w": w(d, h), "b": w(h)},
           "c_proj": {"w": w(h, d), "b": w(d)}}
    x = rng.standard_normal((m, d)).astype(np.float32)
    return ln, mlp, x


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", SHAPES)
def test_twin_matches_jax_kernel_bf16(m, d, h, act):
    ln, mlp, x = _params(m + d, m, d, h)
    ref = pm.ln_mlp_residual(_to(ln, jnp.asarray), _to(mlp, jnp.asarray),
                             jnp.asarray(x, jnp.bfloat16),
                             jlayers.ACTIVATIONS[act])
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual(
        _to(ln, torch.from_numpy), _to(mlp, torch.from_numpy),
        torch.from_numpy(x).to(torch.bfloat16), tlayers.ACTIVATIONS[act])
    assert _build.launches(before) == {}
    assert out.shape == (m, d) and out.dtype == torch.bfloat16
    # bf16 rounding dominates (the tolerance of tests/test_pallas_mlp.py).
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", SHAPES)
def test_twin_matches_xla_chain_fp32(m, d, h, act):
    ln, mlp, x = _params(m * d, m, d, h)
    ref = pm._xla_chain(_to(ln, jnp.asarray), _to(mlp, jnp.asarray),
                        jnp.asarray(x), jlayers.ACTIVATIONS[act], 1e-5)
    out = fused_mlp.ln_mlp_residual_reference(
        _to(ln, torch.from_numpy), _to(mlp, torch.from_numpy),
        torch.from_numpy(x), tlayers.ACTIVATIONS[act])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_batched_shape_roundtrip():
    ln, mlp, x = _params(3, 140, 128, 512)
    xt = torch.from_numpy(x).reshape(2, 70, 128)
    out = fused_mlp.ln_mlp_residual(_to(ln, torch.from_numpy),
                                    _to(mlp, torch.from_numpy), xt, tlayers.gelu)
    assert out.shape == xt.shape and out.dtype == xt.dtype


def test_wrapper_refuses_other_devices():
    ln, mlp, _ = _params(4, 8, 128, 512)
    x = torch.empty((8, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.ln_mlp_residual(_to(ln, torch.from_numpy),
                                  _to(mlp, torch.from_numpy), x, tlayers.gelu)


# The three stages the bf16 kernel runs on the card (the LayerNorm pass,
# GEMM 1 with bias and activation, GEMM 2 with bias and residual), each
# through its plain version in ops/gemm.py.

def _stages(ln, mlp, x, act):
    xin = tlayers.layer_norm(ln, x)
    hid = tgemm.gemm_bias_act_reference(xin, mlp["c_fc"]["w"], mlp["c_fc"]["b"], act)
    return xin, hid, tgemm.gemm_bias_residual_reference(hid, mlp["c_proj"]["w"],
                                                        mlp["c_proj"]["b"], x)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", SHAPES)
def test_stages_equal_twin_fp32(m, d, h, act):
    """In fp32 the stages round nowhere, so their composition is the twin
    bit for bit (and ln_mlp_residual_stages is that composition)."""
    ln, mlp, x = _params(m + h, m, d, h)
    ln, mlp, xt = _to(ln, torch.from_numpy), _to(mlp, torch.from_numpy), torch.from_numpy(x)
    act_t = tlayers.ACTIVATIONS[act]
    out = _stages(ln, mlp, xt, act_t)[2]
    assert torch.equal(out, fused_mlp.ln_mlp_residual_reference(ln, mlp, xt, act_t))
    assert torch.equal(out, fused_mlp.ln_mlp_residual_stages(ln, mlp, xt, act_t))


@pytest.mark.parametrize("tile_n", [0, 128, 256])
def test_core_tile_widths_give_the_plain_version_on_cpu(tile_n):
    """The tile width is an order of the card's work alone: on a CPU tensor
    the core-alone product is its plain version, bit for bit, for every
    activation and every width the core takes."""
    gen = torch.Generator().manual_seed(22)
    a = torch.randn((37, 128), generator=gen).to(torch.bfloat16)
    w = (torch.randn((128, 256), generator=gen) * 128 ** -0.5).to(torch.bfloat16)
    b = torch.randn((256,), generator=gen) * 0.1
    for act in (None, tlayers.gelu, tlayers.quick_gelu):
        assert torch.equal(tgemm.gemm_bias_act(a, w, b, act, tile_n),
                           tgemm.gemm_bias_act_reference(a, w, b, act))


@pytest.mark.parametrize("base,n", [(-1, 16), (0, 0), ((1 << 32) - 8, 16)])
def test_gelu_check_refuses_a_range_outside_the_floats(base, n):
    """The GELU check counts over float bit patterns, 0 .. 2^32 - 1: an
    empty range or one outside them is refused before any library loads."""
    before = profiling.counters()
    with pytest.raises(ValueError, match="not a range"):
        tgemm.gelu_mismatches("cpu", base, n)
    assert _build.launches(before) == {}


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", SHAPES)
def test_stages_round_as_jax_kernel_bf16(m, d, h, act):
    """In bf16 the stages round where JAX's Pallas kernel rounds (LN(x),
    the hidden layer after bias and activation, the output once): held to
    it within 2 bf16 ulps, RMS 0.1, since only the fp32 summation order
    differs (the twin, which rounds the hidden layer before the activation
    and the MLP branch before the residual add, is held to it only at
    0.05), and at the file's 0.05. GEMM 1 without its activation is
    ``linear`` bit for bit, and the composition is held to the twin in bf16
    ulps as the kernel is on the card."""
    ln, mlp, x = _params(m + d + h, m, d, h)
    act_j, act_t = jlayers.ACTIVATIONS[act], tlayers.ACTIVATIONS[act]
    ref = pm.ln_mlp_residual(_to(ln, jnp.asarray), _to(mlp, jnp.asarray),
                             jnp.asarray(x, jnp.bfloat16), act_j)
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    ln, mlp = _to(ln, torch.from_numpy), _to(mlp, torch.from_numpy)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xin, _, out = _stages(ln, mlp, xt, act_t)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, fused_mlp.ln_mlp_residual_stages(ln, mlp, xt, act_t))
    assert torch.equal(tgemm.gemm_bias_act_reference(xin, mlp["c_fc"]["w"], mlp["c_fc"]["b"]),
                       tlayers.linear(mlp["c_fc"], xin))
    max_ulps, rms_ulps = bf16_error(out, ref, xt)
    assert max_ulps <= 2.0 and rms_ulps <= 0.1, (max_ulps, rms_ulps)
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), rtol=0.05, atol=0.05)
    twin = fused_mlp.ln_mlp_residual_reference(ln, mlp, xt, act_t)
    assert bf16_close(out, twin, xt), bf16_error(out, twin, xt)
