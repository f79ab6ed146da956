"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an H100 and nvcc run

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""
import pytest
import torch

from aa_clip_iqm_tpu_torch.ops import fused_mlp, packed_attention as pa, quant
from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error
from aa_clip_iqm_tpu_torch.ops.layers import gelu, quick_gelu

pytestmark = pytest.mark.cuda

# fp32: max abs error <= 1e-4 * max(1, max|twin|). bf16: ops/compare.py.
F32_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(out, ref, base=None):
    torch.cuda.synchronize()
    if ref.dtype == torch.bfloat16:
        max_ulps, rms_ulps = bf16_error(out, ref, base)
        assert max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= F32_TOL * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,hd,seq_len,vv,valid_len", [
    (16, 64, 1370, False, None),
    (16, 64, 1370, True, 1360),
    (2, 64, 77, False, 70),
    (4, 64, 17, False, None),
    (2, 64, 200, True, None),
    (4, 64, 65, False, 1),
])
def test_packed_attention_matches_twin(dev, dtype, heads, hd, seq_len, vv, valid_len):
    gen = torch.Generator(device=dev).manual_seed(seq_len + hd)
    qkv = torch.randn((2, seq_len, 3 * heads * hd), generator=gen, device=dev).to(dtype)
    before = pa.LAUNCHES
    out = pa.flash_mha_packed(qkv, heads, hd ** -0.5, vv=vv, valid_len=valid_len)
    assert pa.LAUNCHES == before + 1
    _check(out, pa.flash_mha_packed_reference(qkv, heads, hd ** -0.5, vv=vv,
                                              valid_len=valid_len))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,h,act", [
    (1000, 1024, 4096, gelu),
    (1000, 768, 3072, quick_gelu),
    (33, 64, 256, gelu),
])
def test_ln_mlp_residual_matches_twin(dev, dtype, m, d, h, act):
    gen = torch.Generator(device=dev).manual_seed(m + d)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    mlp = {"c_fc": {"w": rnd(d, h, std=d ** -0.5).to(dtype), "b": rnd(h, std=0.02)},
           "c_proj": {"w": rnd(h, d, std=h ** -0.5).to(dtype), "b": rnd(d, std=0.02)}}
    x = rnd(m, d).to(dtype)
    before = fused_mlp.LAUNCHES
    out = fused_mlp.ln_mlp_residual(ln, mlp, x, act)
    assert fused_mlp.LAUNCHES == before + 1
    _check(out, fused_mlp.ln_mlp_residual_reference(ln, mlp, x, act), x)


def _int8_case(dev, m, d, h, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    mlp = {"c_fc": {"w": rnd(d, h, std=d ** -0.5), "b": rnd(h, std=0.02)},
           "c_proj": {"w": rnd(h, d, std=h ** -0.5), "b": rnd(d, std=0.02)}}
    qmlp = {k: quant.quantize_linear_params(p) for k, p in mlp.items()}
    return ln, qmlp, rnd(m, d).to(torch.bfloat16)


@pytest.mark.parametrize("m,d,h,act", [
    (10960, 1024, 4096, gelu),        # ViT-L/518, batch 8
    (1370, 1024, 4096, quick_gelu),   # batch 1
    (1000, 768, 3072, gelu),          # the text tower's widths
    (77, 128, 384, quick_gelu),       # an odd row count, 128-wide chunks
    (333, 256, 1024, gelu),
    (5, 128, 512, gelu),              # fewer rows than a tile
])
def test_ln_mlp_residual_int8_matches_twin(dev, m, d, h, act):
    """Integer products are exact, so kernel and twin differ only where a
    float32 sum of the LayerNorm, taken in another order, flips a rounding:
    held on y - x in bf16 ulps like the float kernel."""
    ln, qmlp, x = _int8_case(dev, m, d, h, m + h)
    assert fused_mlp.ln_mlp_residual_int8_ok(x, qmlp, act)
    before = (fused_mlp.INT8_LAUNCHES, fused_mlp.LAUNCHES)
    out = fused_mlp.ln_mlp_residual_int8(ln, qmlp, x, act)
    assert (fused_mlp.INT8_LAUNCHES, fused_mlp.LAUNCHES) == (before[0] + 1, before[1])
    _check(out, fused_mlp.ln_mlp_residual_int8_reference(ln, qmlp, x, act), x)
    batched = fused_mlp.ln_mlp_residual_int8(ln, qmlp, x.reshape(1, m, d), act)
    assert torch.equal(batched.reshape(m, d), out)


def test_int8_wrapper_refuses_bad_inputs(dev):
    ln, qmlp, x = _int8_case(dev, 64, 128, 512, 1)
    with pytest.raises(TypeError, match="dtype"):
        fused_mlp.ln_mlp_residual_int8(ln, qmlp, x.float(), gelu)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp.ln_mlp_residual_int8(ln, qmlp, x.t().contiguous().t(), gelu)
    flipped = {"c_fc": dict(qmlp["c_fc"], w_q=qmlp["c_fc"]["w_q"].t().contiguous().t()),
               "c_proj": qmlp["c_proj"]}
    with pytest.raises(ValueError, match="c_fc w_q must be contiguous"):
        fused_mlp.ln_mlp_residual_int8(ln, flipped, x, gelu)
    wrong = {"c_fc": dict(qmlp["c_fc"], w_q=qmlp["c_fc"]["w_q"].to(torch.int32)),
             "c_proj": qmlp["c_proj"]}
    with pytest.raises(TypeError, match="c_fc w_q"):
        fused_mlp.ln_mlp_residual_int8(ln, wrong, x, gelu)
    half = {"c_fc": dict(qmlp["c_fc"], scale=qmlp["c_fc"]["scale"].double()),
            "c_proj": qmlp["c_proj"]}
    with pytest.raises(TypeError, match="c_fc scale"):
        fused_mlp.ln_mlp_residual_int8(ln, half, x, gelu)
    with pytest.raises(ValueError, match="ln bias"):
        fused_mlp.ln_mlp_residual_int8(dict(ln, bias=ln["bias"].cpu()), qmlp, x, gelu)
    with pytest.raises(ValueError, match="activation"):
        fused_mlp.ln_mlp_residual_int8(ln, qmlp, x, torch.relu)
    wide_ln, wide, wide_x = _int8_case(dev, 8, 1280, 512, 2)
    with pytest.raises(ValueError, match="not supported"):
        fused_mlp.ln_mlp_residual_int8(wide_ln, wide, wide_x, gelu)


def test_wrappers_refuse_bad_inputs(dev):
    qkv = torch.zeros((1, 8, 3 * 64), device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        pa.flash_mha_packed(qkv, 1, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        pa.flash_mha_packed(torch.zeros((1, 3 * 64, 8), device=dev).transpose(1, 2), 1, 0.125)
    with pytest.raises(ValueError, match="head width"):
        pa.flash_mha_packed(torch.zeros((1, 8, 3 * 128), device=dev), 1, 0.125)
    ln = {"scale": torch.ones(64, device=dev), "bias": torch.zeros(64)}
    mlp = {"c_fc": {"w": torch.zeros(64, 256, device=dev), "b": torch.zeros(256, device=dev)},
           "c_proj": {"w": torch.zeros(256, 64, device=dev), "b": torch.zeros(64, device=dev)}}
    with pytest.raises(ValueError, match="ln bias"):
        fused_mlp.ln_mlp_residual(ln, mlp, torch.zeros(4, 64, device=dev), gelu)
