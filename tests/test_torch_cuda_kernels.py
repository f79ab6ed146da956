"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an H100 and nvcc run

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""
import pytest
import torch

from aa_clip_iqm_tpu_torch.ops import attn_block, flash_attention as fa, fused_mlp, gemm, quant
from aa_clip_iqm_tpu_torch.ops import packed_attention as pa
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
@pytest.mark.parametrize("seq_len,vv,valid_len", [
    (1370, False, None),
    (1370, True, 1300),
    (77, False, 70),
    (17, True, None),
])
def test_packed_attention_lse_matches_plain(dev, dtype, seq_len, vv, valid_len):
    """B1's optional log-sum-exp, against the plain logsumexp of the masked
    scaled scores to 1e-5 relative; the output is the same with it on."""
    gen = torch.Generator(device=dev).manual_seed(seq_len + 5)
    qkv = torch.randn((2, seq_len, 3 * 4 * 64), generator=gen, device=dev).to(dtype)
    out, lse = pa._forward(qkv, 4, 0.125, vv, valid_len, with_lse=True)
    want = pa.packed_lse_reference(qkv, 4, 0.125, vv, valid_len)
    torch.cuda.synchronize()
    assert lse.shape == (2, 4, seq_len) and lse.dtype == torch.float32
    assert ((lse - want).abs() <= 1e-5 * want.abs()).all()
    assert torch.equal(out, pa._forward(qkv, 4, 0.125, vv, valid_len))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,h,act", [
    (1000, 1024, 4096, gelu),
    (1000, 768, 3072, quick_gelu),
    (33, 64, 256, gelu),
    (1, 1024, 4096, gelu),            # ragged M: one row of a 128-row tile
    (77, 1024, 4096, quick_gelu),     # one text sequence
    (1370, 1024, 4096, gelu),         # 10 x 128 + 90
    (300, 128, 384, gelu),            # h % 256 != 0: the generic kernel for bf16 too
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
    if dtype == torch.bfloat16:
        # The stages' plain version rounds where the kernel does.
        _check(out, fused_mlp.ln_mlp_residual_stages(ln, mlp, x, act), x)


@pytest.mark.parametrize("m,n,k,tile_n", [
    (128, 128, 64, 128),              # one tile, one k-slice
    (1, 256, 64, 256),                # one row
    (200, 384, 128, 128),             # ragged M, three 128-wide tiles
    (1370, 1024, 1024, 256),          # 10 x 128 + 90 rows
    (1370, 1024, 1024, 128),
    (777, 3072, 768, 0),              # the text tower's GEMM 1
    (333, 768, 3072, 0),              # ... and GEMM 2 (N % 256 == 0: 256 wide)
])
def test_gemm_core_matches_plain(dev, m, n, k, tile_n):
    """The wgmma GEMM core alone, both epilogues and every activation,
    against its plain versions (ops/gemm.py) in bf16 ulps."""
    gen = torch.Generator(device=dev).manual_seed(m + n + k)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    a = rnd(m, k).to(torch.bfloat16)
    w = rnd(k, n, std=k ** -0.5).to(torch.bfloat16)
    b, res = rnd(n, std=0.1), rnd(m, n).to(torch.bfloat16)
    before = gemm.LAUNCHES
    for act in (None, gelu, quick_gelu):
        _check(gemm.gemm_bias_act(a, w, b, act, tile_n), gemm.gemm_bias_act_reference(a, w, b, act))
    _check(gemm.gemm_bias_residual(a, w, b, res, tile_n),
           gemm.gemm_bias_residual_reference(a, w, b, res), res)
    assert gemm.LAUNCHES == before + 4
    with pytest.raises(ValueError, match="not supported"):
        gemm.gemm_bias_act(a[:, :k - 8].contiguous(), w[:k - 8].contiguous(), b)


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


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,heads,seq_len,valid_len", [
    (2, 16, 1370, None),              # ViT-L/518
    (1, 16, 1370, 1300),              # batch 1, keys masked short of L
    (2, 2, 77, 70),
    (2, 4, 17, None),                 # less than one tile
    (1, 2, 200, 129),                 # a masked key tile and a ragged tail
    (2, 4, 65, 1),
])
def test_packed_attention_bwd_matches_plain(dev, dtype, batch, heads, seq_len, valid_len):
    hd = 64
    gen = torch.Generator(device=dev).manual_seed(seq_len + heads)
    qkv = torch.randn((batch, seq_len, 3 * heads * hd), generator=gen, device=dev).to(dtype)
    d_out = torch.randn((batch, seq_len, heads * hd), generator=gen, device=dev).to(dtype)
    _, lse = pa._forward(qkv, heads, hd ** -0.5, False, valid_len, with_lse=True)
    with pytest.raises(ValueError, match="lse"):
        pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5, valid_len=valid_len)
    before = (pa.BWD_LAUNCHES, pa.LAUNCHES)
    out = pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5, valid_len=valid_len, lse=lse)
    assert (pa.BWD_LAUNCHES, pa.LAUNCHES) == (before[0] + 1, before[1])
    ref = pa.flash_mha_packed_bwd_reference(qkv, d_out, heads, hd ** -0.5,
                                            valid_len=valid_len)
    stages = pa.flash_mha_packed_bwd_stages(qkv, d_out, heads, hd ** -0.5, False, valid_len, lse)
    w = heads * hd
    for sec in range(3):              # dq, dk, dv each on its own scale
        _check(out[..., sec * w:(sec + 1) * w], ref[..., sec * w:(sec + 1) * w])
        # With one key P is 1 within an fp32 rounding, so dS = P (dP - P dP)
        # is rounding noise in the kernel and in the stages alike and exactly
        # zero in the plain backward: only the latter is held there.
        if valid_len != 1:
            _check(out[..., sec * w:(sec + 1) * w], stages[..., sec * w:(sec + 1) * w])
    assert torch.equal(out, pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5,
                                                    valid_len=valid_len, lse=lse))


def test_tensor_map_kernels_as_a_thread_s_first_call(dev):
    """The kernels that encode TMA tensor maps work as the first CUDA call
    of a new thread (an autograd worker's, say), where no context has been
    made current yet: B4's backward and the GEMM core alone."""
    import threading

    gen = torch.Generator(device=dev).manual_seed(4)
    qkv = torch.randn((1, 130, 3 * 128), generator=gen, device=dev).to(torch.bfloat16)
    g = torch.randn((1, 130, 128), generator=gen, device=dev).to(torch.bfloat16)
    _, lse = pa._forward(qkv, 2, 0.125, False, None, with_lse=True)
    a = torch.randn((200, 256), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((256, 384), generator=gen, device=dev).to(torch.bfloat16)
    calls = {"bwd": lambda: pa.flash_mha_packed_bwd(qkv, g, 2, 0.125, lse=lse),
             "gemm_f32": lambda: gemm.gemm_f32(a, w)}
    got = {}

    def run(name):
        try:
            got[name] = calls[name]()
            torch.cuda.synchronize()
        except RuntimeError as exc:
            got[name] = exc

    for name in calls:
        t = threading.Thread(target=run, args=(name,))
        t.start()
        t.join()
        assert not isinstance(got[name], Exception), got[name]
    _check(got["bwd"], pa.flash_mha_packed_bwd(qkv, g, 2, 0.125, lse=lse))
    _check(got["gemm_f32"], gemm.gemm_f32_reference(a, w))


def test_packed_attention_autograd_on_the_card(dev):
    """The Function's backward launches the B4 kernel, and for the
    value-value variant the B6 kernel."""
    gen = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((1, 130, 3 * 128), generator=gen, device=dev).to(torch.bfloat16)
    qkv.requires_grad_(True)
    g = torch.randn((1, 130, 128), generator=gen, device=dev).to(torch.bfloat16)
    before = (pa.LAUNCHES, pa.BWD_LAUNCHES, pa.VV_BWD_LAUNCHES)
    out = pa.flash_mha_packed(qkv, 2, 0.125)
    assert out.grad_fn is not None
    (grad,) = torch.autograd.grad(out, qkv, g)
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES, pa.VV_BWD_LAUNCHES) == (
        before[0] + 1, before[1] + 1, before[2])
    _check(grad, pa.flash_mha_packed_bwd_reference(qkv.detach(), g, 2, 0.125))
    out = pa.flash_mha_packed(qkv, 2, 0.125, vv=True)
    (grad,) = torch.autograd.grad(out, qkv, g)
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES, pa.VV_BWD_LAUNCHES) == (
        before[0] + 2, before[1] + 1, before[2] + 1)
    assert not grad[..., :256].any()
    _check(grad[..., 256:], pa.flash_mha_packed_bwd_reference(
        qkv.detach(), g, 2, 0.125, vv=True)[..., 256:])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("batch,heads,seq_len,valid_len", [
    (2, 16, 1370, None),              # ViT-L/518
    (1, 16, 1370, 1300),              # keys masked short of L
    (2, 2, 77, 70),
    (2, 4, 17, None),                 # less than one tile
    (1, 2, 200, 129),                 # a masked key tile and a ragged tail
])
def test_packed_attention_vv_bwd_matches_plain(dev, dtype, batch, heads, seq_len, valid_len):
    """B6: dA in the value columns (value, query and key terms summed in fp32,
    rounded once), zeros in the q and k columns, the same bits twice."""
    hd = 64
    gen = torch.Generator(device=dev).manual_seed(seq_len + heads + 1)
    qkv = torch.randn((batch, seq_len, 3 * heads * hd), generator=gen, device=dev).to(dtype)
    d_out = torch.randn((batch, seq_len, heads * hd), generator=gen, device=dev).to(dtype)
    _, lse = pa._forward(qkv, heads, hd ** -0.5, True, valid_len, with_lse=True)
    before = (pa.VV_BWD_LAUNCHES, pa.BWD_LAUNCHES)
    out = pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5, vv=True, valid_len=valid_len,
                                  lse=lse)
    assert (pa.VV_BWD_LAUNCHES, pa.BWD_LAUNCHES) == (before[0] + 1, before[1])
    ref = pa.flash_mha_packed_bwd_reference(qkv, d_out, heads, hd ** -0.5, vv=True,
                                            valid_len=valid_len)
    w = heads * hd
    assert not out[..., :2 * w].any()
    _check(out[..., 2 * w:], ref[..., 2 * w:])
    _check(out[..., 2 * w:], pa.flash_mha_packed_bwd_stages(
        qkv, d_out, heads, hd ** -0.5, True, valid_len, lse)[..., 2 * w:])
    again = pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5, vv=True, valid_len=valid_len,
                                    lse=lse)
    assert torch.equal(out, again)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bh,seq_len", [
    (32, 1370),                       # ViT-L/518 heads at batch 2
    (16, 8282),                       # ViT-L/14 at 1274 px, batch 1
    (4, 300),                         # a ragged tail
    (3, 17),                          # less than one tile
])
def test_flash_attention_matches_twin(dev, dtype, bh, seq_len):
    """B7 on (BH, L, 64), the kernel entry itself (flash_mha sends fewer than
    256 tokens to the plain sdpa)."""
    gen = torch.Generator(device=dev).manual_seed(bh + seq_len)
    q, k, v = (torch.randn((bh, seq_len, 64), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    before = fa.LAUNCHES
    out = fa._forward(q, k, v, 0.125)
    assert fa.LAUNCHES == before + 1
    _check(out, fa.flash_mha_reference(q, k, v, 0.125))


def test_flash_attention_autograd_on_the_card(dev):
    """flash_mha on (B, H, L, hd): the forward kernel, the plain recompute's
    gradient, and value-value (one tensor three times)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((2, 4, 300, 64), generator=gen, device=dev).requires_grad_(True)
               for _ in range(3))
    g = torch.randn((2, 4, 300, 64), generator=gen, device=dev)
    before = fa.LAUNCHES
    out = fa.flash_mha(q, k, v, 0.125)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert fa.LAUNCHES == before + 1
    want = torch.autograd.grad(fa.flash_mha_reference(q, k, v, 0.125), (q, k, v), g)
    for a, b in zip(got, want):
        _check(a, b)
    (gv,) = torch.autograd.grad(fa.flash_mha(v, v, v, 0.125), v, g)
    (wv,) = torch.autograd.grad(fa.flash_mha_reference(v, v, v, 0.125), v, g)
    _check(gv, wv)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_mha(*(torch.zeros((1, 1, 256, 32), device=dev) for _ in range(3)), 0.125)


def _block_case(dev, d, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    attn = {"qkv": {"w": rnd(d, 3 * d, std=d ** -0.5).to(torch.bfloat16), "b": rnd(3 * d, std=0.1)},
            "out": {"w": rnd(d, d, std=d ** -0.5).to(torch.bfloat16), "b": rnd(d, std=0.1)}}
    return ln, attn, gen


@pytest.mark.parametrize("batch,seq_len,d,vv,valid_len", [
    (2, 1370, 1024, False, None),     # ViT-L/518
    (2, 1370, 1024, True, None),
    (1, 1370, 1024, True, 1300),      # keys masked short of L
    (3, 300, 256, False, None),       # 4 heads, a ragged tail
    (2, 17, 768, True, None),         # ViT-B widths, less than one tile
    (8, 1370, 1024, False, 1360),     # batch 8, keys masked
    (1, 1370, 1024, False, None),     # batch 1: 11 row tiles, 10 full
    (1, 200, 384, True, None),        # 6 heads: no longer a multiple of 4
])
def test_ln_attn_residual_matches_twin(dev, batch, seq_len, d, vv, valid_len):
    """B8, held on y - x like the MLP kernels."""
    ln, attn, gen = _block_case(dev, d, seq_len + d)
    x = torch.randn((batch, seq_len, d), generator=gen, device=dev).to(torch.bfloat16)
    heads = d // 64
    assert attn_block.ln_attn_residual_ok(x, attn, heads)
    before = attn_block.LAUNCHES
    out = attn_block.ln_attn_residual(ln, attn, x, heads, vv, valid_len)
    assert attn_block.LAUNCHES == before + 1
    _check(out, attn_block.ln_attn_residual_reference(ln, attn, x, heads, vv, valid_len), x)
    _check(out, attn_block.ln_attn_residual_stages(ln, attn, x, heads, vv, valid_len), x)


def test_ln_attn_residual_autograd_on_the_card(dev):
    """The Function's forward is the kernel; its backward differentiates the
    plain chain, for x and the parameters."""
    ln, attn, gen = _block_case(dev, 256, 5)
    attn["out"]["b"].requires_grad_(True)
    x = torch.randn((2, 300, 256), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
    g = torch.randn((2, 300, 256), generator=gen, device=dev).to(torch.bfloat16)
    before = attn_block.LAUNCHES
    y = attn_block.ln_attn_residual(ln, attn, x, 4, True)
    dx, db = torch.autograd.grad(y, (x, attn["out"]["b"]), g)
    assert attn_block.LAUNCHES == before + 1
    ref = attn_block.ln_attn_residual_reference(ln, attn, x, 4, True)
    rdx, rdb = torch.autograd.grad(ref, (x, attn["out"]["b"]), g)
    _check(dx, rdx, g)
    _check(db, rdb)
    with pytest.raises(ValueError, match="heads of 64"):
        attn_block.ln_attn_residual(*_block_case(dev, 256, 6)[:2],
                                    torch.zeros((1, 8, 256), device=dev, dtype=torch.bfloat16), 2)


def _float_case(dev, dtype, m, d, h, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    ln = {"scale": 1.0 + 0.1 * rnd(d), "bias": 0.1 * rnd(d)}
    mlp = {"c_fc": {"w": rnd(d, h, std=d ** -0.5).to(dtype), "b": rnd(h, std=0.02)},
           "c_proj": {"w": rnd(h, d, std=h ** -0.5).to(dtype), "b": rnd(d, std=0.02)}}
    return ln, mlp, rnd(m, d).to(dtype), rnd(m, d).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d,h,act", [
    (1000, 1024, 4096, gelu),         # the vision tower's widths
    (1000, 768, 3072, quick_gelu),    # the text tower's
    (77, 256, 512, gelu),             # an odd row count
    (33, 64, 256, gelu),              # the generic kernel for bf16 too
    (5, 128, 384, quick_gelu),
    (1, 1024, 4096, gelu),            # ragged M: one row of a 128-row tile
    (1370, 1024, 4096, quick_gelu),   # 10 x 128 + 90
])
def test_ln_mlp_residual_dx_matches_plain(dev, dtype, m, d, h, act):
    ln, mlp, x, g = _float_case(dev, dtype, m, d, h, m + d)
    before = (fused_mlp.DX_LAUNCHES, fused_mlp.LAUNCHES)
    out = fused_mlp.ln_mlp_residual_dx(ln, mlp, x, g, act)
    assert (fused_mlp.DX_LAUNCHES, fused_mlp.LAUNCHES) == (before[0] + 1, before[1])
    # Held on dx - g: the residual cotangent g is the same in both.
    _check(out, fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x, g, act), g)
    if dtype == torch.bfloat16:
        # The stages' plain version rounds where the kernel does.
        _check(out, fused_mlp.ln_mlp_residual_dx_stages(ln, mlp, x, g, act), g)


@pytest.mark.parametrize("m,n,k", [
    (128, 128, 64),                   # one tile, one k-slice
    (1, 256, 128),                    # one row
    (200, 384, 128),                  # ragged M, three 128-wide tiles
    (1370, 1024, 4096),               # B5's GEMM 3 at one 518 px image
    (777, 3072, 768),                 # the text tower's dual GEMM
])
def test_gemm_core_new_modes_match_plain(dev, m, n, k):
    """The core's modes that B5 adds, alone, against their plain versions
    (ops/gemm.py): the fp32-store epilogue with W read N-major and K-major
    (fp32: max abs error <= 1e-4 of the largest entry, sums in another
    order), and the dual mode with the act' epilogue (bf16 ulps)."""
    gen = torch.Generator(device=dev).manual_seed(m + n + k + 1)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    a, a2 = rnd(m, k).to(torch.bfloat16), rnd(m, k).to(torch.bfloat16)
    w = rnd(k, n, std=k ** -0.5).to(torch.bfloat16)
    w2t = rnd(n, k, std=k ** -0.5).to(torch.bfloat16)
    scale, b = 1.0 + 0.1 * rnd(n), rnd(n, std=0.1)
    before = gemm.LAUNCHES
    for tile_n in (0, 128):
        _check(gemm.gemm_f32(a, w, scale, tile_n=tile_n), gemm.gemm_f32_reference(a, w, scale))
        _check(gemm.gemm_f32(a, w2t, None, w_kmajor=True, tile_n=tile_n),
               gemm.gemm_f32_reference(a, w2t, None, w_kmajor=True))
    for act in (gelu, quick_gelu):
        _check(gemm.gemm_dual_dact(a, w, b, a2, w2t, act),
               gemm.gemm_dual_dact_reference(a, w, b, a2, w2t, act))
    assert gemm.LAUNCHES == before + 6
    with pytest.raises(ValueError, match="not supported"):
        gemm.gemm_f32(a[:, :k - 8].contiguous(), w[:k - 8].contiguous())


def test_fused_mlp_autograd_on_the_card(dev):
    """The frozen Function goes forward through the fused kernel and backward
    through the dx kernel; the general one recomputes the plain chain."""
    ln, mlp, x, g = _float_case(dev, torch.bfloat16, 200, 256, 512, 9)
    x.requires_grad_(True)
    before = (fused_mlp.LAUNCHES, fused_mlp.DX_LAUNCHES)
    y = fused_mlp.ln_mlp_residual_frozen(ln, mlp, x, gelu)
    (dx,) = torch.autograd.grad(y, x, g)
    assert (fused_mlp.LAUNCHES, fused_mlp.DX_LAUNCHES) == (before[0] + 1, before[1] + 1)
    ref = fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x.detach(), g, gelu)
    _check(dx, ref, g)
    mlp["c_fc"]["b"].requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        fused_mlp.ln_mlp_residual_frozen(ln, mlp, x, gelu)
    y = fused_mlp.ln_mlp_residual(ln, mlp, x, gelu)
    dx2, db = torch.autograd.grad(y, [x, mlp["c_fc"]["b"]], g)
    assert (fused_mlp.LAUNCHES, fused_mlp.DX_LAUNCHES) == (before[0] + 2, before[1] + 1)
    assert db.shape == mlp["c_fc"]["b"].shape and torch.isfinite(db).all()
    _check(dx2, ref, g)


# --------------------------------------------------------------------------
# A stage-2 step on the card against the same step on the CPU
# --------------------------------------------------------------------------

def _stage2_step(device, dtype, patch_dropout=0.0, quantize=None, **train_kw):
    """One stage-2 step of a small model whose heads are 64 wide (the width
    the attention kernels take), on numpy-seeded inputs. Returns the loss,
    the gradients the step left and the launch counts it added."""
    from dataclasses import replace

    import numpy as np

    from aa_clip_iqm_tpu_torch.configs import TrainConfig, tiny_test_config
    from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone
    from aa_clip_iqm_tpu_torch.models.convert import tree_leaves
    from aa_clip_iqm_tpu_torch.train import optim, steps

    # 266 px: 362 tokens, and 271 after patch dropout at 0.25, enough for
    # the packed attention kernels (the attention dispatch sends fewer than
    # 256 to the plain sdpa).
    img = 266
    patches = (img // 14) ** 2
    cfg = tiny_test_config(img)
    vision = replace(cfg.clip.vision, width=128, head_width=64, layers=3,
                     patch_dropout=patch_dropout)
    cfg = replace(cfg, clip=replace(cfg.clip, vision=vision),
                  adapter=replace(cfg.adapter, levels=(2, 3)), surgery_until_layer=3)
    frozen = random_backbone(cfg, seed=0, device=device, dtype=dtype)
    if quantize:
        frozen = quant.quantize_backbone_auto(frozen, quantize, cfg=cfg)
    trainable = init_trainable(cfg, seed=1, device=device, dtype=torch.float32,
                               requires_grad=True)
    rng = np.random.default_rng(4)
    n = 4

    def on_device(a):
        return torch.from_numpy(a).to(device)

    images = on_device(rng.standard_normal((n, 3, img, img)).astype(np.float32))
    masks = on_device((rng.random((n, 1, img, img)) > 0.8).astype(np.float32))
    labels = on_device(rng.integers(0, 2, n).astype(np.int64))
    anchors = on_device(rng.standard_normal((n, cfg.clip.embed_dim, 2)).astype(np.float32))
    weights = on_device(np.array([1, 1, 1, 0], np.float32))
    keep_idx = None
    if patch_dropout:
        keep = int(patches * (1 - patch_dropout))
        keep_idx = on_device(np.stack([np.sort(rng.permutation(patches)[:keep])
                                       for _ in range(n)]))
    step = steps.make_stage2_step(
        cfg, TrainConfig(img_size=img, **train_kw), compute_dtype=dtype)
    before = (pa.LAUNCHES, pa.BWD_LAUNCHES, fused_mlp.LAUNCHES, fused_mlp.DX_LAUNCHES,
              fused_mlp.INT8_LAUNCHES)
    _, _, loss = step(trainable, optim.stage2_optimizer(trainable, 5e-4, 4), frozen, images,
                      masks, labels, anchors, weights, keep_idx)
    after = (pa.LAUNCHES, pa.BWD_LAUNCHES, fused_mlp.LAUNCHES, fused_mlp.DX_LAUNCHES,
             fused_mlp.INT8_LAUNCHES)
    grads = [None if t.grad is None else t.grad.detach().float().cpu()
             for t in tree_leaves(trainable)]
    return float(loss), grads, tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("options,launches", [
    # (B1, B4, B2, B5, B3) launches: 3 blocks, block 0 out of the graph.
    ({}, (3, 2, 3, 2, 0)),
    ({"grad_accum_steps": 2}, (6, 4, 6, 4, 0)),
    ({"remat": True}, (6, 2, 6, 2, 0)),
    ({"patch_dropout": 0.25}, (3, 2, 3, 2, 0)),
])
def test_stage2_step_on_the_card_matches_the_cpu(dev, options, launches):
    """float32 end to end: the kernels' float32 paths, forward and backward,
    give the CPU step's loss and gradients (the plain versions there)."""
    loss_c, grads_c, got = _stage2_step(dev, torch.float32, **options)
    loss_h, grads_h, none = _stage2_step(torch.device("cpu"), torch.float32, **options)
    assert got == launches and none == (0, 0, 0, 0, 0)
    assert abs(loss_c - loss_h) <= 1e-4 * abs(loss_h), (loss_c, loss_h)
    for gc, gh in zip(grads_c, grads_h):
        assert (gc is None) == (gh is None)
        if gc is not None:
            err = (gc - gh).square().mean().sqrt().item()
            assert err <= 2e-3 * gh.square().mean().sqrt().item() + 1e-9, err


def test_stage2_step_on_the_card_int8_mlp(dev):
    """With an int8 MLP the block takes the fused int8 kernel and its plain
    straight-through backward: the dx kernel does not launch."""
    loss, grads, got = _stage2_step(dev, torch.bfloat16, quantize="int8_mlp")
    assert got == (3, 2, 0, 0, 3)
    assert loss == loss and all(g is None or torch.isfinite(g).all() for g in grads)
    assert any(g is not None and g.abs().max() > 0 for g in grads)
