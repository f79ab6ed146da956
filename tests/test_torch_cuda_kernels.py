"""The hand-written CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips (from a fixture) where no CUDA device is
present. On a machine with an H100 and nvcc run

    python -m pytest tests/test_torch_cuda_kernels.py -q -m cuda
"""
import pytest
import torch

from aa_clip_iqm_tpu_torch.ops import _build, attn_block, flash_attention as fa, fused_mlp, gemm
from aa_clip_iqm_tpu_torch.ops import packed_attention as pa
from aa_clip_iqm_tpu_torch.ops import quant
from aa_clip_iqm_tpu_torch.ops.compare import (BF16_MAX_ULPS, BF16_RMS_ULPS, WALK_MAX_ULPS,
                                                bf16_error)
from aa_clip_iqm_tpu_torch.ops.layers import gelu, quick_gelu
from aa_clip_iqm_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# fp32: max abs error <= 1e-4 * max(1, max|twin|). bf16: ops/compare.py.
F32_TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(out, ref, base=None, max_ulps_tol=BF16_MAX_ULPS):
    torch.cuda.synchronize()
    if ref.dtype == torch.bfloat16:
        max_ulps, rms_ulps = bf16_error(out, ref, base)
        assert max_ulps <= max_ulps_tol and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)
    else:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= F32_TOL * max(1.0, ref.float().abs().max().item()), err


def _check_walk(out, stages, base=None):
    """The attention forward against the plain version of its tile walk
    (ops/flash_attention.attention_fwd_stages): in bf16 within 2 ulps, a
    tighter hold than the twin's that a wrong rescale fails."""
    _check(out, stages, base, max_ulps_tol=WALK_MAX_ULPS)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("heads,hd,seq_len,vv,valid_len", [
    (16, 64, 1370, False, None),
    (16, 64, 1370, True, 1360),
    (2, 64, 77, False, 70),
    (4, 64, 17, False, None),
    (2, 64, 200, True, None),
    (4, 64, 65, False, 1),
    # Ragged lengths about the 128-row query and 128-key tiles of the walk.
    (4, 64, 1, False, None),
    (4, 64, 63, True, None),
    (4, 64, 64, False, 1),
    (4, 64, 127, False, None),
    (4, 64, 129, True, 1),
    (16, 64, 1370, False, 1300),
    (2, 64, 8282, False, None),
    (2, 64, 8282, True, 1300),
])
def test_packed_attention_matches_twin(dev, dtype, heads, hd, seq_len, vv, valid_len):
    gen = torch.Generator(device=dev).manual_seed(seq_len + hd)
    qkv = torch.randn((2, seq_len, 3 * heads * hd), generator=gen, device=dev).to(dtype)
    before = profiling.counters()
    out = pa.flash_mha_packed(qkv, heads, hd ** -0.5, vv=vv, valid_len=valid_len)
    assert _build.launches(before) == {"packed_attention": 1}
    _check(out, pa.flash_mha_packed_reference(qkv, heads, hd ** -0.5, vv=vv,
                                              valid_len=valid_len))
    _check_walk(out, pa.flash_mha_packed_stages(qkv, heads, hd ** -0.5, vv, valid_len))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seq_len,vv,valid_len", [
    (1370, False, None),
    (1370, True, 1300),
    (77, False, 70),
    (17, True, None),
    (1, False, None),
    (63, False, 1),
    (64, True, None),
    (127, False, None),
    (129, True, 1),
    (1370, False, 1300),
    (8282, False, None),
])
def test_packed_attention_lse_matches_plain(dev, dtype, seq_len, vv, valid_len):
    """B1's optional log-sum-exp, against the plain logsumexp of the masked
    scaled scores to 1e-5 relative to max(|lse|, 1); the output is the same
    with it on. (With valid_len 1 a row's log-sum-exp is its one scaled
    score, which may lie near 0, and the tensor cores' fp32 sum of its 64
    products is exact only to the products' scale: about 7e-7 here.)"""
    gen = torch.Generator(device=dev).manual_seed(seq_len + 5)
    qkv = torch.randn((2, seq_len, 3 * 4 * 64), generator=gen, device=dev).to(dtype)
    out, lse = pa._forward(qkv, 4, 0.125, vv, valid_len, with_lse=True)
    want = pa.packed_lse_reference(qkv, 4, 0.125, vv, valid_len)
    torch.cuda.synchronize()
    assert lse.shape == (2, 4, seq_len) and lse.dtype == torch.float32
    assert ((lse - want).abs() <= 1e-5 * want.abs().clamp_min(1.0)).all()
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
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual(ln, mlp, x, act)
    assert _build.launches(before) == {"ln_mlp_residual": 1}
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
    before = profiling.counters()
    for act in (None, gelu, quick_gelu):
        _check(gemm.gemm_bias_act(a, w, b, act, tile_n), gemm.gemm_bias_act_reference(a, w, b, act))
    _check(gemm.gemm_bias_residual(a, w, b, res, tile_n),
           gemm.gemm_bias_residual_reference(a, w, b, res), res)
    assert _build.launches(before) == {"ln_mlp_residual_gemm": 4}
    with pytest.raises(ValueError, match="not supported"):
        gemm.gemm_bias_act(a[:, :k - 8].contiguous(), w[:k - 8].contiguous(), b)


@pytest.mark.parametrize("m", [1, 77, 1370, 10960, 43840, 66256])
@pytest.mark.parametrize("n,k", [(4096, 1024), (3072, 768)])
def test_gemm_act_epilogue_tile_widths_match(dev, m, n, k):
    """Epilogue (a) (bias and activation where the accumulator holds them,
    the quads trading rounded bf16 pairs) at B2's GEMM 1 and the text
    tower's widths, from one row to a 1274 px batch: held to the plain
    version in bf16 ulps for GELU, QuickGELU and none, and bit for bit the
    same at both tile widths and at the core's choice."""
    gen = torch.Generator(device=dev).manual_seed(m + n + k)
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    b = torch.randn((n,), generator=gen, device=dev) * 0.1
    before = profiling.counters()
    for act in (None, gelu, quick_gelu):
        out = gemm.gemm_bias_act(a, w, b, act, 128)
        _check(out, gemm.gemm_bias_act_reference(a, w, b, act))
        assert torch.equal(out, gemm.gemm_bias_act(a, w, b, act, 256))
        assert torch.equal(out, gemm.gemm_bias_act(a, w, b, act))
    assert _build.launches(before) == {"ln_mlp_residual_gemm": 9}


@pytest.mark.parametrize("m,grouped", [(1, 0), (130, 0), (21843, 1), (21920, 1)])
def test_grouped_tile_order_is_bit_for_bit_the_n_fastest_one(dev, m, grouped):
    """EVA02-CLIP-E/14+'s W1 (K 1,792, N 15,360, exact GELU) with its tiles
    in bands of 4, 16 and 200 M-tiles and in the rule's bands, through the
    core alone and through the post-norm block's own entry: bit for bit the
    N-fastest order's output. The order moves no product, epilogue or
    rounding, only which SM takes a tile when. The rule bands W1 where its
    tiles take more than one wave (``grouped``)."""
    from aa_clip_iqm_tpu_torch.ops import postnorm

    gen = torch.Generator(device=dev).manual_seed(m)
    a = torch.randn((m, 1792), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((1792, 15360), generator=gen, device=dev) * 1792 ** -0.5).to(torch.bfloat16)
    b = torch.randn((15360,), generator=gen, device=dev) * 0.1
    want = gemm.gemm_bias_act(a, w, b, gelu, group=1)
    for group in (4, 16, 200, None):
        assert torch.equal(gemm.gemm_bias_act(a, w, b, gelu, group=group), want), group
    before = profiling.counters()
    assert torch.equal(postnorm.gemm_act(a, w, b, gelu), want)
    assert profiling.counters().get(gemm.GROUPED, 0) - before.get(gemm.GROUPED, 0) == grouped


@pytest.mark.parametrize("m,n,k", [(130, 1792, 1792), (21920, 1792, 1536)])
def test_grouped_tile_order_leaves_every_epilogue_bit_for_bit(dev, m, n, k):
    """Epilogues (b), (c) and (d) in bands of 3 and 16 M-tiles against the
    N-fastest order, bit for bit, with the rule's choice counted as it is
    taken."""
    gen = torch.Generator(device=dev).manual_seed(n + k)

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    a, a2 = rnd(m, k).to(torch.bfloat16), rnd(m, k).to(torch.bfloat16)
    w = rnd(k, n, std=k ** -0.5).to(torch.bfloat16)
    w2t = rnd(n, k, std=k ** -0.5).to(torch.bfloat16)
    b, res = rnd(n, std=0.1), rnd(m, n).to(torch.bfloat16)
    runs = [lambda g: gemm.gemm_bias_residual(a, w, b, res, group=g),
            lambda g: gemm.gemm_dual_dact(a, w, b, a2, w2t, gelu, group=g),
            lambda g: gemm.gemm_f32(a, w, b, group=g),
            lambda g: gemm.gemm_f32(a, w2t, None, w_kmajor=True, group=g)]
    for run in runs:
        want = run(1)
        for group in (3, 16):
            assert torch.equal(run(group), want), group
    before = profiling.counters()
    for run in runs:
        run(None)
    assert profiling.counters().get(gemm.GROUPED, 0) == before.get(gemm.GROUPED, 0)


def _tower_forward(name, batch, dev):
    """One bf16 forward of ``name``'s vision tower at 518 px on the kernels,
    from seeded weights; returns the ``gemm.grouped`` launches it took."""
    from aa_clip_iqm_tpu_torch.loader import build_model_config, random_backbone
    from aa_clip_iqm_tpu_torch.models import clip as tclip
    from benchmark import inputs

    cfg = build_model_config(name, img_size=518)
    visual = inputs.fill(random_backbone(cfg, device="meta", dtype=torch.bfloat16)["visual"],
                         5, dev)
    images = torch.randn((batch, 3, 518, 518), generator=torch.Generator(device=dev).manual_seed(6),
                         device=dev)
    before = profiling.counters().get(gemm.GROUPED, 0)
    with torch.no_grad():
        tclip.vision_forward(visual, cfg.clip.vision, images, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return profiling.counters().get(gemm.GROUPED, 0) - before


def test_gemm_grouped_counts_the_w1_launches_of_a_forward(dev):
    """``gemm.grouped``: one a W1 launch, 64 in a forward of the whole
    EVA02-CLIP-E/14+ tower, none in a ViT-L/518 forward, whose products all
    keep the N-fastest order."""
    assert _tower_forward("EVA02-CLIP-bigE-14-plus", 1, dev) == 64
    torch.cuda.empty_cache()
    assert _tower_forward("ViT-L-14-336", 2, dev) == 0


def test_gelu_matches_erff_on_every_float(dev):
    """The core's exact GELU and its erf (two polynomial chains and one
    select) against the same through CUDA's erff, over all 2^32 floats:
    bit for bit, NaN for NaN."""
    assert gemm.gelu_mismatches(dev) == 0


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
    (10960, 1024, 4096, quick_gelu),
    (1370, 1024, 4096, quick_gelu),   # batch 1: 10 x 128 + 90 rows
    (130, 1024, 4096, gelu),          # one full tile and two rows
    (1, 1024, 4096, gelu),            # one row of a 128-row tile
    (1000, 768, 3072, gelu),          # the text tower's widths
    (77, 128, 384, quick_gelu),       # an odd row count, 128-wide chunks
    (64, 128, 768, quick_gelu),       # 256-wide chunks
    (333, 256, 1024, gelu),
    (130, 256, 512, quick_gelu),      # 512-wide chunks
    (5, 128, 512, gelu),              # fewer rows than a tile
    (130, 1280, 5120, gelu),          # wider than ViT-L: no cap on d
])
def test_ln_mlp_residual_int8_matches_twin(dev, m, d, h, act):
    """Integer products are exact, so kernel and twin differ only where a
    float32 sum of the LayerNorm, taken in another order, flips a rounding:
    held on y - x in bf16 ulps like the float kernel, to the twin and to the
    plain version of the kernel's stages, whose x_q and h_q the kernel's
    own may differ from by one step at most."""
    ln, qmlp, x = _int8_case(dev, m, d, h, m + h)
    assert fused_mlp.ln_mlp_residual_int8_ok(x, qmlp, act)
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual_int8(ln, qmlp, x, act)
    assert _build.launches(before) == {"ln_mlp_residual_int8": 1}
    _check(out, fused_mlp.ln_mlp_residual_int8_reference(ln, qmlp, x, act), x)
    batched = fused_mlp.ln_mlp_residual_int8(ln, qmlp, x.reshape(1, m, d), act)
    assert torch.equal(batched.reshape(m, d), out)
    got = fused_mlp.ln_mlp_residual_int8_with_stages(ln, qmlp, x, act)
    st = fused_mlp.ln_mlp_residual_int8_stages(ln, qmlp, x, act)
    assert torch.equal(got["y"], out)
    _check(out, st["y"], x)
    for name in ("x_q", "h_q"):
        assert (got[name].int() - st[name].int()).abs().max().item() <= 1, name


@pytest.mark.parametrize("m,d,h,ep_bf16,ch", [
    (10960, 1024, 4096, False, 1024),  # ViT-L/518, batch 8: the sweep's variants
    (10960, 1024, 4096, True, 1024),
    (10960, 1024, 4096, False, 2048),
    (22528, 1024, 4096, True, 2048),   # the probe's own M
    (1370, 1024, 4096, False, 2048),   # ragged rows
    (1, 1024, 4096, True, 1024),
    (77, 256, 2048, False, 2048),      # one chunk of 16 tiles
])
def test_ln_mlp_residual_int8_probe_matches_plain(dev, m, d, h, ep_bf16, ch):
    """B9 against its plain version and its stages: the products are exact
    and the GELU's operations round where the plain version's do, so they
    differ only where the LayerNorm's fp32 sums flip a rounding. GEMM 1 and
    GEMM 2 are held to their plain version on the kernel's own row pass;
    the whole and h_q to the plain version; with the bf16 epilogue the rows
    whose x_q flipped are held on the kernel's own row pass only, since a
    flipped x_q can move a chunk's bf16 maximum and so requantize the whole
    (row, chunk), and the RMS over all rows (chip_smoke.py's B9 hold)."""
    ln, qmlp, x = _int8_case(dev, m, d, h, m + h + ch)
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual_int8_probe(ln, qmlp, x, ep_bf16, ch)
    assert _build.launches(before) == {"ln_mlp_residual_int8_probe": 1}
    ref = fused_mlp.ln_mlp_residual_int8_probe_reference(ln, qmlp, x, ep_bf16, ch)
    got = fused_mlp.ln_mlp_residual_int8_probe(ln, qmlp, x, ep_bf16, ch, stages=True)
    st = fused_mlp.ln_mlp_residual_int8_probe_stages(ln, qmlp, x, ep_bf16, ch)
    # With the bf16 epilogue the plain holds take y on the rows whose x_q
    # agrees and h_q on those whose sx agrees too; the others are held on
    # the kernel's own row pass (below).
    same = same_sx = torch.ones(m, dtype=torch.bool, device=dev)
    if ep_bf16:
        same = (got["x_q"] == st["x_q"]).all(dim=-1)
        same_sx = same & (got["sx"].reshape(m, -1) == st["sx"].reshape(m, -1)).all(dim=-1)
    if same.any():
        _check(out[same], ref[same], x[same])
    if same_sx.any():
        assert (got["h_q"][same_sx].int() - st["h_q"][same_sx].int()).abs().max().item() <= 1
    torch.cuda.synchronize()
    assert bf16_error(out, ref, x)[1] <= BF16_RMS_ULPS
    assert torch.equal(got["y"], out)
    assert got["sh"].shape == (m, h // ch)
    assert (got["x_q"].int() - st["x_q"].int()).abs().max().item() <= 1
    own = fused_mlp.ln_mlp_residual_int8_probe_stages(ln, qmlp, x, ep_bf16, ch,
                                                      rows=(got["x_q"], got["sx"]))
    _check(out, own["y"], x)
    assert (got["h_q"].int() - own["h_q"].int()).abs().max().item() <= 1


def test_int8_probe_refuses_bad_inputs(dev):
    ln, qmlp, x = _int8_case(dev, 64, 256, 2048, 3)
    with pytest.raises(ValueError, match="ch=512"):
        fused_mlp.ln_mlp_residual_int8_probe(ln, qmlp, x, False, 512)
    with pytest.raises(TypeError, match="dtype"):
        fused_mlp.ln_mlp_residual_int8_probe(ln, qmlp, x.float(), False, 1024)
    ln3, q3, x3 = _int8_case(dev, 64, 256, 3072, 4)     # 2048 does not divide h
    with pytest.raises(ValueError, match="not supported"):
        fused_mlp.ln_mlp_residual_int8_probe(ln3, q3, x3, False, 2048)


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
    odd_ln, odd, odd_x = _int8_case(dev, 8, 192, 512, 2)   # d not a multiple of 128
    with pytest.raises(ValueError, match="not supported"):
        fused_mlp.ln_mlp_residual_int8(odd_ln, odd, odd_x, gelu)


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
    before = profiling.counters()
    out = pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5, valid_len=valid_len, lse=lse)
    assert _build.launches(before) == {"packed_attention_bwd": 1}
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


def test_ln_mlp_residual_int8_as_a_thread_s_first_call(dev):
    """B3, whose stages encode TMA tensor maps, as the first CUDA call of a
    new thread: under remat the int8 forward can run on autograd's worker
    thread, where no context need be current yet."""
    import threading

    ln, qmlp, x = _int8_case(dev, 300, 256, 1024, 8)
    got = {}

    def run():
        try:
            got["out"] = fused_mlp.ln_mlp_residual_int8(ln, qmlp, x, gelu)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            got["out"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not isinstance(got["out"], Exception), got["out"]
    assert torch.equal(got["out"], fused_mlp.ln_mlp_residual_int8(ln, qmlp, x, gelu))
    _check(got["out"], fused_mlp.ln_mlp_residual_int8_reference(ln, qmlp, x, gelu), x)


def test_packed_attention_as_a_thread_s_first_call(dev):
    """B1, whose bf16 walk encodes TMA tensor maps, as the first CUDA call of
    a new thread: stage 2 recomputes it under remat on autograd's worker
    thread, where no context need be current yet."""
    import threading

    gen = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn((2, 300, 3 * 128), generator=gen, device=dev).to(torch.bfloat16)
    got = {}

    def run():
        try:
            got["out"] = pa._forward(qkv, 2, 0.125, False, None, with_lse=True)
            torch.cuda.synchronize()
        except RuntimeError as exc:
            got["out"] = exc

    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert not isinstance(got["out"], Exception), got["out"]
    out, lse = got["out"]
    _check(out, pa.flash_mha_packed_reference(qkv, 2, 0.125))
    want = pa.packed_lse_reference(qkv, 2, 0.125)
    assert ((lse - want).abs() <= 1e-5 * want.abs()).all()


def test_packed_attention_autograd_on_the_card(dev):
    """The Function's backward launches the B4 kernel, and for the
    value-value variant the B6 kernel."""
    gen = torch.Generator(device=dev).manual_seed(3)
    qkv = torch.randn((1, 130, 3 * 128), generator=gen, device=dev).to(torch.bfloat16)
    qkv.requires_grad_(True)
    g = torch.randn((1, 130, 128), generator=gen, device=dev).to(torch.bfloat16)
    before = profiling.counters()
    out = pa.flash_mha_packed(qkv, 2, 0.125)
    assert out.grad_fn is not None
    (grad,) = torch.autograd.grad(out, qkv, g)
    assert _build.launches(before) == {"packed_attention": 1, "packed_attention_bwd": 1}
    _check(grad, pa.flash_mha_packed_bwd_reference(qkv.detach(), g, 2, 0.125))
    out = pa.flash_mha_packed(qkv, 2, 0.125, vv=True)
    (grad,) = torch.autograd.grad(out, qkv, g)
    assert _build.launches(before) == {"packed_attention": 2, "packed_attention_bwd": 1,
                                       "packed_attention_vv_bwd": 1}
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
    before = profiling.counters()
    out = pa.flash_mha_packed_bwd(qkv, d_out, heads, hd ** -0.5, vv=True, valid_len=valid_len,
                                  lse=lse)
    assert _build.launches(before) == {"packed_attention_vv_bwd": 1}
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
    (4, 1),                           # ragged about the 128-row and 128-key tiles
    (4, 63),
    (4, 64),
    (4, 127),
    (4, 129),
    (128, 1370),                      # ViT-L/518 heads at batch 8
])
def test_flash_attention_matches_twin(dev, dtype, bh, seq_len):
    """B7 on (BH, L, 64), the kernel entry itself (flash_mha sends fewer than
    256 tokens to the plain sdpa), against the twin and the plain version of
    the tile walk."""
    gen = torch.Generator(device=dev).manual_seed(bh + seq_len)
    q, k, v = (torch.randn((bh, seq_len, 64), generator=gen, device=dev).to(dtype)
               for _ in range(3))
    before = profiling.counters()
    out = fa._forward(q, k, v, 0.125)
    assert _build.launches(before) == {"flash_attention": 1}
    _check(out, fa.flash_mha_reference(q, k, v, 0.125))
    _check_walk(out, fa.attention_fwd_stages(q, k, v, 0.125))


def test_flash_attention_autograd_on_the_card(dev):
    """flash_mha on (B, H, L, hd): the forward kernel, the plain recompute's
    gradient, and value-value (one tensor three times)."""
    gen = torch.Generator(device=dev).manual_seed(8)
    q, k, v = (torch.randn((2, 4, 300, 64), generator=gen, device=dev).requires_grad_(True)
               for _ in range(3))
    g = torch.randn((2, 4, 300, 64), generator=gen, device=dev)
    before = profiling.counters()
    out = fa.flash_mha(q, k, v, 0.125)
    got = torch.autograd.grad(out, (q, k, v), g)
    assert _build.launches(before) == {"flash_attention": 1}
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
    (2, 1, 1024, False, None),        # ragged about the walk's 128-row and 128-key tiles
    (2, 63, 1024, True, None),
    (2, 64, 1024, False, 1),
    (2, 127, 1024, True, 1),
    (2, 129, 1024, False, None),
    (2, 1370, 1024, False, 1300),
])
def test_ln_attn_residual_matches_twin(dev, batch, seq_len, d, vv, valid_len):
    """B8, held on y - x like the MLP kernels, against the twin, the plain
    version of its stages and the same with the attention stage's tile walk
    (within 2 ulps)."""
    ln, attn, gen = _block_case(dev, d, seq_len + d)
    x = torch.randn((batch, seq_len, d), generator=gen, device=dev).to(torch.bfloat16)
    heads = d // 64
    assert attn_block.ln_attn_residual_ok(x, attn, heads)
    before = profiling.counters()
    out = attn_block.ln_attn_residual(ln, attn, x, heads, vv, valid_len)
    assert _build.launches(before) == {"ln_attn_residual": 1}
    _check(out, attn_block.ln_attn_residual_reference(ln, attn, x, heads, vv, valid_len), x)
    _check(out, attn_block.ln_attn_residual_stages(ln, attn, x, heads, vv, valid_len), x)
    _check_walk(out, attn_block.ln_attn_residual_stages(ln, attn, x, heads, vv, valid_len,
                                                        walk=True), x)


def test_ln_attn_residual_autograd_on_the_card(dev):
    """The Function's forward is the kernel; its backward differentiates the
    plain chain, for x and the parameters."""
    ln, attn, gen = _block_case(dev, 256, 5)
    attn["out"]["b"].requires_grad_(True)
    x = torch.randn((2, 300, 256), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
    g = torch.randn((2, 300, 256), generator=gen, device=dev).to(torch.bfloat16)
    before = profiling.counters()
    y = attn_block.ln_attn_residual(ln, attn, x, 4, True)
    dx, db = torch.autograd.grad(y, (x, attn["out"]["b"]), g)
    assert _build.launches(before) == {"ln_attn_residual": 1}
    ref = attn_block.ln_attn_residual_reference(ln, attn, x, 4, True)
    rdx, rdb = torch.autograd.grad(ref, (x, attn["out"]["b"]), g)
    _check(dx, rdx, g)
    _check(db, rdb)
    with pytest.raises(ValueError, match="heads of 64"):
        attn_block.ln_attn_residual(*_block_case(dev, 256, 6)[:2],
                                    torch.zeros((1, 8, 256), device=dev, dtype=torch.bfloat16), 2)


def _fails(out, ref, base=None):
    """Whether ``out`` falls outside :func:`_check`'s hold of ``ref``."""
    torch.cuda.synchronize()
    max_ulps, rms_ulps = bf16_error(out, ref, base)
    return max_ulps > BF16_MAX_ULPS or rms_ulps > BF16_RMS_ULPS


@pytest.mark.parametrize("batch,seq_len", [(8, 1370), (32, 1370), (8, 8282)])
def test_ln_attn_halves_match_plain(dev, batch, seq_len):
    """B8's front (LayerNorm pass and qkv product) and back (out-projection
    with the residual) alone, at the offline cells' shapes, against their
    plain versions; each plain version with a planted fault (the front's
    bias dropped, the back's residual dropped) fails the same hold."""
    d = 1024
    ln, attn, gen = _block_case(dev, d, seq_len + batch)
    x = torch.randn((batch, seq_len, d), generator=gen, device=dev).to(torch.bfloat16)
    o = torch.randn((batch, seq_len, d), generator=gen, device=dev).to(torch.bfloat16)
    before = profiling.counters()
    qkv = attn_block.ln_attn_front(ln, attn["qkv"], x)
    y = attn_block.ln_attn_back(attn["out"], o, x)
    assert _build.launches(before) == {"ln_attn_residual_front": 1, "ln_attn_residual_back": 1}
    assert qkv.shape == (batch, seq_len, 3 * d) and y.shape == x.shape
    _check(qkv, attn_block.ln_attn_front_reference(ln, attn["qkv"], x))
    no_bias = {"w": attn["qkv"]["w"], "b": torch.zeros_like(attn["qkv"]["b"])}
    assert _fails(qkv, attn_block.ln_attn_front_reference(ln, no_bias, x))
    _check(y, attn_block.ln_attn_back_reference(attn["out"], o, x), x)
    assert _fails(y, attn_block.ln_attn_back_reference(attn["out"], o, torch.zeros_like(x)), x)


def test_ln_attn_halves_refuse_what_they_cannot_take(dev):
    ln, attn, _ = _block_case(dev, 192, 1)
    with pytest.raises(ValueError, match="multiple of 128"):
        attn_block.ln_attn_front(ln, attn["qkv"],
                                 torch.zeros((2, 8, 192), device=dev, dtype=torch.bfloat16))
    ln, attn, _ = _block_case(dev, 256, 2)
    x = torch.zeros((2, 8, 256), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 128"):
        attn_block.ln_attn_front(ln, attn["qkv"], x.float())
    with pytest.raises(ValueError, match=r"o \(2, 4, 256\)"):
        attn_block.ln_attn_back(attn["out"], x[:, :4].contiguous(), x)


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
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual_dx(ln, mlp, x, g, act)
    assert _build.launches(before) == {"ln_mlp_residual_dx": 1}
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
    before = profiling.counters()
    for tile_n in (0, 128):
        _check(gemm.gemm_f32(a, w, scale, tile_n=tile_n), gemm.gemm_f32_reference(a, w, scale))
        _check(gemm.gemm_f32(a, w2t, None, w_kmajor=True, tile_n=tile_n),
               gemm.gemm_f32_reference(a, w2t, None, w_kmajor=True))
    for act in (gelu, quick_gelu):
        _check(gemm.gemm_dual_dact(a, w, b, a2, w2t, act),
               gemm.gemm_dual_dact_reference(a, w, b, a2, w2t, act))
    assert _build.launches(before) == {"ln_mlp_residual_dx_gemm_f32": 4,
                                       "ln_mlp_residual_dx_gemm_dual": 2}
    with pytest.raises(ValueError, match="not supported"):
        gemm.gemm_f32(a[:, :k - 8].contiguous(), w[:k - 8].contiguous())


def test_fused_mlp_autograd_on_the_card(dev):
    """The frozen Function goes forward through the fused kernel and backward
    through the dx kernel; the general one recomputes the plain chain."""
    ln, mlp, x, g = _float_case(dev, torch.bfloat16, 200, 256, 512, 9)
    x.requires_grad_(True)
    before = profiling.counters()
    y = fused_mlp.ln_mlp_residual_frozen(ln, mlp, x, gelu)
    (dx,) = torch.autograd.grad(y, x, g)
    assert _build.launches(before) == {"ln_mlp_residual": 1, "ln_mlp_residual_dx": 1}
    ref = fused_mlp.ln_mlp_residual_dx_reference(ln, mlp, x.detach(), g, gelu)
    _check(dx, ref, g)
    mlp["c_fc"]["b"].requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        fused_mlp.ln_mlp_residual_frozen(ln, mlp, x, gelu)
    y = fused_mlp.ln_mlp_residual(ln, mlp, x, gelu)
    dx2, db = torch.autograd.grad(y, [x, mlp["c_fc"]["b"]], g)
    assert _build.launches(before) == {"ln_mlp_residual": 2, "ln_mlp_residual_dx": 1}
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
    before = profiling.counters()
    _, _, loss = step(trainable, optim.stage2_optimizer(trainable, 5e-4, 4), frozen, images,
                      masks, labels, anchors, weights, keep_idx)
    launched = _build.launches(before)
    grads = [None if t.grad is None else t.grad.detach().float().cpu()
             for t in tree_leaves(trainable)]
    return float(loss), grads, tuple(launched.get(n, 0) for n in (
        "packed_attention", "packed_attention_bwd", "ln_mlp_residual", "ln_mlp_residual_dx",
        "ln_mlp_residual_int8"))


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


# --------------------------------------------------------------------------
# SigLIP So400m's widths: B1 at heads of 72, the core's tanh GELU, B2 at
# width 1152 with the hidden width padded from 4304
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,heads,seq_len,vv,valid_len", [
    (32, 16, 1369, False, None),
    (2, 16, 1369, True, 1300),
    (2, 16, 1369, False, 1000),
    (2, 4, 1, False, None),
    (2, 4, 127, False, None),
    (2, 4, 129, False, 1),
    (2, 4, 201, True, None),
    (2, 4, 333, False, 257),
    (1, 16, 8192, False, None),
])
def test_the_hd72_instance_matches_its_plain_versions(dev, dtype, b, heads, seq_len, vv,
                                                      valid_len):
    """B1 at heads of 72 against the twin (bf16 ulps) and the plain version
    of its walk (2 ulps). A head is a 64-column box and an 8-column box, and
    the fifth k-step's columns 72-79 are zeros, not the next head's: a
    planted scale of 64^-0.5 fails, and so would a product that took the
    next head's columns."""
    gen = torch.Generator(device=dev).manual_seed(seq_len + 72)
    qkv = torch.randn((b, seq_len, 3 * heads * 72), generator=gen, device=dev).to(dtype)
    scale = 72 ** -0.5
    before = profiling.counters()
    out = pa.flash_mha_packed(qkv, heads, scale, vv=vv, valid_len=valid_len)
    assert _build.launches(before) == {"packed_attention_hd72": 1}
    twin = pa.flash_mha_packed_reference(qkv, heads, scale, vv=vv, valid_len=valid_len)
    if dtype == torch.float32:
        _check(out, twin)
        return
    _check(out, twin)
    _check_walk(out, pa.flash_mha_packed_stages(qkv, heads, scale, vv, valid_len))
    if min(seq_len, valid_len or seq_len) > 1:         # one key: softmax is 1 at any scale
        wrong = pa.flash_mha_packed_reference(qkv, heads, 64 ** -0.5, vv=vv,
                                              valid_len=valid_len)
        assert bf16_error(out, wrong)[0] > BF16_MAX_ULPS


def test_the_hd72_instance_writes_the_log_sum_exp(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    qkv = torch.randn((2, 1369, 3 * 16 * 72), generator=gen, device=dev).to(torch.bfloat16)
    out, lse = pa._forward(qkv, 16, 72 ** -0.5, False, None, with_lse=True)
    want = pa.packed_lse_reference(qkv, 16, 72 ** -0.5)
    torch.cuda.synchronize()
    assert ((lse - want).abs() / want.abs().clamp_min(1.0)).max().item() <= 1e-5
    assert torch.equal(out, pa._forward(qkv, 16, 72 ** -0.5, False, None))


def test_heads_of_72_above_b1_s_rows_raise_on_b7(dev):
    """B7 (above 8,192 rows) stays 64-wide: a 72-wide call raises."""
    q = torch.zeros((1, 16, 8282, 72), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head width 72"):
        fa.flash_mha(q, q, q, 72 ** -0.5)


@pytest.mark.parametrize("m,n,k", [(1, 4352, 1152), (2738, 4352, 1152), (43808, 4352, 1152),
                                   (77, 256, 128), (130, 384, 64)])
def test_gemm_tanh_epilogue_matches_torch(dev, m, n, k):
    """Epilogue (a) with the tanh GELU against ``torch.nn.functional.gelu(
    approximate="tanh")`` of the fp32 product, rounded once (bf16 ulps), at
    both tile widths alike. The two GELUs differ by less than a bf16 ulp
    near 1, so the fault check shifts the products to about -3, where the
    outputs are small and the exact GELU in the tanh GELU's place fails."""
    from aa_clip_iqm_tpu_torch.ops.layers import gelu_tanh

    gen = torch.Generator(device=dev).manual_seed(m + n)
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    for shift, std in ((0.0, 1.0), (-3.0, 0.25)):
        ws = (w.float() * std).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device=dev) * 0.5 * std + shift
        acc = torch.addmm(b, a.float(), ws.float())
        want = torch.nn.functional.gelu(acc, approximate="tanh").to(torch.bfloat16)
        for tile_n in (0, 128):
            out = gemm.gemm_bias_act(a, ws, b, gelu_tanh, tile_n=tile_n)
            _check(out, want)
    assert bf16_error(out, gelu(acc).to(torch.bfloat16))[0] > BF16_MAX_ULPS


@pytest.mark.parametrize("m", [1, 1369, 43808])
def test_ln_mlp_residual_at_siglip_s_widths(dev, m):
    """B2 at d 1152 with the tanh GELU and the hidden width 4304 padded to
    4352 (``fused_mlp.padded_hidden``): against the unpadded chain's twin
    and stages in bf16 ulps; the padding is zero weights."""
    from aa_clip_iqm_tpu_torch.ops.layers import gelu_tanh

    ln, mlp, x, _ = _float_case(dev, torch.bfloat16, m, 1152, 4304, 11)
    padded = fused_mlp.padded_hidden(mlp)
    assert padded["c_fc"]["w"].shape == (1152, 4352) and padded["c_proj"]["w"].shape == (4352,
                                                                                          1152)
    assert not padded["c_fc"]["w"][:, 4304:].any() and not padded["c_proj"]["w"][4304:].any()
    assert fused_mlp.padded_hidden(mlp) is padded                  # made once per weight
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual(ln, padded, x, gelu_tanh, 1e-6)
    assert _build.launches(before) == {"ln_mlp_residual": 1}
    _check(out, fused_mlp.ln_mlp_residual_reference(ln, mlp, x, gelu_tanh, 1e-6), x)
    _check(out, fused_mlp.ln_mlp_residual_stages(ln, mlp, x, gelu_tanh, 1e-6), x)
    with pytest.raises(RuntimeError):
        fused_mlp.ln_mlp_residual(ln, mlp, x, gelu_tanh, 1e-6)      # 4304 unpadded: refused


def test_the_kernels_keep_their_names(dev):
    """The profiler's names of B1's 64- and 112-wide instances and of
    epilogue (a)'s GELU instance are what the accepted rooflines match; the
    72-wide instance and the tanh-GELU epilogue have names of their own."""
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch.ops.layers import gelu_tanh

    gen = torch.Generator(device=dev).manual_seed(1)
    ln, mlp, x, _ = _float_case(dev, torch.bfloat16, 300, 1024, 4096, 2)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for hd in (64, 112, 72):
            qkv = torch.randn((1, 300, 3 * 4 * hd), generator=gen, device=dev)
            pa.flash_mha_packed(qkv.to(torch.bfloat16), 4, hd ** -0.5)
        fused_mlp.ln_mlp_residual(ln, mlp, x, gelu)
        gemm.gemm_bias_act(x, mlp["c_fc"]["w"], mlp["c_fc"]["b"], gelu_tanh)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for tag in ("packed_attention", "packed_attention_hd112", "packed_attention_hd72"):
        assert any(f"attention_wgmma_kernel<{tag}>" in n for n in names), (tag, names)
    assert any("gemm_bias_act_kernel<(anonymous namespace)::ln_mlp_residual_stage, 256, 0>"
               in n for n in names), names
    assert any("gemm_bias_act_kernel<(anonymous namespace)::ln_mlp_residual_stage, 256, 3>"
               in n for n in names), names
