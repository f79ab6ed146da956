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


def test_bf16_vv_backward_rounds_where_the_kernel_does():
    """The value-value plain backward in bf16 against the Pallas v-v kernel
    (three terms in one fp32 sum, rounded once), at 2% of the largest
    entry."""
    qkv, g = _inputs(13, 300)
    jq, jg = jnp.asarray(qkv, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    ref = np.asarray(jpa._flash_packed_vv_bwd_kernelized(jq, jg, HEADS, SCALE, 290),
                     np.float32)
    out = pa.flash_mha_packed_bwd_reference(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(g).bfloat16(), HEADS, SCALE,
        vv=True, valid_len=290)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=0.02 * np.abs(ref).max())


def _lse(qkv, vv, valid_len):
    """What the forward saves for the backward kernels: each row's
    log-sum-exp (the plain version, as the CPU Function saves it)."""
    t = torch.from_numpy(qkv) if isinstance(qkv, np.ndarray) else qkv
    return pa.packed_lse_reference(t, HEADS, SCALE, vv, valid_len)


@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len,valid_len", [(256, None), (300, 290)])
def test_stages_match_pallas_kernel(vv, seq_len, valid_len):
    """The plain version of the backward kernels' stages (P from the saved
    log-sum-exp, D summed from P dP) against the JAX Pallas backward kernels,
    fp32: the tolerance of two summation orders."""
    qkv, g = _inputs(seq_len + 2 * vv, seq_len)
    kernel = jpa._flash_packed_vv_bwd_kernelized if vv else jpa._flash_packed_bwd_kernelized
    ref = kernel(jnp.asarray(qkv), jnp.asarray(g), HEADS, SCALE, valid_len)
    got = pa.flash_mha_packed_bwd_stages(torch.from_numpy(qkv), torch.from_numpy(g), HEADS,
                                         SCALE, vv, valid_len, _lse(qkv, vv, valid_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len,valid_len", [(256, None), (300, 290), (77, 1)])
def test_stages_match_plain_backward(vv, seq_len, valid_len):
    """The stages against the unchanged TPU-faithful plain backward: fp32 to
    the tolerance of two summation orders; bf16 within the card's gate
    (ops/compare.py: 6 ulps, RMS 1), each of dq, dk, dv on its own scale."""
    from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error

    qkv, g = _inputs(seq_len + 3, seq_len, batch=2)
    w = HEADS * HD
    for dtype in (torch.float32, torch.bfloat16):
        tq, tg = torch.from_numpy(qkv).to(dtype), torch.from_numpy(g).to(dtype)
        got = pa.flash_mha_packed_bwd_stages(tq, tg, HEADS, SCALE, vv, valid_len,
                                             _lse(tq, vv, valid_len))
        ref = pa.flash_mha_packed_bwd_reference(tq, tg, HEADS, SCALE, vv, valid_len)
        assert got.dtype == dtype and got.shape == ref.shape
        if dtype == torch.float32:
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
            continue
        for sec in range(2 if vv else 0, 3):
            max_ulps, rms_ulps = bf16_error(got[..., sec * w:(sec + 1) * w],
                                            ref[..., sec * w:(sec + 1) * w])
            assert max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (sec, max_ulps)
        if vv:
            assert not got[..., :2 * w].any()


@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len,valid_len", [(256, None), (300, 290), (17, 3)])
def test_lse_matches_jax(vv, seq_len, valid_len):
    """The plain log-sum-exp that the forward kernel writes: logsumexp of the
    masked scaled scores per (batch, head, query), against JAX's, fp32, 1e-6
    relative."""
    import jax

    qkv, _ = _inputs(seq_len + 4, seq_len, batch=2)
    b, l, _ = qkv.shape

    def heads(t):
        return t.reshape(b, l, HEADS, HD).transpose(0, 2, 1, 3)

    q, k, v = (heads(jnp.asarray(t)) for t in np.split(qkv, 3, axis=-1))
    if vv:
        q = k = v
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k) * SCALE
    if valid_len is not None:
        s = s + jnp.where(jnp.arange(l) < valid_len, 0.0, -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1))
    got = pa.packed_lse_reference(torch.from_numpy(qkv), HEADS, SCALE, vv, valid_len)
    assert got.shape == (b, HEADS, l) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("vv", [False, True])
def test_function_saves_lse(vv):
    """On the CPU the Function saves qkv and the rows' log-sum-exp, the
    backward kernels' input, and its gradient is the one it gave before (the
    plain backward), bit for bit; no kernel launches."""
    qkv, g = _inputs(21, 130, batch=2)
    t = torch.from_numpy(qkv).requires_grad_(True)
    pa.reset_launches()
    out = pa.flash_mha_packed(t, HEADS, SCALE, vv=vv, valid_len=100)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 2 and torch.equal(saved[0], t.detach())
    assert torch.equal(saved[1], pa.packed_lse_reference(t.detach(), HEADS, SCALE, vv, 100))
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(g))
    want = pa.flash_mha_packed_bwd_reference(t.detach(), torch.from_numpy(g), HEADS, SCALE,
                                             vv, 100)
    assert torch.equal(got, want)
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES, pa.VV_BWD_LAUNCHES) == (0, 0, 0)


def test_surgery_tower_gradient_matches_jax():
    """The gradient of the whole surgery tower (``dual_vision_features``:
    the shared prefix through B4, the value-value blocks through B6, the
    plain branch) with respect to the input image, against ``jax.grad`` of
    the JAX function with its Pallas kernels (interpret mode). A small ViT
    with two 64-wide heads at 224 px (257 tokens), so that both packages take
    the packed kernels; fp32, to 2e-5 of the largest entry."""
    import dataclasses

    import jax

    from aa_clip_iqm_tpu import configs as jconfigs
    from aa_clip_iqm_tpu.models import clip as jclip
    from aa_clip_iqm_tpu_torch import configs as tconfigs
    from aa_clip_iqm_tpu_torch.models import clip as tclip
    from aa_clip_iqm_tpu_torch.models.convert import params_from_jax

    def shrink(configs):
        cfg = configs.tiny_test_config(224)
        vision = dataclasses.replace(cfg.clip.vision, width=128, head_width=64)
        return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vision=vision))

    jcfg, tcfg = shrink(jconfigs), shrink(tconfigs)
    vcfg = jcfg.clip.vision
    vv_from = jclip.surgery_vv_from(vcfg.layers, jcfg.surgery_until_layer)
    levels = jcfg.adapter.levels
    params = jclip.init_clip_params(jax.random.PRNGKey(0), jcfg.clip)
    tparams, _ = params_from_jax(jax.tree.map(np.asarray, params), None, tcfg, device="cpu",
                                 dtype=torch.float32)
    images = np.random.default_rng(5).standard_normal((1, 3, 224, 224)).astype(np.float32)

    def jloss(img):
        pooled, taps = jclip.dual_vision_features(params["visual"], vcfg, img, levels, vv_from,
                                                  use_pallas=True)
        return jnp.sum(pooled ** 2) + sum(jnp.sum(t ** 2) for t in taps)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(images)))
    img = torch.from_numpy(images).requires_grad_(True)
    pa.reset_launches()
    pooled, taps = tclip.dual_vision_features(tparams["visual"], tcfg.clip.vision, img, levels,
                                              vv_from)
    (pooled.square().sum() + sum(t.square().sum() for t in taps)).backward()
    assert (pa.LAUNCHES, pa.BWD_LAUNCHES, pa.VV_BWD_LAUNCHES) == (0, 0, 0)
    np.testing.assert_allclose(img.grad.numpy(), ref, rtol=0, atol=2e-5 * np.abs(ref).max())
