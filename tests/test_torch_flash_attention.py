"""Port's unpacked flash attention and the attention dispatch vs the JAX
package (Pallas kernels in interpret mode).

The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against its plain twin there); on a
CPU tensor ``flash_mha`` runs the twin and launches nothing. fp32 is held to
the JAX tests' rtol 2e-4 / atol 2e-5, bf16 to their 2e-2, gradients to 2e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import attention as jattn
from aa_clip_iqm_tpu.ops import pallas_attention as jpa
from aa_clip_iqm_tpu_torch.cli import attn_variants
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import attention as tattn
from aa_clip_iqm_tpu_torch.ops import flash_attention as tfa
from aa_clip_iqm_tpu_torch.ops.compare import bf16_close, bf16_error
from aa_clip_iqm_tpu_torch.utils import profiling

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    jpa.INTERPRET = True
    yield
    jpa.INTERPRET = False


def _heads(seed, b, h, l, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, l, hd)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("blockwise", [False, True])
@pytest.mark.parametrize("seq_len", [256, 300])
def test_flash_mha_matches_jax_kernel_fp32(seq_len, blockwise, monkeypatch):
    if blockwise:
        monkeypatch.setattr(jpa, "ROW_KERNEL_MAX_TOKENS", 0)
    q, k, v = _heads(seq_len, 1, 2, seq_len, 64)
    scale = 64 ** -0.5
    ref = np.asarray(jpa.flash_mha(*(jnp.asarray(t) for t in (q, k, v)), scale))
    before = profiling.counters()
    out = tfa.flash_mha(*(torch.from_numpy(t) for t in (q, k, v)), scale)
    assert _build.launches(before) == {} and out.shape == q.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("blockwise", [False, True])
def test_flash_mha_matches_jax_kernel_bf16(blockwise, monkeypatch):
    if blockwise:
        monkeypatch.setattr(jpa, "ROW_KERNEL_MAX_TOKENS", 0)
    q, k, v = _heads(3, 1, 2, 256, 64)
    scale = 64 ** -0.5
    ref = jpa.flash_mha(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), scale)
    out = tfa.flash_mha(*(torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)),
                        scale)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_short_and_masked_fall_back_to_sdpa(masked):
    """Fewer than 2 * BLK_Q tokens, or an additive mask at any length, take
    the plain sdpa on both sides."""
    l = 300 if masked else 77
    q, k, v = _heads(l, 2, 2, l, 32)
    mask = np.triu(np.full((l, l), -np.inf, np.float32), 1) if masked else None
    scale = 32 ** -0.5
    ref = jpa.flash_mha(*(jnp.asarray(t) for t in (q, k, v)), scale,
                        attn_mask=None if mask is None else jnp.asarray(mask))
    out = tfa.flash_mha(*(torch.from_numpy(t) for t in (q, k, v)), scale,
                        attn_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_function_gradient_matches_jax_vjp():
    """The Function's backward (autograd through the plain recompute) against
    the VJP of JAX's ``_flash_attention_bh`` (an XLA recompute)."""
    b, h, l, hd = 1, 2, 256, 64
    q, k, v = _heads(11, b, h, l, hd)
    g = np.random.default_rng(12).standard_normal((b, h, l, hd)).astype(np.float32)
    scale = hd ** -0.5
    _, vjp = jax.vjp(lambda *t: jpa._flash_attention_bh(*t, scale),
                     *(jnp.asarray(t.reshape(b * h, l, hd)) for t in (q, k, v)))
    ref = vjp(jnp.asarray(g.reshape(b * h, l, hd)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
    out = tfa.flash_mha(*ts, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r).reshape(b, h, l, hd),
                                   rtol=RTOL, atol=ATOL)


def _attn_params(seed, d):
    rng = np.random.default_rng(seed)
    p = {"qkv": {"w": rng.standard_normal((d, 3 * d)) * d ** -0.5,
                 "b": rng.standard_normal(3 * d) * 0.1},
         "out": {"w": rng.standard_normal((d, d)) * d ** -0.5,
                 "b": rng.standard_normal(d) * 0.1}}
    return jax.tree.map(lambda a: a.astype(np.float32), p)


def _to(tree, fn):
    return {k: _to(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _spy(monkeypatch):
    calls = []
    for name in ("flash_mha", "flash_mha_packed"):
        real = getattr(tattn, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)

        monkeypatch.setattr(tattn, name, spy)
    return calls


@pytest.mark.parametrize("vv", [False, True])
@pytest.mark.parametrize("seq_len,d,heads,lower,route", [
    (256, 128, 2, False, "flash_mha_packed"),   # the packed gate holds (the 518 px path)
    (256, 128, 2, True, "flash_mha"),           # above the lowered threshold: B7
    (300, 192, 3, False, "flash_mha"),          # 3 heads of 64 do not tile 128 lanes
    (77, 128, 2, False, "flash_mha"),           # short: flash_mha takes the plain sdpa
])
def test_dispatch_matches_jax(seq_len, d, heads, lower, route, vv, monkeypatch):
    if lower:
        monkeypatch.setattr(jpa, "ROW_KERNEL_MAX_TOKENS", 0)
        monkeypatch.setattr(tfa, "ROW_KERNEL_MAX_TOKENS", 0)
    params = _attn_params(seq_len + heads, d)
    x = np.random.default_rng(seq_len).standard_normal((2, seq_len, d)).astype(np.float32)
    jp = _to(params, jnp.asarray)
    tp = _to(params, torch.from_numpy)
    if vv:
        ref = jattn.vv_attention(jp, jnp.asarray(x), heads, use_pallas=True)
    else:
        ref = jattn.mha(jp, jnp.asarray(x), heads, use_pallas=True)
    assert tattn.packed_ok(torch.from_numpy(x), heads, None) == (route == "flash_mha_packed")
    calls = _spy(monkeypatch)
    fn = tattn.vv_attention if vv else tattn.mha
    out = fn(tp, torch.from_numpy(x), heads)
    assert calls == [route]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_packed_gate_mirrors_jax():
    """packed_ok is _packed_pallas_ok without its backend test."""
    for l, d, heads, mask in [(256, 128, 2, None), (8192, 128, 2, None), (8193, 128, 2, None),
                              (255, 128, 2, None), (300, 128, 4, None), (300, 256, 2, None),
                              (300, 192, 3, None), (300, 128, 2, np.zeros((300, 300)))]:
        xj = jnp.zeros((1, l, d), jnp.float32)
        xt = torch.zeros((1, l, d))
        assert tattn.packed_ok(xt, heads, mask) == jattn._packed_pallas_ok(xj, heads, mask)


# The plain version of the kernel's tile walk (csrc/attention_fwd.cuh, 128-key
# tiles), at lengths that leave a ragged last tile of 1, 72, 44 and 90 keys.
WALK_LENGTHS = [129, 200, 300, 1370]


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("seq_len", WALK_LENGTHS)
def test_walk_stages_match_jax_online_kernel(seq_len, dtype, monkeypatch):
    """The walk's plain stages against JAX's online kernel ``_flash_kernel``
    (``ROW_KERNEL_MAX_TOKENS`` lowered to 0): both walk 128-key blocks, so
    their online softmax is the same block for block. fp32 to the file's
    tolerance, bf16 within 2 ulps (ops/compare.py's measure)."""
    monkeypatch.setattr(jpa, "ROW_KERNEL_MAX_TOKENS", 0)
    q, k, v = (t.reshape(2, seq_len, 64) for t in _heads(seq_len + 1, 1, 2, seq_len, 64))
    scale = 64 ** -0.5
    ref = np.asarray(jpa._flash_forward(*(jnp.asarray(t, dtype) for t in (q, k, v)), scale),
                     np.float32)
    ts = [torch.from_numpy(t) for t in (q, k, v)]
    if dtype == np.float32:
        out = tfa.attention_fwd_stages(*ts, scale)
        np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    else:
        out = tfa.attention_fwd_stages(*(t.to(torch.bfloat16) for t in ts), scale)
        assert out.dtype == torch.bfloat16
        max_ulps, _ = bf16_error(out, torch.from_numpy(ref))
        assert max_ulps <= 2.0, max_ulps


@pytest.mark.parametrize("seq_len", WALK_LENGTHS)
def test_walk_stages_match_twin_and_logsumexp(seq_len):
    """bf16: the walk's stages against the whole-row twin within the kernels'
    gate (6 ulps, RMS 1), and their log-sum-exp against the plain logsumexp
    of the scaled scores to 1e-5 relative."""
    q, k, v = (torch.from_numpy(t.reshape(2, seq_len, 64)).to(torch.bfloat16)
               for t in _heads(seq_len + 2, 1, 2, seq_len, 64))
    scale = 64 ** -0.5
    out, lse = tfa.attention_fwd_stages(q, k, v, scale, with_lse=True)
    assert bf16_close(out, tfa.flash_mha_reference(q, k, v, scale)), bf16_error(
        out, tfa.flash_mha_reference(q, k, v, scale))
    want = torch.logsumexp(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    assert lse.shape == (2, seq_len) and lse.dtype == torch.float32
    assert ((lse - want).abs() <= 1e-5 * want.abs()).all()


@pytest.mark.parametrize("name", list(attn_variants.VARIANTS))
def test_walk_variants_apply_to_the_kernel_header(name):
    """Each variant that ``cli.attn_variants`` times on the card is a set of
    edits of the kept ``csrc/attention_fwd.cuh``: each edit applies once,
    and only the kept variant leaves the header as it is."""
    with open(os.path.join(_build.CSRC_DIR, attn_variants.HEADER)) as f:
        header = f.read()
    assert (attn_variants.variant_source(name, header) == header) == (name == "kept")
