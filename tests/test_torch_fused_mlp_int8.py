"""Port's fused int8 LN -> MLP -> residual twin vs the JAX Pallas kernel
(interpret mode, bf16), the plain version of the kernel's four stages, and
the three-way MLP dispatch of a block.

The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against this twin there); on a CPU
tensor the wrapper runs the twin and launches nothing.
"""
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import layers as jlayers
from aa_clip_iqm_tpu.ops import pallas_mlp as pm
from aa_clip_iqm_tpu.ops import quant as jquant
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import fused_mlp, gemm
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops import quant as tquant
from aa_clip_iqm_tpu_torch.utils import profiling

# The small cases of tests/test_pallas_mlp.py (m, d, h, activation); the
# chunk width follows from h: 512, 128 (384 = 3 x 128) and 1024.
CASES = [(130, 128, 512, "gelu"), (512, 128, 384, "quick_gelu"),
         (640, 256, 1024, "gelu")]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pm, "INTERPRET", True)


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


def _quantized(mlp):
    """The same integers on both sides: (JAX dicts, torch dicts)."""
    jq = {k: jquant.quantize_linear_params(_to(p, jnp.asarray)) for k, p in mlp.items()}
    tq = {k: tquant.quantize_linear_params(_to(p, torch.from_numpy)) for k, p in mlp.items()}
    for k in mlp:
        np.testing.assert_array_equal(np.asarray(jq[k]["w_q"]), tq[k]["w_q"].numpy())
    return jq, tq


def test_hidden_chunk_matches_jax():
    for h in (4096, 3072, 1024, 512, 384, 256, 128, 100, 64):
        assert fused_mlp.hidden_chunk(h) == pm._chunk(h)


@pytest.mark.parametrize("m,d,h,act", CASES)
def test_int8_twin_matches_jax_kernel(interpret, m, d, h, act):
    """The rule of tests/test_pallas_mlp.py:188-198: a flipped .5 rounding
    moves a quantized value by one step, so under 0.1% of the elements may
    lie beyond 2e-2 + 2e-2 |ref|, none beyond 0.25; and the result stays
    within 0.08 (relative to the largest value) of the float chain."""
    ln, mlp, x = _params(m + h, m, d, h)
    jq, tq = _quantized(mlp)
    jact, tact = jlayers.ACTIVATIONS[act], tlayers.ACTIVATIONS[act]
    xj = jnp.asarray(x, jnp.bfloat16)
    assert pm.ln_mlp_residual_int8_ok(xj, jq, jact)
    ref = np.asarray(pm.ln_mlp_residual_int8(_to(ln, jnp.asarray), jq, xj, jact),
                     np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tln = _to(ln, torch.from_numpy)
    assert fused_mlp.ln_mlp_residual_int8_ok(xt, tq, tact)
    before = profiling.counters()
    out_t = fused_mlp.ln_mlp_residual_int8(tln, tq, xt, tact)
    assert _build.launches(before) == {}
    assert out_t.shape == (m, d) and out_t.dtype == torch.bfloat16
    out = out_t.float().numpy()
    diff = np.abs(out - ref)
    loose = diff > 2e-2 + 2e-2 * np.abs(ref)
    assert loose.mean() < 1e-3, f"{loose.mean():%} elements off"
    assert diff.max() < 0.25, f"boundary flip too large: {diff.max()}"
    fp = fused_mlp.ln_mlp_residual_reference(
        tln, _to(mlp, torch.from_numpy), xt, tact).float().numpy()
    err = np.abs(out - fp).max() / (np.abs(fp).max() + 1e-9)
    assert err < 0.08, f"int8 twin diverges from the float chain: {err}"


@pytest.mark.parametrize("m,d,h,act", CASES)
def test_stages_equal_twin_bit_for_bit(m, d, h, act):
    """The plain version of the kernel's stages (row pass, GEMM 1 twice,
    GEMM 2 with the chunk fold) rounds where the twin rounds: its y is the
    twin's bit for bit, and each intermediate has the kernel's shape."""
    ln, mlp, x = _params(m + h, m, d, h)
    _, tq = _quantized(mlp)
    tact = tlayers.ACTIVATIONS[act]
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tln = _to(ln, torch.from_numpy)
    before = profiling.counters()
    st = fused_mlp.ln_mlp_residual_int8_with_stages(tln, tq, xt, tact)
    assert _build.launches(before) == {}
    assert torch.equal(st["y"], fused_mlp.ln_mlp_residual_int8_reference(tln, tq, xt, tact))
    ch = fused_mlp.hidden_chunk(h)
    assert st["x_q"].shape == (m, d) and st["x_q"].dtype == torch.int8
    assert st["h_q"].shape == (m, h) and st["h_q"].dtype == torch.int8
    assert st["sx"].shape == (m,) and st["amax"].shape == st["sh"].shape == (m, h // ch)
    # sh and h_q follow from amax as the kernel's pass b derives them.
    assert torch.equal(st["sh"], st["amax"].clamp_min(1e-6) * (1.0 / 127.0))
    assert st["h_q"].abs().max() == 127


@pytest.mark.parametrize("m,d,h,act", CASES)
def test_stages_match_jax_kernel(interpret, m, d, h, act):
    """The stages against JAX's ``_int8_kernel`` in interpret mode, under the
    rule of test_int8_twin_matches_jax_kernel."""
    ln, mlp, x = _params(m + h, m, d, h)
    jq, tq = _quantized(mlp)
    jact, tact = jlayers.ACTIVATIONS[act], tlayers.ACTIVATIONS[act]
    ref = np.asarray(pm.ln_mlp_residual_int8(_to(ln, jnp.asarray), jq,
                                             jnp.asarray(x, jnp.bfloat16), jact), np.float32)
    out = fused_mlp.ln_mlp_residual_int8_stages(
        _to(ln, torch.from_numpy), tq, torch.from_numpy(x).to(torch.bfloat16), tact)["y"]
    diff = np.abs(out.float().numpy() - ref)
    loose = diff > 2e-2 + 2e-2 * np.abs(ref)
    assert loose.mean() < 1e-3, f"{loose.mean():%} elements off"
    assert diff.max() < 0.25, f"boundary flip too large: {diff.max()}"


def test_stages_chunk_maximum_in_its_last_tile():
    """A chunk whose largest |hid| lies in its last 128 columns, in every
    row: the kernel's GEMM 1 tiles are 128 wide, so a maximum taken over
    the tile and not over the 1024-wide chunk would miss it. The stages'
    amax is the chunk's, their y is the twin's bit for bit, and the
    tile-wide maximum would quantize h_q otherwise."""
    m, d, h = 96, 128, 2048
    ln, mlp, x = _params(7, m, d, h)
    for j in range(0, h, 1024):
        mlp["c_fc"]["b"][j + 896:j + 1024] += 3.0
    _, tq = _quantized(mlp)
    tln = _to(ln, torch.from_numpy)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st = fused_mlp.ln_mlp_residual_int8_stages(tln, tq, xt, tlayers.gelu)
    assert torch.equal(st["y"], fused_mlp.ln_mlp_residual_int8_reference(tln, tq, xt, tlayers.gelu))
    hid = torch.cat(list(gemm._hidden_chunks(st["x_q"], tq["c_fc"]["w_q"], st["sx"],
                                             tq["c_fc"]["scale"], tq["c_fc"]["b"],
                                             tlayers.gelu, 1024)), dim=-1)
    for c in range(h // 1024):
        chunk = hid[:, c * 1024:(c + 1) * 1024].abs()
        assert (chunk.argmax(dim=-1) >= 896).all()
        assert torch.equal(st["amax"][:, c], chunk.amax(dim=-1))
        first_tile = chunk[:, :128].amax(dim=-1)
        assert (first_tile < st["amax"][:, c]).all()
        sh_tile = first_tile.clamp_min(1e-6) * (1.0 / 127.0)
        h_q_tile = torch.clamp(torch.round(hid[:, c * 1024:c * 1024 + 128] / sh_tile[:, None]),
                               -127, 127).to(torch.int8)
        assert not torch.equal(h_q_tile, st["h_q"][:, c * 1024:c * 1024 + 128])


def test_int8_core_modes_plain_versions():
    """ops/gemm.py's int8 modes on their own: the row pass is the twin's
    LayerNorm and row quantizer; pass a's maxima bound every |hid| of their
    chunk and are reached in it; pass b's h_q dequantizes to hid within half
    a step; GEMM 2 folds the chunks as one exact product per chunk."""
    m, d, h, ch = 40, 128, 512, 128
    ln, mlp, x = _params(11, m, d, h)
    _, tq = _quantized(mlp)
    tln = _to(ln, torch.from_numpy)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    x_q, sx = gemm.ln_quant_rows_reference(tln, xt)
    xin = tlayers.layer_norm(tln, xt.float())
    assert torch.equal(sx, xin.abs().amax(dim=-1).clamp_min(1e-6) * (1.0 / 127.0))
    assert ((x_q.float() * sx[:, None] - xin).abs() <= sx[:, None] / 2 * (1 + 1e-6)).all()
    fc = (tq["c_fc"]["w_q"], sx, tq["c_fc"]["scale"], tq["c_fc"]["b"], tlayers.quick_gelu)
    hid = torch.cat(list(gemm._hidden_chunks(x_q, *fc, ch)), dim=-1)
    amax = gemm.gemm_s8_amax_reference(x_q, *fc, ch)
    assert torch.equal(amax, hid.abs().reshape(m, h // ch, ch).amax(dim=-1))
    h_q, sh = gemm.gemm_s8_quant_reference(x_q, *fc, amax, ch)
    step = sh.repeat_interleave(ch, dim=-1)
    assert ((h_q.float() * step - hid).abs() <= step / 2 * (1 + 1e-6)).all()
    y = gemm.gemm_s8_proj_reference(h_q, tq["c_proj"]["w_q"], sh, tq["c_proj"]["scale"],
                                    tq["c_proj"]["b"], xt, ch)
    f = sum(torch.matmul(h_q[:, j:j + ch].double(), tq["c_proj"]["w_q"][j:j + ch].double())
            .float() * sh[:, i:i + 1] for i, j in enumerate(range(0, h, ch)))
    want = xt.float() + f * tq["c_proj"]["scale"].reshape(d) + tq["c_proj"]["b"]
    assert y.dtype == torch.bfloat16 and torch.equal(y, want.to(torch.bfloat16))


def _rn32(x):
    """A Fraction rounded to the nearest binary32, ties to even (normal range)."""
    if x == 0:
        return np.float32(0)
    sign, x = (-1 if x < 0 else 1), abs(x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while Fraction(2) ** e > x:
        e -= 1
    while Fraction(2) ** (e + 1) <= x:
        e += 1
    m = x / Fraction(2) ** (e - 23)
    f = m.numerator // m.denominator
    if m - f > Fraction(1, 2) or (m - f == Fraction(1, 2) and f % 2):
        f += 1
    return np.float32(sign * f * 2.0 ** (e - 23))


def _fma32(a, b, c):
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_division_by_reciprocal_is_exact():
    """The kernel's quantizers divide as ``gemm90::div_rn`` does: y = 1 / b
    rounded once per row, q = a * y, then twice q = fma(fma(-q, b, a), y, q).
    That is the correctly rounded a / b, which rint then sees: checked
    against float32 division on random quotients and on quotients within
    two ulps of the half-integers where rint decides. (a * y alone misses
    on some of them; the second correction is what Markstein's theorem
    needs, since one leaves q within an ulp.)"""
    rng = np.random.default_rng(0)
    n = 1500
    b = (rng.uniform(1e-4, 2.0, n) * 2.0 ** rng.integers(-8, 3, n)).astype(np.float32)
    a = (rng.uniform(-130.0, 130.0, n) * b).astype(np.float32)
    ties = ((rng.integers(-127, 127, n) + 0.5) * b).astype(np.float32)
    near = ties.copy()
    for i, k in enumerate(rng.integers(-2, 3, n)):
        for _ in range(abs(int(k))):
            near[i] = np.nextafter(near[i], np.float32(np.inf if k > 0 else -np.inf))
    for num in (a, ties, near):
        y = np.float32(1) / b
        q = num * y
        for _ in range(2):
            q = np.array([_fma32(_fma32(-qi, bi, ai), yi, qi)
                          for qi, yi, bi, ai in zip(q, y, b, num)], np.float32)
        np.testing.assert_array_equal(q, num / b)


def test_int8_twin_batched_shape_and_chunk_numerics():
    """(B, L, d) in, same shape out; and the per-chunk hidden scale is part
    of the result: one scale over the whole hidden axis gives another."""
    ln, mlp, x = _params(5, 140, 128, 2048)
    _, tq = _quantized(mlp)
    tln = _to(ln, torch.from_numpy)
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(2, 70, 128)
    out = fused_mlp.ln_mlp_residual_int8(tln, tq, xt, tlayers.gelu)
    assert out.shape == xt.shape and out.dtype == xt.dtype
    unfused = xt + tlayers.mlp_block(tq, tlayers.layer_norm(tln, xt), tlayers.gelu)
    assert not torch.equal(out, unfused)
    np.testing.assert_allclose(out.float().numpy(), unfused.float().numpy(), atol=0.1)


@pytest.mark.parametrize("dtype,quantized,width,route", [
    (torch.bfloat16, False, 128, "float"),
    (torch.float32, False, 128, "float"),
    (torch.bfloat16, True, 128, "int8"),
    (torch.float32, True, 128, "unfused"),     # the gate wants bf16
    (torch.bfloat16, True, 64, "unfused"),     # the gate wants d % 128 == 0
])
def test_block_dispatch(monkeypatch, dtype, quantized, width, route):
    """Which of the three MLP routes a block takes (JAX models/clip.py:240)."""
    ln, mlp, x = _params(9, 12, width, 4 * width)
    tmlp = _to(mlp, torch.from_numpy)
    if quantized:
        tmlp = {k: tquant.quantize_linear_params(p) for k, p in tmlp.items()}
    rng = np.random.default_rng(3)
    attn = {"qkv": {"w": torch.from_numpy(rng.standard_normal((width, 3 * width)).astype(np.float32) * 0.05),
                    "b": torch.zeros(3 * width)},
            "out": {"w": torch.from_numpy(rng.standard_normal((width, width)).astype(np.float32) * 0.05),
                    "b": torch.zeros(width)}}
    tln = _to(ln, torch.from_numpy)
    block = {"ln_1": tln, "attn": attn, "ln_2": tln, "mlp": tmlp}
    hits = []

    def spy(name):
        real = getattr(tclip, name)

        def wrapped(*a, **k):
            hits.append(name)
            return real(*a, **k)

        monkeypatch.setattr(tclip, name, wrapped)

    for name in ("ln_mlp_residual", "ln_mlp_residual_int8", "mlp_block"):
        spy(name)
    xt = torch.from_numpy(x).to(dtype).reshape(1, 12, width)
    out = tclip._run_block(block, xt, 2, tlayers.gelu)
    assert out.shape == xt.shape and torch.isfinite(out.float()).all()
    want = {"float": "ln_mlp_residual", "int8": "ln_mlp_residual_int8",
            "unfused": "mlp_block"}[route]
    assert hits == [want]


def test_int8_wrapper_refuses_other_devices():
    ln, mlp, _ = _params(4, 8, 128, 512)
    _, tq = _quantized(mlp)
    x = torch.empty((8, 128), device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.ln_mlp_residual_int8(_to(ln, torch.from_numpy), tq, x, tlayers.gelu)
