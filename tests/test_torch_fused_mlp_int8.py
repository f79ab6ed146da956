"""Port's fused int8 LN -> MLP -> residual twin vs the JAX Pallas kernel
(interpret mode, bf16), and the three-way MLP dispatch of a block.

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
from aa_clip_iqm_tpu.ops import quant as jquant
from aa_clip_iqm_tpu_torch.models import clip as tclip
from aa_clip_iqm_tpu_torch.ops import fused_mlp
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops import quant as tquant

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
    fused_mlp.reset_launches()
    out_t = fused_mlp.ln_mlp_residual_int8(tln, tq, xt, tact)
    assert fused_mlp.INT8_LAUNCHES == 0 and fused_mlp.LAUNCHES == 0
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
