"""The aaclip:: custom ops (ops/custom_ops.py) on the CPU.

For each op: ``torch.library.opcheck`` on CPU inputs (schema, fake
implementation, autograd registration, dispatch under AOT); its CPU
implementation equals the wrapper's plain version bit for bit; and it is
held to the JAX Pallas kernel in interpret mode at the tolerances of the
existing tests (fp32 attention rtol 2e-4 / atol 2e-5, tests/test_pallas_
attention.py; bf16 MLP 0.05, tests/test_pallas_mlp.py; the int8 MLP's
rounding-flip rule of tests/test_torch_fused_mlp_int8.py; the bf16 fused
half-block 0.06, tests/test_torch_attn_block.py). The fakes' shapes, and
the card limits they apply to fake CUDA tensors, are checked too. The CUDA
implementations run on the card only (tests/test_torch_cuda_graphs.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from aa_clip_iqm_tpu.ops import layers as jlayers
from aa_clip_iqm_tpu.ops import pallas_attention as jpa
from aa_clip_iqm_tpu.ops import pallas_attn_block as jpb
from aa_clip_iqm_tpu.ops import pallas_mlp as jpm
from aa_clip_iqm_tpu.ops import quant as jquant
from aa_clip_iqm_tpu_torch.ops import attn_block, custom_ops, flash_attention, fused_mlp
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops import packed_attention as tpa
from aa_clip_iqm_tpu_torch.ops import quant as tquant

OPS = torch.ops.aaclip


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    for mod in (jpa, jpm, jpb):
        monkeypatch.setattr(mod, "INTERPRET", True)


def _rng(seed):
    return np.random.default_rng(seed)


def _mlp_params(seed, d, h):
    rng = _rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    ln = {"scale": 1.0 + 0.1 * w(d), "bias": 0.1 * w(d)}
    mlp = {"c_fc": {"w": w(d, h), "b": w(h)}, "c_proj": {"w": w(h, d), "b": w(d)}}
    return ln, mlp


def _attn_params(seed, d):
    rng = _rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    ln = {"scale": 1.0 + 0.1 * w(d), "bias": 0.1 * w(d)}
    attn = {"qkv": {"w": w(d, 3 * d), "b": 0.1 * w(3 * d)}, "out": {"w": w(d, d), "b": 0.1 * w(d)}}
    return ln, attn


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _t(tree):
    return _tree(tree, torch.from_numpy)


def _j(tree):
    return _tree(tree, jnp.asarray)


def test_namespace_holds_the_six_forward_ops():
    for name in custom_ops.OPS:
        assert hasattr(OPS, name), name
        for key in ("CPU", "CUDA", "Meta"):          # the plain version, the kernel, the fake
            assert torch._C._dispatch_has_kernel_for_dispatch_key(f"aaclip::{name}", key), (
                name, key)


# --------------------------------------------------------------------------
# B1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vv,valid_len", [(False, None), (True, None), (False, 280)])
def test_flash_mha_packed_op(vv, valid_len):
    b, l, heads, hd = 2, 300, 2, 64
    qkv = _rng(l + vv).standard_normal((b, l, 3 * heads * hd)).astype(np.float32)
    qt = torch.from_numpy(qkv)
    scale = hd ** -0.5
    torch.library.opcheck(custom_ops.flash_mha_packed, (qt, heads, scale, vv, valid_len))
    torch.library.opcheck(custom_ops.flash_mha_packed_lse, (qt, heads, scale, vv, valid_len))
    tpa.reset_launches()
    out = OPS.flash_mha_packed(qt, heads, scale, vv, valid_len)
    out_l, lse = OPS.flash_mha_packed_lse(qt, heads, scale, vv, valid_len)
    assert tpa.LAUNCHES == 0
    assert torch.equal(out, tpa.flash_mha_packed_reference(qt, heads, scale, vv, valid_len))
    assert torch.equal(out_l, out)
    assert torch.equal(lse, tpa.packed_lse_reference(qt, heads, scale, vv, valid_len))
    assert torch.equal(tpa.flash_mha_packed(qt, heads, scale, vv, valid_len), out)
    ref = np.asarray(jpa.flash_mha_packed(jnp.asarray(qkv), heads, scale, vv, valid_len))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# B2 and B3
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_ln_mlp_residual_op(act):
    m, d, h = 130, 128, 512
    ln, mlp = _mlp_params(m + d, d, h)
    x = _rng(3).standard_normal((m, d)).astype(np.float32)
    tln, tmlp, xt = _t(ln), _t(mlp), torch.from_numpy(x).to(torch.bfloat16)
    args = (xt, tln["scale"], tln["bias"], tmlp["c_fc"]["w"], tmlp["c_fc"]["b"],
            tmlp["c_proj"]["w"], tmlp["c_proj"]["b"], act, 1e-5)
    torch.library.opcheck(custom_ops.ln_mlp_residual, args)
    fused_mlp.reset_launches()
    out = OPS.ln_mlp_residual(*args)
    assert fused_mlp.LAUNCHES == 0 and out.dtype == torch.bfloat16
    tact = tlayers.ACTIVATIONS[act]
    assert torch.equal(out, fused_mlp.ln_mlp_residual_reference(tln, tmlp, xt, tact))
    assert torch.equal(fused_mlp.ln_mlp_residual(tln, tmlp, xt, tact), out)
    ref = jpm.ln_mlp_residual(_j(ln), _j(mlp), jnp.asarray(x, jnp.bfloat16),
                              jlayers.ACTIVATIONS[act])
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_ln_mlp_residual_int8_op(act):
    m, d, h = 96, 128, 512
    ln, mlp = _mlp_params(m + h, d, h)
    x = _rng(4).standard_normal((m, d)).astype(np.float32)
    jq = {k: jquant.quantize_linear_params(_j(p)) for k, p in mlp.items()}
    tq = {k: tquant.quantize_linear_params(_t(p)) for k, p in mlp.items()}
    tln, xt = _t(ln), torch.from_numpy(x).to(torch.bfloat16)
    fc, proj = tq["c_fc"], tq["c_proj"]
    args = (xt, tln["scale"], tln["bias"], fc["w_q"], fc["scale"], fc["b"], proj["w_q"],
            proj["scale"], proj["b"], act, 1e-5)
    torch.library.opcheck(custom_ops.ln_mlp_residual_int8, args)
    fused_mlp.reset_launches()
    out = OPS.ln_mlp_residual_int8(*args)
    assert fused_mlp.INT8_LAUNCHES == 0 and out.dtype == torch.bfloat16
    tact = tlayers.ACTIVATIONS[act]
    assert torch.equal(out, fused_mlp.ln_mlp_residual_int8_reference(tln, tq, xt, tact))
    assert torch.equal(fused_mlp.ln_mlp_residual_int8(tln, tq, xt, tact), out)
    ref = np.asarray(jpm.ln_mlp_residual_int8(_j(ln), jq, jnp.asarray(x, jnp.bfloat16),
                                              jlayers.ACTIVATIONS[act]), np.float32)
    diff = np.abs(out.float().numpy() - ref)
    assert (diff > 2e-2 + 2e-2 * np.abs(ref)).mean() < 1e-3
    assert diff.max() < 0.25


# --------------------------------------------------------------------------
# B7
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq_len", [256, 300])
def test_flash_mha_op(seq_len):
    rng = _rng(seq_len)
    q, k, v = (rng.standard_normal((2, seq_len, 64)).astype(np.float32) for _ in range(3))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    scale = 64 ** -0.5
    torch.library.opcheck(custom_ops.flash_mha, (qt, kt, vt, scale))
    flash_attention.reset_launches()
    out = OPS.flash_mha(qt, kt, vt, scale)
    assert flash_attention.LAUNCHES == 0
    assert torch.equal(out, flash_attention.flash_mha_reference(qt, kt, vt, scale))
    assert torch.equal(flash_attention.flash_mha(qt[None], kt[None], vt[None], scale)[0], out)
    ref = np.asarray(jpa.flash_mha(*(jnp.asarray(a[None]) for a in (q, k, v)), scale))[0]
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)


# --------------------------------------------------------------------------
# B8
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vv,valid_len", [(False, None), (True, None), (False, 100)])
def test_ln_attn_residual_op(vv, valid_len):
    b, l, d, heads = 2, 128, 128, 2
    ln, attn = _attn_params(l + d + vv, d)
    x = _rng(5 + vv).standard_normal((b, l, d)).astype(np.float32)
    tln, tattn, xt = _t(ln), _t(attn), torch.from_numpy(x).to(torch.bfloat16)
    args = (xt, tln["scale"], tln["bias"], tattn["qkv"]["w"], tattn["qkv"]["b"],
            tattn["out"]["w"], tattn["out"]["b"], heads, vv, valid_len, 1e-5)
    torch.library.opcheck(custom_ops.ln_attn_residual, args)
    attn_block.reset_launches()
    out = OPS.ln_attn_residual(*args)
    assert attn_block.LAUNCHES == 0 and out.dtype == torch.bfloat16
    assert torch.equal(out, attn_block.ln_attn_residual_reference(tln, tattn, xt, heads, vv,
                                                                  valid_len))
    assert torch.equal(attn_block.ln_attn_residual(tln, tattn, xt, heads, vv, valid_len), out)
    ref = jpb.ln_attn_residual(_j(ln), _j(attn), jnp.asarray(x, jnp.bfloat16), heads, vv,
                               valid_len)
    n = l if valid_len is None else valid_len
    np.testing.assert_allclose(out.float().numpy()[:, :n], np.asarray(ref, np.float32)[:, :n],
                               rtol=0.06, atol=0.06)


# --------------------------------------------------------------------------
# The fakes: shapes on the meta device, the card's limits on fake CUDA
# --------------------------------------------------------------------------

def test_fakes_on_meta_give_shapes_and_dtypes():
    meta = dict(device="meta")
    qkv = torch.empty((2, 300, 3 * 128), dtype=torch.bfloat16, **meta)
    out, lse = OPS.flash_mha_packed_lse(qkv, 2, 0.125, False, None)
    assert out.shape == (2, 300, 128) and out.dtype == torch.bfloat16
    assert lse.shape == (2, 2, 300) and lse.dtype == torch.float32
    assert OPS.flash_mha_packed(qkv, 2, 0.125, True, 10).shape == (2, 300, 128)
    x = torch.empty((5, 128), dtype=torch.bfloat16, **meta)
    f32 = dict(dtype=torch.float32, **meta)
    ln = (torch.empty(128, **f32), torch.empty(128, **f32))
    y = OPS.ln_mlp_residual(x, *ln, torch.empty((128, 512), dtype=torch.bfloat16, **meta),
                            torch.empty(512, **f32),
                            torch.empty((512, 128), dtype=torch.bfloat16, **meta),
                            torch.empty(128, **f32), "gelu", 1e-5)
    assert y.shape == x.shape and y.dtype == x.dtype
    q = torch.empty((4, 300, 64), **f32)
    assert OPS.flash_mha(q, q, q, 0.125).shape == q.shape


def test_fake_cuda_applies_the_card_limits():
    """Under a fake mode, CUDA tensors need no card: a trace for the card
    fails where the card's kernels would, and passes where they run."""
    with FakeTensorMode():
        qkv = torch.empty((1, 300, 3 * 128), dtype=torch.bfloat16, device="cuda")
        assert OPS.flash_mha_packed(qkv, 2, 0.125, False, None).shape == (1, 300, 128)
        with pytest.raises(ValueError, match="head width"):
            OPS.flash_mha_packed(qkv, 4, 0.125, False, None)     # heads of 32
        q = torch.empty((2, 300, 32), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="head width"):
            OPS.flash_mha(q, q, q, 0.125)
        f32 = dict(dtype=torch.float32, device="cuda")
        x = torch.empty((4, 192), dtype=torch.bfloat16, device="cuda")
        wq = torch.empty((192, 512), dtype=torch.int8, device="cuda")
        pq = torch.empty((512, 192), dtype=torch.int8, device="cuda")
        with pytest.raises(ValueError, match="multiples of 128"):
            OPS.ln_mlp_residual_int8(x, torch.empty(192, **f32), torch.empty(192, **f32), wq,
                                     torch.empty((1, 512), **f32), torch.empty(512, **f32), pq,
                                     torch.empty((1, 192), **f32), torch.empty(192, **f32),
                                     "gelu", 1e-5)
        xb = torch.empty((1, 128, 128), dtype=torch.bfloat16, device="cuda")
        bf = dict(dtype=torch.bfloat16, device="cuda")
        args = (torch.empty(128, **f32), torch.empty(128, **f32), torch.empty((128, 384), **bf),
                torch.empty(384, **f32), torch.empty((128, 128), **bf), torch.empty(128, **f32))
        assert OPS.ln_attn_residual(xb, *args, 2, False, None, 1e-5).shape == xb.shape
        with pytest.raises(ValueError, match="head width"):
            OPS.ln_attn_residual(xb, *args, 1, False, None, 1e-5)   # one head of 128
    # On the CPU the same shapes run the plain versions, which take any width.
    qkv = torch.zeros((1, 300, 3 * 128))
    assert OPS.flash_mha_packed(qkv, 4, 0.125, False, None).shape == (1, 300, 128)


def test_wrappers_pass_traced_tensors_and_refuse_real_meta():
    """A real meta tensor is refused as before; a fake one (under a trace)
    reaches the op's fake implementation."""
    with pytest.raises(ValueError, match="unsupported device"):
        tpa.flash_mha_packed(torch.empty((1, 8, 3 * 64), device="meta"), 1, 0.125)
    with FakeTensorMode() as mode:
        qkv = mode.from_tensor(torch.empty((1, 300, 3 * 128), device="meta"))
        assert custom_ops.is_traced(qkv)
        assert tpa.flash_mha_packed(qkv, 2, 0.125).shape == (1, 300, 128)
