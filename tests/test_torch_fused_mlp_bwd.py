"""The port's fused-MLP gradients vs the JAX package: the plain dx (frozen
parameters) vs ``ln_mlp_residual_frozen``'s VJP through the Pallas dx kernel
(interpret mode, bf16), vs autograd through the chain (fp32), and the general
and int8 Functions' gradients vs JAX.

The CUDA dx kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against the plain dx there); on a
CPU tensor every backward here is plain PyTorch and launches nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import layers as jlayers
from aa_clip_iqm_tpu.ops import pallas_mlp as pm
from aa_clip_iqm_tpu.ops import quant as jquant
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import fused_mlp
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.utils import profiling

ACTS = ["gelu", "quick_gelu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    pm.INTERPRET = True
    yield
    pm.INTERPRET = False


def _case(seed, m, d, h):
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    ln = {"scale": 1.0 + 0.1 * w(d), "bias": 0.1 * w(d)}
    mlp = {"c_fc": {"w": w(d, h), "b": w(h)}, "c_proj": {"w": w(h, d), "b": w(d)}}
    x = rng.standard_normal((m, d)).astype(np.float32)
    g = rng.standard_normal((m, d)).astype(np.float32)
    return ln, mlp, x, g


def _to_torch(tree, dtype=None):
    return jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a)).to(dtype or torch.float32), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_mlp(mlp, dtype):
    """Matrices in ``dtype``, biases float32, as the port stores a backbone."""
    return {k: {"w": torch.from_numpy(p["w"]).to(dtype), "b": torch.from_numpy(p["b"])}
            for k, p in mlp.items()}


@pytest.mark.parametrize("act", ACTS)
def test_plain_dx_matches_pallas_dx_kernel_bf16(act):
    """bf16, tolerance 0.05 as the JAX package's own test of that kernel
    against its chain (tests/test_pallas_mlp.py): the kernel has an erf
    polynomial where the port has exact erf."""
    ln, mlp, x, g = _case(0, 130, 128, 512)
    jx, jg = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda xx: pm.ln_mlp_residual_frozen(
        _to_jax(ln), _to_jax(mlp), xx, jlayers.ACTIVATIONS[act]), jx)
    (ref,) = vjp(jg)
    out = fused_mlp.ln_mlp_residual_dx_reference(
        _to_torch(ln), _torch_mlp(mlp, torch.bfloat16),
        torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(),
        tlayers.ACTIVATIONS[act])
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", [(37, 64, 256), (130, 128, 384)])
def test_plain_dx_matches_jax_chain_fp32(act, m, d, h):
    """fp32 against JAX's VJP of the plain chain: 2e-5 of the largest entry."""
    ln, mlp, x, g = _case(1, m, d, h)
    _, vjp = jax.vjp(lambda xx: xx + jlayers.mlp_block(
        _to_jax(mlp), jlayers.layer_norm(_to_jax(ln), xx), jlayers.ACTIVATIONS[act]),
        jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(g))
    out = fused_mlp.ln_mlp_residual_dx_reference(
        _to_torch(ln), _to_torch(mlp), torch.from_numpy(x), torch.from_numpy(g),
        tlayers.ACTIVATIONS[act])
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5 * np.abs(ref).max())


@pytest.mark.parametrize("act", ACTS)
def test_frozen_function_matches_autograd_and_launches_nothing(act):
    ln, mlp, x, g = _case(2, 50, 64, 128)
    tln, tmlp, a = _to_torch(ln), _to_torch(mlp), tlayers.ACTIVATIONS[act]
    t = torch.from_numpy(x).requires_grad_(True)
    (ref,) = torch.autograd.grad(fused_mlp.ln_mlp_residual_reference(tln, tmlp, t, a), t,
                                 torch.from_numpy(g))
    before = profiling.counters()
    y = fused_mlp.ln_mlp_residual_frozen(tln, tmlp, t, a)
    assert y.grad_fn is not None
    (got,) = torch.autograd.grad(y, t, torch.from_numpy(g))
    assert _build.launches(before) == {}
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(y, fused_mlp.ln_mlp_residual(tln, tmlp, t, a))


@pytest.mark.parametrize("which", ["ln scale", "c_fc w", "c_proj b"])
def test_frozen_raises_on_a_parameter_that_requires_grad(which):
    """The JAX function hands such a parameter zeros without a word; the
    port refuses."""
    ln, mlp, x, _ = _case(3, 8, 64, 128)
    tln, tmlp = _to_torch(ln), _to_torch(mlp)
    {"ln scale": tln["scale"], "c_fc w": tmlp["c_fc"]["w"],
     "c_proj b": tmlp["c_proj"]["b"]}[which].requires_grad_(True)
    with pytest.raises(ValueError, match="requires grad"):
        fused_mlp.ln_mlp_residual_frozen(tln, tmlp, torch.from_numpy(x), tlayers.gelu)


@pytest.mark.parametrize("act", ACTS)
def test_general_function_parameter_gradients_match_jax(act):
    """x and every parameter, fp32, against jax.grad of ln_mlp_residual
    (whose VJP differentiates the plain chain)."""
    ln, mlp, x, g = _case(4, 40, 128, 256)

    def jloss(lp, mp, xx):
        return jnp.sum(pm._xla_chain(lp, mp, xx, jlayers.ACTIVATIONS[act], 1e-5)
                       * jnp.asarray(g))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(_to_jax(ln), _to_jax(mlp), jnp.asarray(x))
    tln, tmlp = _to_torch(ln), _to_torch(mlp)
    t = torch.from_numpy(x).requires_grad_(True)
    leaves = [*jax.tree.leaves(tln), *jax.tree.leaves(tmlp)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    y = fused_mlp.ln_mlp_residual(tln, tmlp, t, tlayers.ACTIVATIONS[act])
    assert type(y.grad_fn).__name__.startswith("_LnMlpResidual")
    grads = torch.autograd.grad(y, [*leaves, t], torch.from_numpy(g))
    refs = [*jax.tree.leaves(jg[0]), *jax.tree.leaves(jg[1]), jg[2]]
    assert len(grads) == len(refs) == 7
    for got, ref in zip(grads, refs):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())


def test_int8_function_straight_through_gradients_match_jax():
    """The int8 Function's backward is the straight-through estimator on the
    dequantized chain, as ``_int8_bwd``: dx, the LayerNorm gradients and the
    bias gradients against JAX in bf16 (2% of each gradient's largest entry,
    two frameworks' bf16 rounding points)."""
    ln, mlp, x, g = _case(5, 64, 128, 256)
    jq = {k: jquant.quantize_linear_params(_to_jax(p)) for k, p in mlp.items()}
    jx, jgc = jnp.asarray(x, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    _, vjp = jax.vjp(lambda lp, mp, xx: pm.ln_mlp_residual_int8(lp, mp, xx, jlayers.gelu),
                     _to_jax(ln), jq, jx)
    dln, dmlp, dx = vjp(jgc)
    tln = _to_torch(ln)
    tq = {k: {"w_q": torch.from_numpy(np.array(p["w_q"])),
              "scale": torch.from_numpy(np.asarray(p["scale"], np.float32)),
              "b": torch.from_numpy(np.asarray(p["b"], np.float32))}
          for k, p in jq.items()}
    t = torch.from_numpy(x).bfloat16().requires_grad_(True)
    wanted = [t, tln["scale"], tln["bias"], tq["c_fc"]["b"], tq["c_proj"]["b"]]
    for leaf in wanted[1:]:
        leaf.requires_grad_(True)
    assert fused_mlp.ln_mlp_residual_int8_ok(t, tq, tlayers.gelu)
    y = fused_mlp.ln_mlp_residual_int8(tln, tq, t, tlayers.gelu)
    grads = torch.autograd.grad(y, wanted, torch.from_numpy(g).bfloat16())
    refs = [dx, dln["scale"], dln["bias"], dmlp["c_fc"]["b"], dmlp["c_proj"]["b"]]
    for got, ref in zip(grads, refs):
        ref = np.asarray(ref, np.float32).reshape(got.shape)
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=0.02 * np.abs(ref).max())


# --------------------------------------------------------------------------
# The dx kernel's four stages on the GEMM core, and the core's new modes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", [(1, 128, 256), (77, 128, 384), (130, 256, 512)])
def test_dx_stages_compose_to_plain_dx_fp32(act, m, d, h):
    """fp32: the stages (LN pass, dual GEMM, GEMM 3 times ln_g, row pass)
    give the plain dx up to summation order: 1e-5 of the largest entry."""
    ln, mlp, x, g = _case(4, m, d, h)
    args = (_to_torch(ln), _to_torch(mlp), torch.from_numpy(x), torch.from_numpy(g),
            tlayers.ACTIVATIONS[act])
    ref = fused_mlp.ln_mlp_residual_dx_reference(*args).numpy()
    out = fused_mlp.ln_mlp_residual_dx_stages(*args).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("m,d,h", [(77, 128, 384), (130, 256, 512)])
def test_dx_stages_round_as_plain_dx_bf16(act, m, d, h):
    """bf16: the stages round where the plain dx rounds (xin and dh once, du
    never), so they agree within the card's gate (ops/compare.py: 6 ulps,
    RMS 1), held on dx - g; and both stay within 0.05 of JAX's Pallas dx
    kernel (interpret mode), its own test's tolerance."""
    from aa_clip_iqm_tpu_torch.ops.compare import BF16_MAX_ULPS, BF16_RMS_ULPS, bf16_error

    ln, mlp, x, g = _case(5, m, d, h)
    tx, tg = torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16()
    args = (_to_torch(ln), _torch_mlp(mlp, torch.bfloat16), tx, tg, tlayers.ACTIVATIONS[act])
    ref = fused_mlp.ln_mlp_residual_dx_reference(*args)
    out = fused_mlp.ln_mlp_residual_dx_stages(*args)
    assert out.dtype == torch.bfloat16 and out.shape == tx.shape
    max_ulps, rms_ulps = bf16_error(out, ref, tg)
    assert max_ulps <= BF16_MAX_ULPS and rms_ulps <= BF16_RMS_ULPS, (max_ulps, rms_ulps)
    _, vjp = jax.vjp(lambda xx: pm.ln_mlp_residual_frozen(
        _to_jax(ln), _to_jax(mlp), xx, jlayers.ACTIVATIONS[act]), jnp.asarray(x, jnp.bfloat16))
    (jref,) = vjp(jnp.asarray(g, jnp.bfloat16))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jref, np.float32),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("act", ACTS)
def test_core_new_modes_plain_versions(act):
    """The plain versions of the core's modes that B5 adds, on the CPU: the
    K-major product equals the N-major one on the transposed weight bit for
    bit, the fp32 epilogue keeps the scaled sum unrounded, the dual mode is
    (a2 W2^T) * act'(a W + b) rounded once; the wrappers take the plain
    versions on CPU tensors and launch nothing."""
    from aa_clip_iqm_tpu_torch.ops import gemm

    rng = np.random.default_rng(6)
    a, a2 = (torch.from_numpy(rng.standard_normal((33, 128)).astype(np.float32))
             for _ in range(2))
    w = torch.from_numpy((rng.standard_normal((128, 256)) * 0.1).astype(np.float32))
    w2t = torch.from_numpy((rng.standard_normal((256, 128)) * 0.1).astype(np.float32))
    b, scale = (torch.from_numpy(rng.standard_normal(256).astype(np.float32)) for _ in range(2))
    assert torch.equal(gemm.gemm_f32_reference(a, w2t, scale, w_kmajor=True),
                       gemm.gemm_f32_reference(a, w2t.t().contiguous(), scale))
    f32 = gemm.gemm_f32_reference(a, w, scale)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), (a.double() @ w.double() * scale.double()).numpy(),
                               rtol=1e-5, atol=1e-5)
    dact = gemm.DACTS[tlayers.ACTIVATIONS[act]]
    want = (a2.double() @ w2t.double().t()) * dact((a.double() @ w.double()) + b.double())
    ab, a2b, wb, w2b = (t.bfloat16() for t in (a, a2, w, w2t))
    dual = gemm.gemm_dual_dact_reference(ab, wb, b, a2b, w2b, tlayers.ACTIVATIONS[act])
    assert dual.dtype == torch.bfloat16
    np.testing.assert_allclose(dual.float().numpy(), (
        (a2b.double() @ w2b.double().t()) * dact(ab.double() @ wb.double() + b.double())
    ).to(torch.bfloat16).float().numpy(), rtol=8e-3, atol=1e-6)
    fp32 = gemm.gemm_dual_dact_reference(a, w, b, a2, w2t, tlayers.ACTIVATIONS[act])
    np.testing.assert_allclose(fp32.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    before = profiling.counters()
    assert torch.equal(gemm.gemm_f32(a, w2t, scale, w_kmajor=True),
                       gemm.gemm_f32_reference(a, w2t, scale, w_kmajor=True))
    assert torch.equal(gemm.gemm_dual_dact(ab, wb, b, a2b, w2b, tlayers.ACTIVATIONS[act]), dual)
    assert _build.launches(before) == {}
