"""B9, the int8 probe's kernel (``ops/fused_mlp.ln_mlp_residual_int8_probe``),
against the JAX probe's Pallas body ``_kernel_var``
(tools/probe_mlp_int8_sweep.py:53) in interpret mode, on the CPU.

The test builds a ``pl.pallas_call`` around the body without the tool's TPU
``BlockSpec``s (one block of 32 rows, the module's ``H`` of 4096), so it runs
on the CPU. The CUDA kernel itself runs only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py); on a CPU tensor the
wrapper runs the plain version and launches nothing.

The epilogue's rounding order: JAX's ``_gelu_nocmp`` on a bf16 array rounds
every operation to bf16 (its scalars are weak-typed, so each constant is
rounded to bf16 first), and the port's plain version does the same, bit for
bit. Inside the kernel body XLA on the CPU keeps excess precision across
the fused cast f32 -> bf16 -> GELU -> f32, so there the two part in the
last bits of the hidden layer; after the int8 requantization that is held
under the rule of the B3 tests (under 0.1% of the elements beyond
2e-2 + 2e-2 |ref|, none beyond 0.25).
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aa_clip_iqm_tpu.ops.quant import quantize_linear_params as jquantize
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import fused_mlp
from aa_clip_iqm_tpu_torch.ops import quant as tquant
from aa_clip_iqm_tpu_torch.tools.probe_mlp_int8_sweep import VARIANTS
from aa_clip_iqm_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, D, H = 32, 1024, 4096


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sweep():
    spec = importlib.util.spec_from_file_location(
        "probe_mlp_int8_sweep", os.path.join(ROOT, "tools", "probe_mlp_int8_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.H == H
    return mod


@pytest.fixture(scope="module")
def case():
    """The probe's weights and input, drawn as the tool draws them, at 32
    rows: JAX's operands (the tool's ``bcast``) and the port's dicts, with
    the same int8 weights."""
    rng = np.random.default_rng(0)
    ln = {"scale": (rng.standard_normal(D) * 0.02 + 1).astype(np.float32),
          "bias": (rng.standard_normal(D) * 0.02).astype(np.float32)}
    fc = {"w": (rng.standard_normal((D, H)) * 0.02).astype(np.float32),
          "b": (rng.standard_normal(H) * 0.01).astype(np.float32)}
    pr = {"w": (rng.standard_normal((H, D)) * 0.02).astype(np.float32),
          "b": (rng.standard_normal(D) * 0.01).astype(np.float32)}
    x = (rng.standard_normal((M, D)) * 0.5).astype(np.float32)
    qfc = jquantize({k: jnp.asarray(v) for k, v in fc.items()})
    qpr = jquantize({k: jnp.asarray(v) for k, v in pr.items()})
    bcast = [jnp.asarray(ln["scale"]).reshape(1, D), jnp.asarray(ln["bias"]).reshape(1, D),
             qfc["w_q"], qfc["scale"].astype(jnp.float32).reshape(1, H),
             qfc["b"].astype(jnp.float32).reshape(1, H),
             qpr["w_q"], qpr["scale"].astype(jnp.float32).reshape(1, D),
             qpr["b"].astype(jnp.float32).reshape(1, D)]
    tmlp = {n: tquant.quantize_linear_params({k: torch.from_numpy(v) for k, v in p.items()})
            for n, p in (("c_fc", fc), ("c_proj", pr))}
    np.testing.assert_array_equal(np.asarray(qfc["w_q"]), tmlp["c_fc"]["w_q"].numpy())
    np.testing.assert_array_equal(np.asarray(qpr["w_q"]), tmlp["c_proj"]["w_q"].numpy())
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}
    return (jnp.asarray(x, jnp.bfloat16), bcast,
            (tln, tmlp, torch.from_numpy(x).to(torch.bfloat16)))


def _jax_kernel(sweep, xj, bcast, ep_bf16, ch):
    kern = functools.partial(sweep._kernel_var, ep_bf16=ep_bf16, ch=ch)
    out = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct((M, D), jnp.bfloat16),
                         interpret=True)(xj, *bcast)
    return np.asarray(out, np.float32)


def _held(out, ref):
    diff = np.abs(out - ref)
    loose = diff > 2e-2 + 2e-2 * np.abs(ref)
    assert loose.mean() < 1e-3, f"{loose.mean():%} elements off"
    assert diff.max() < 0.25, f"boundary flip too large: {diff.max()}"
    return diff


@pytest.mark.parametrize("ep_bf16,ch", VARIANTS)
def test_plain_matches_jax_kernel_var(sweep, case, ep_bf16, ch):
    xj, bcast, (tln, tmlp, xt) = case
    ref = _jax_kernel(sweep, xj, bcast, ep_bf16, ch)
    before = profiling.counters()
    out = fused_mlp.ln_mlp_residual_int8_probe(tln, tmlp, xt, ep_bf16, ch)
    assert _build.launches(before) == {}
    assert out.shape == (M, D) and out.dtype == torch.bfloat16
    diff = _held(out.float().numpy(), ref)
    if not ep_bf16:
        # In fp32 the two evaluate the same operations: a handful of flips.
        assert (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("ep_bf16,ch", VARIANTS)
def test_stages_match_jax_kernel_var_and_the_plain_version(sweep, case, ep_bf16, ch):
    xj, bcast, (tln, tmlp, xt) = case
    st = fused_mlp.ln_mlp_residual_int8_probe(tln, tmlp, xt, ep_bf16, ch, stages=True)
    assert torch.equal(st["y"], fused_mlp.ln_mlp_residual_int8_probe_reference(
        tln, tmlp, xt, ep_bf16, ch))
    assert st["sh"].shape == st["amax"].shape == (M, H // ch)
    assert st["h_q"].shape == (M, H) and st["h_q"].dtype == torch.int8
    assert torch.equal(st["sh"], st["amax"].clamp_min(1e-6) * (1.0 / 127.0))
    _held(st["y"].float().numpy(), _jax_kernel(sweep, xj, bcast, ep_bf16, ch))


def test_stages_on_a_given_row_pass(case):
    """``rows`` runs the GEMMs on a given row pass: the plain one gives the
    plain y; one x_q step moved changes its row's y only."""
    tln, tmlp, xt = case[2]
    st = fused_mlp.ln_mlp_residual_int8_probe_stages(tln, tmlp, xt, True, 1024)
    same = fused_mlp.ln_mlp_residual_int8_probe_stages(tln, tmlp, xt, True, 1024,
                                                       rows=(st["x_q"], st["sx"]))
    for k in st:
        assert torch.equal(same[k], st[k]), k
    x_q = st["x_q"].clone()
    x_q[3, 7] = x_q[3, 7] + (1 if x_q[3, 7] < 127 else -1)
    moved = fused_mlp.ln_mlp_residual_int8_probe_stages(tln, tmlp, xt, True, 1024,
                                                        rows=(x_q, st["sx"]))
    rows_changed = (moved["y"] != st["y"]).any(dim=-1)
    assert rows_changed[3] and rows_changed.sum() == 1


def test_variants_part_ways(case):
    """The epilogue's dtype and the chunk width are part of the numerics:
    each variant's output differs from the others' on the same inputs."""
    tln, tmlp, xt = case[2]
    outs = [fused_mlp.ln_mlp_residual_int8_probe(tln, tmlp, xt, e, c) for e, c in VARIANTS]
    for i in range(len(outs)):
        for j in range(i):
            assert (outs[i] != outs[j]).float().mean() > 0.1


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gelu_nocmp_rounds_as_jax(sweep, dtype):
    """The port's compare-free GELU equals JAX's ``_gelu_nocmp`` bit for bit
    on a standalone array, fp32 and bf16 (every operation and constant
    rounded to the array's dtype), and the epilogue's cast to bf16 and back
    is the one that ``probe_activation`` adds."""
    rng = np.random.default_rng(3)
    u = np.concatenate([(rng.standard_normal(20000) * 3).astype(np.float32),
                        np.linspace(-1e-2, 1e-2, 2001, dtype=np.float32)])
    j = np.asarray(jax.jit(sweep._gelu_nocmp)(jnp.asarray(u, dtype)), np.float32)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    t = fused_mlp.gelu_nocmp(torch.from_numpy(u).to(tdtype)).float().numpy()
    if dtype == jnp.float32:
        # XLA and PyTorch evaluate exp by their own polynomials: within a
        # few float32 ulps, which the negative tail, where 1 + erf cancels,
        # lifts to a few 1e-7 in absolute terms; the rest is the same
        # operations.
        np.testing.assert_allclose(t, j, rtol=2e-6, atol=5e-7)
    else:
        np.testing.assert_array_equal(t, j)
        act = fused_mlp.probe_activation(True)(torch.from_numpy(u)).numpy()
        np.testing.assert_array_equal(act, t)


def test_sign_term_at_and_near_zero(sweep):
    """The sign is x / (|x| + 1e-3), as JAX's: 0 at 0, not +-1 near 0
    (half at |x| = 1e-3), so erf_nocmp is not erf with a copysign."""
    x = torch.tensor([0.0, 1e-4, -1e-4, 1e-3, -1e-3, 0.5, -3.0])
    got = fused_mlp.erf_nocmp(x)
    want = np.asarray(sweep._erf_nocmp(jnp.asarray(x.numpy())), np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=1e-9)
    assert got[0] == 0 and fused_mlp.gelu_nocmp(x)[0] == 0
    ax = x.abs()
    y = got / (x / (ax + 1e-3))                     # the A-S magnitude
    copysign = torch.copysign(torch.ones_like(x), x) * y
    # At |x| = 1e-3 the factor is one half: copysign would double erf.
    np.testing.assert_allclose((copysign / got)[3:5].numpy(), [2.0, 2.0], rtol=1e-5)
    assert torch.equal(got[1], -got[2]) and got[1] > 0
    # In the GELU's negative tail the sign's 1e-3 dominates 1 + erf.
    t = torch.tensor([-4.0])
    assert fused_mlp.gelu_nocmp(t) < 4 * (0.5 * t * (1 + torch.erf(t / 2 ** 0.5)))


def test_wrapper_refuses_other_chunks(case):
    tln, tmlp, xt = case[2]
    with pytest.raises(ValueError, match="ch=512"):
        fused_mlp.ln_mlp_residual_int8_probe(tln, tmlp, xt, False, 512)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_mlp.ln_mlp_residual_int8_probe(tln, tmlp, xt.to("meta"), False, 1024)
