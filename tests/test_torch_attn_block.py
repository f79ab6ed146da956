"""Port's fused attention half-block (LN -> qkv -> attention -> out-proj ->
residual) vs the JAX package's ``pallas_attn_block`` (interpret mode); the
plain versions of the four stages the kernel runs, against both.

The CUDA kernel itself runs only on the card (chip_smoke.py and
tests/test_torch_cuda_kernels.py hold it against its plain twin there); on a
CPU tensor ``ln_attn_residual`` runs the twin and launches nothing. bf16
outputs are held to the JAX tests' 0.06, gradients to their 0.08.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aa_clip_iqm_tpu.ops import pallas_attention as jpa
from aa_clip_iqm_tpu.ops import pallas_attn_block as jpb
from aa_clip_iqm_tpu_torch.ops import _build
from aa_clip_iqm_tpu_torch.ops import attn_block as tpb
from aa_clip_iqm_tpu_torch.ops import gemm as tgemm
from aa_clip_iqm_tpu_torch.ops import layers as tlayers
from aa_clip_iqm_tpu_torch.ops import packed_attention as tpa
from aa_clip_iqm_tpu_torch.ops.compare import bf16_close, bf16_error
from aa_clip_iqm_tpu_torch.utils import profiling

TOL = 0.06


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def interpret_mode():
    jpb.INTERPRET = True
    jpa.INTERPRET = True
    yield
    jpb.INTERPRET = False
    jpa.INTERPRET = False


def _params(seed, d):
    """The JAX tests' parameters (tests/test_pallas_attn_block.py), as numpy."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float32)

    ln = {"scale": 1.0 + 0.1 * w(d), "bias": 0.1 * w(d)}
    attn = {"qkv": {"w": w(d, 3 * d), "b": 0.1 * w(3 * d)},
            "out": {"w": w(d, d), "b": 0.1 * w(d)}}
    return ln, attn


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _jax(tree):
    return _tree(tree, jnp.asarray)


def _torch(tree, requires_grad=False):
    return _tree(tree, lambda a: torch.from_numpy(a).requires_grad_(requires_grad))


def _x(seed, b, l, d):
    return np.random.default_rng(seed).standard_normal((b, l, d)).astype(np.float32)


@pytest.mark.parametrize("b,l,d,heads,vv,valid", [
    (2, 128, 128, 2, False, None),   # hd=64 -> two heads per 128-panel
    (1, 128, 128, 2, True, None),    # v-v surgery path
    (2, 128, 128, 2, False, 100),    # keys masked short of the length
    (1, 256, 256, 2, False, None),   # hd=128 -> one head per panel, 2 panels
    (1, 128, 128, 1, True, 70),      # single hd=128 head + vv + mask
])
def test_matches_jax_kernel(b, l, d, heads, vv, valid):
    ln, attn = _params(l + d + heads, d)
    x = _x(b + l, b, l, d)
    ref = jpb.ln_attn_residual(_jax(ln), _jax(attn), jnp.asarray(x, jnp.bfloat16), heads,
                               vv, valid)
    before = profiling.counters()
    out = tpb.ln_attn_residual(_torch(ln), _torch(attn),
                               torch.from_numpy(x).to(torch.bfloat16), heads, vv, valid)
    assert _build.launches(before) == {} and out.dtype == torch.bfloat16
    n = valid if valid is not None else l
    np.testing.assert_allclose(out.float().numpy()[:, :n], np.asarray(ref, np.float32)[:, :n],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("vv", [False, True])
def test_ragged_length_matches_jax_chain(vv):
    """A length that is no multiple of 128, which the JAX gate refuses (its
    tower pre-pads) and the port takes (the kernel masks its own tail): held
    to the JAX chain."""
    b, l, d, heads = 1, 130, 128, 2
    ln, attn = _params(7, d)
    x = _x(8, b, l, d)
    assert not jpb.ln_attn_residual_ok(jnp.asarray(x, jnp.bfloat16), _jax(attn), heads)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert tpb.ln_attn_residual_ok(xt, _torch(attn), heads)
    ref = jpb._xla_chain(_jax(ln), _jax(attn), jnp.asarray(x, jnp.bfloat16), heads, vv,
                         None, 1e-5)
    out = tpb.ln_attn_residual(_torch(ln), _torch(attn), xt, heads, vv)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=TOL, atol=TOL)


def test_gate_mirrors_jax():
    """ln_attn_residual_ok is JAX's gate without its backend test and without
    L % 128: the same answer on every case of tests/test_pallas_attn_block.py
    but the ragged length."""
    _, attn = _params(1, 128)
    ja, ta = _jax(attn), _torch(attn)
    q = {"qkv": {"w": attn["qkv"]["w"].astype(np.int8), "b": attn["qkv"]["b"]},
         "out": attn["out"]}
    q8 = {"qkv": {"w_q": attn["qkv"]["w"].astype(np.int8), "scale": np.ones(384, np.float32),
                  "b": attn["qkv"]["b"]}, "out": attn["out"]}
    cases = [((2, 128, 128), jnp.bfloat16, attn, 2), ((2, 128, 128), jnp.float32, attn, 2),
             ((128, 128), jnp.bfloat16, attn, 2), ((2, 128, 128), jnp.bfloat16, q, 2),
             ((2, 128, 128), jnp.bfloat16, q8, 2), ((2, 128, 128), jnp.bfloat16, attn, 4),
             ((2, 128, 128), jnp.bfloat16, attn, 3)]
    tdt = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    for shape, dt, params, heads in cases:
        want = jpb.ln_attn_residual_ok(jnp.zeros(shape, dt), _jax(params), heads)
        got = tpb.ln_attn_residual_ok(torch.zeros(shape, dtype=tdt[dt]), _torch(params),
                                      heads)
        assert got == want, (shape, dt, heads)
    assert jpb.ln_attn_residual_ok(jnp.zeros((2, 128, 128), jnp.bfloat16), ja, 2)
    assert not jpb.ln_attn_residual_ok(jnp.zeros((2, 130, 128), jnp.bfloat16), ja, 2)
    assert tpb.ln_attn_residual_ok(torch.zeros((2, 130, 128), dtype=torch.bfloat16), ta, 2)


def test_function_gradients_match_jax_vjp():
    """The Function's backward (autograd through the plain chain) against
    JAX's custom VJP (tests/test_pallas_attn_block.py:129), for x and every
    attention parameter."""
    ln, attn = _params(6, 128)
    x = _x(9, 1, 128, 128)
    jln = _jax(ln)

    def loss_kernel(ap, xx):
        return jnp.sum(jpb.ln_attn_residual(jln, ap, xx, 2, False, 100)
                       .astype(jnp.float32)[:, :100] ** 2)

    gk = jax.grad(loss_kernel, argnums=(0, 1))(_jax(attn), jnp.asarray(x, jnp.bfloat16))
    tattn = _torch(attn, requires_grad=True)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    y = tpb.ln_attn_residual(_torch(ln), tattn, xt, 2, False, 100)
    assert y.grad_fn is not None
    (y.float()[:, :100] ** 2).sum().backward()
    got = [tattn["out"]["b"].grad, tattn["out"]["w"].grad, tattn["qkv"]["b"].grad,
           tattn["qkv"]["w"].grad, xt.grad]
    want = [gk[0]["out"]["b"], gk[0]["out"]["w"], gk[0]["qkv"]["b"], gk[0]["qkv"]["w"], gk[1]]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   rtol=0.08, atol=0.08)


# The four stages the kernel runs on the card (the LayerNorm pass, the qkv
# projection, attention, the out-projection with the residual), each through
# its plain version.
STAGE_CASES = [
    (2, 128, 128, 2, False, None),
    (1, 128, 128, 2, True, None),
    (2, 128, 128, 2, False, 100),    # keys masked short of the length
    (1, 130, 128, 2, True, 70),      # ragged length, vv and a mask
]


def _stages(ln, attn, x, heads, vv, valid):
    d = x.shape[-1]
    w, b = attn["qkv"]["w"], attn["qkv"]["b"]
    if vv:
        w, b = w[:, 2 * d:], b[2 * d:]
    xn = tlayers.layer_norm(ln, x)
    proj = tgemm.gemm_bias_act_reference(xn, w, b)
    q, k, v = (proj,) * 3 if vv else proj.split(d, dim=-1)
    o = tpa.mha_reference(q, k, v, heads, (d // heads) ** -0.5, valid)
    return xn, proj, o, tgemm.gemm_bias_residual_reference(o, attn["out"]["w"],
                                                           attn["out"]["b"], x)


@pytest.mark.parametrize("b,l,d,heads,vv,valid", STAGE_CASES)
def test_stages_equal_twin_fp32(b, l, d, heads, vv, valid):
    """In fp32 the stages compose to the twin bit for bit (and
    ln_attn_residual_stages is that composition)."""
    ln, attn = (_torch(t) for t in _params(l + heads, d))
    x = torch.from_numpy(_x(b + d, b, l, d))
    out = _stages(ln, attn, x, heads, vv, valid)[3]
    assert torch.equal(out, tpb.ln_attn_residual_reference(ln, attn, x, heads, vv, valid))
    assert torch.equal(out, tpb.ln_attn_residual_stages(ln, attn, x, heads, vv, valid))


@pytest.mark.parametrize("b,l,d,heads,vv,valid", STAGE_CASES)
def test_stages_bf16_match_twin_and_jax(b, l, d, heads, vv, valid):
    """In bf16 the first three stages are the twin's intermediates bit for
    bit (for vv the projection's value section alone equals the value
    columns of the twin's whole projection); the composition, which rounds
    the output once after the residual, is held to the twin in bf16 ulps as
    the kernel is on the card, and to JAX's kernel (its chain where the
    length is ragged) at the file's tolerance."""
    ln_n, attn_n = _params(l + d + heads, d)
    x = _x(l + b, b, l, d)
    ln, attn = _torch(ln_n), _torch(attn_n)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xn, proj, o, out = _stages(ln, attn, xt, heads, vv, valid)
    assert torch.equal(out, tpb.ln_attn_residual_stages(ln, attn, xt, heads, vv, valid))
    assert torch.equal(xn, tlayers.layer_norm(ln, xt))
    qkv = tlayers.linear(attn["qkv"], xn)
    assert torch.equal(proj, qkv[..., 2 * d:] if vv else qkv)
    assert torch.equal(o, tpa.flash_mha_packed_reference(qkv, heads, (d // heads) ** -0.5, vv,
                                                         valid))
    twin = tpb.ln_attn_residual_reference(ln, attn, xt, heads, vv, valid)
    assert bf16_close(out, twin, xt), bf16_error(out, twin, xt)
    xj = jnp.asarray(x, jnp.bfloat16)
    if l % 128:
        ref = jpb._xla_chain(_jax(ln_n), _jax(attn_n), xj, heads, vv, valid, 1e-5)
    else:
        ref = jpb.ln_attn_residual(_jax(ln_n), _jax(attn_n), xj, heads, vv, valid)
    n = valid if valid is not None else l
    np.testing.assert_allclose(out.float().numpy()[:, :n], np.asarray(ref, np.float32)[:, :n],
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("b,l,d,heads,vv,valid", STAGE_CASES)
def test_stages_with_the_walk_match_twin(b, l, d, heads, vv, valid):
    """With ``walk`` the attention stage is the plain version of the
    attention kernel's tile walk: in bf16 its output is held to the twin
    within the kernels' gate, and its attention output equals the packed
    walk's on the projection."""
    ln_n, attn_n = _params(l + d + heads + 1, d)
    ln, attn = _torch(ln_n), _torch(attn_n)
    xt = torch.from_numpy(_x(l + b + 1, b, l, d)).to(torch.bfloat16)
    out = tpb.ln_attn_residual_stages(ln, attn, xt, heads, vv, valid, walk=True)
    twin = tpb.ln_attn_residual_reference(ln, attn, xt, heads, vv, valid)
    assert out.dtype == torch.bfloat16 and bf16_close(out, twin, xt), bf16_error(out, twin, xt)
    xn, proj, _, _ = _stages(ln, attn, xt, heads, vv, valid)
    o = tpa.flash_mha_packed_stages(torch.cat([proj] * 3, dim=-1) if vv else proj, heads,
                                    (d // heads) ** -0.5, False, valid)
    want = tgemm.gemm_bias_residual_reference(o, attn["out"]["w"], attn["out"]["b"], xt)
    assert torch.equal(out, want)


# B8's halves alone (the front: LayerNorm pass and qkv product; the back:
# the out-projection with the residual), which the model's blocks run around
# the routed attention kernel wherever autograd records nothing.

HALF_CASES = [c for c in STAGE_CASES if not c[4]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d,heads,vv,valid", HALF_CASES)
def test_halves_are_the_kernels_stages(b, l, d, heads, vv, valid, dtype):
    """The front's plain version is the kernel's first two stages and the
    back's its last, bit for bit in float32 and in bf16, through the
    wrappers and the ``aaclip::`` ops alike; with the attention between them
    they compose ``ln_attn_residual_stages``. In bf16 the back, which rounds
    once, is held to the chain's ``x + linear(out, o)`` in bf16 ulps."""
    ln, attn = (_torch(t) for t in _params(l + heads + 2, d))
    x = torch.from_numpy(_x(b + d + 2, b, l, d)).to(dtype)
    xn, proj, o, out = _stages(ln, attn, x, heads, False, valid)
    front = tpb.ln_attn_front(ln, attn["qkv"], x)
    assert torch.equal(front, proj)
    assert torch.equal(torch.ops.aaclip.ln_attn_front(x, ln["scale"], ln["bias"],
                                                      attn["qkv"]["w"], attn["qkv"]["b"], 1e-5),
                       proj)
    back = tpb.ln_attn_back(attn["out"], o, x)
    assert torch.equal(back, out)
    assert torch.equal(torch.ops.aaclip.ln_attn_back(o, x, attn["out"]["w"], attn["out"]["b"]),
                       out)
    assert torch.equal(out, tpb.ln_attn_residual_stages(ln, attn, x, heads, False, valid))
    if dtype == torch.bfloat16:
        chain = x + tlayers.linear(attn["out"], o)
        assert bf16_close(back, chain, x), bf16_error(back, chain, x)


def test_the_front_takes_eps_and_any_leading_shape():
    ln, attn = (_torch(t) for t in _params(11, 128))
    x = torch.from_numpy(_x(12, 3, 5, 128)).to(torch.bfloat16)
    for eps in (1e-5, 1e-6):
        want = tlayers.linear(attn["qkv"], tlayers.layer_norm(ln, x, eps=eps))
        assert torch.equal(tpb.ln_attn_front(ln, attn["qkv"], x, eps), want)
        assert torch.equal(tpb.ln_attn_front(ln, attn["qkv"], x[0], eps), want[0])


def _clip_block(seed, d, tree=_torch):
    ln, attn = _params(seed, d)
    rng = np.random.default_rng(seed + 1)

    def w(*shape):
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)

    block = {"ln_1": ln, "attn": attn,
             "ln_2": {"scale": 1.0 + w(d), "bias": w(d)},
             "mlp": {"c_fc": {"w": w(d, 4 * d), "b": w(4 * d)},
                     "c_proj": {"w": w(4 * d, d), "b": w(d)}}}
    return block if tree is None else tree(block)


def _counted():
    from aa_clip_iqm_tpu_torch.utils import profiling

    c = profiling.counters()
    return c.get("attn.proj_fused", 0), c.get("attn.proj_chain", 0)


class _Spies:
    """Counts the calls of B8's halves that ``models.clip`` makes."""

    def __init__(self, monkeypatch):
        from aa_clip_iqm_tpu_torch.models import clip as tclip

        self.calls = {"front": 0, "back": 0}
        for key, name in (("front", "ln_attn_front"), ("back", "ln_attn_back")):
            monkeypatch.setattr(tclip, name, self._spy(key, getattr(tclip, name)))

    def _spy(self, key, real):
        def spy(*a, **k):
            self.calls[key] += 1
            return real(*a, **k)
        return spy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("valid", [None, 100])
def test_run_block_takes_the_halves_where_nothing_is_recorded(valid, dtype, monkeypatch):
    """Under ``no_grad`` an unmasked bf16 block runs B8's front, the routed
    attention and B8's back, counted ``attn.proj_fused``: held to the chain
    (the same block with x recorded by autograd) in bf16 ulps and to JAX's
    block at the file's tolerance. The block's float32 or bf16 biases give
    the same output (the kernels read them in float32)."""
    from aa_clip_iqm_tpu.models import clip as jclip
    from aa_clip_iqm_tpu.ops.layers import gelu as jgelu
    from aa_clip_iqm_tpu_torch.models import clip as tclip
    from aa_clip_iqm_tpu_torch.ops.layers import gelu as tgelu

    d, heads = 128, 2
    raw = _clip_block(21, d, tree=None)
    block = _tree(raw, lambda a: torch.from_numpy(a).to(dtype))
    x = torch.from_numpy(_x(22, 2, 300, d)).to(torch.bfloat16)
    spies = _Spies(monkeypatch)
    before = _counted()
    with torch.no_grad():
        out = tclip._run_block(block, x, heads, tgelu, valid_len=valid)
    assert _counted() == (before[0] + 1, before[1])
    assert spies.calls == {"front": 1, "back": 1}
    chain = tclip._run_block(block, x.clone().requires_grad_(True), heads, tgelu,
                             valid_len=valid).detach()
    assert _counted() == (before[0] + 1, before[1] + 1)
    assert spies.calls["front"] == 1
    n = 300 if valid is None else valid
    out_n, chain_n, x_n = out[:, :n], chain[:, :n], x[:, :n]
    assert bf16_close(out_n, chain_n, x_n), bf16_error(out_n, chain_n, x_n)
    ref = jclip._run_block(_jax(_tree(raw, lambda a: np.asarray(
        torch.from_numpy(a).to(dtype).float()))), jnp.asarray(x.float().numpy(), jnp.bfloat16),
        heads, jgelu, use_pallas=True, valid_len=valid)
    np.testing.assert_allclose(out_n.float().numpy(), np.asarray(ref, np.float32)[:, :n],
                               rtol=TOL, atol=TOL)


def test_run_block_halves_around_split_head_attention(monkeypatch):
    """Past the packed kernel's token limit (lowered here to 256) the halves
    wrap the split-head attention (B7 on the card)."""
    from aa_clip_iqm_tpu_torch.models import clip as tclip
    from aa_clip_iqm_tpu_torch.ops import attention as tattn
    from aa_clip_iqm_tpu_torch.ops import flash_attention as tfa
    from aa_clip_iqm_tpu_torch.ops.layers import gelu as tgelu

    monkeypatch.setattr(tfa, "ROW_KERNEL_MAX_TOKENS", 256)
    split = []
    real = tattn.flash_mha
    monkeypatch.setattr(tattn, "flash_mha", lambda *a, **k: split.append(1) or real(*a, **k))
    block = _clip_block(23, 128)
    x = torch.from_numpy(_x(24, 1, 300, 128)).to(torch.bfloat16)
    spies = _Spies(monkeypatch)
    with torch.no_grad():
        out = tclip._run_block(block, x, 2, tgelu)
    assert spies.calls == {"front": 1, "back": 1} and split == [1]
    chain = tclip._run_block(block, x.clone().requires_grad_(True), 2, tgelu).detach()
    assert split == [1, 1]
    assert bf16_close(out, chain, x), bf16_error(out, chain, x)


def _int8_attention(block):
    from aa_clip_iqm_tpu_torch.ops import quant

    attn = dict(block["attn"])
    attn["qkv"] = quant.quantize_linear_params(attn["qkv"])
    attn["out"] = quant.quantize_linear_params(attn["out"])
    return {**block, "attn": attn}


# (case, (attn.proj_fused, attn.proj_chain) counted, the calls made)
ROUTE_CASES = [
    ("no_grad", (1, 0), {"front": 1, "back": 1}),
    ("grad enabled, nothing needs one", (1, 0), {"front": 1, "back": 1}),
    ("x needs a gradient", (0, 1), {"front": 0, "back": 0}),
    ("a weight needs a gradient", (0, 1), {"front": 0, "back": 0}),
    ("int8 attention", (0, 1), {"front": 0, "back": 0}),
    ("value-value", (0, 1), {"front": 0, "back": 0}),
    ("float32 x", (0, 1), {"front": 0, "back": 0}),
    ("masked (text tower)", (0, 0), {"front": 0, "back": 0}),
    ("use_pallas=False", (0, 0), {"front": 0, "back": 0}),
]


@pytest.mark.parametrize("case,counted,calls", ROUTE_CASES, ids=[c[0] for c in ROUTE_CASES])
def test_the_route_is_taken_only_where_it_may_be(case, counted, calls, monkeypatch):
    """The halves run where autograd records nothing, the block is
    unmasked, ``vv`` is off and ``ln_attn_halves_ok`` holds; each unmasked
    block on the chain counts
    ``attn.proj_chain``, a masked one (the text tower) and the stock route
    count neither."""
    from aa_clip_iqm_tpu_torch.models import clip as tclip
    from aa_clip_iqm_tpu_torch.ops import attention as tattn
    from aa_clip_iqm_tpu_torch.ops.layers import gelu as tgelu

    block = _clip_block(25, 128)
    x = torch.from_numpy(_x(26, 1, 128, 128)).to(torch.bfloat16)
    kw = {}
    if case == "x needs a gradient":
        x.requires_grad_(True)
    elif case == "a weight needs a gradient":
        block["attn"]["out"]["b"].requires_grad_(True)
    elif case == "int8 attention":
        block = _int8_attention(block)
    elif case == "value-value":
        kw["vv"] = True
    elif case == "float32 x":
        x = x.float()
    elif case == "masked (text tower)":
        kw["attn_mask"] = tattn.causal_mask(128)
    elif case == "use_pallas=False":
        kw["use_pallas"] = False
    spies = _Spies(monkeypatch)
    before = _counted()
    if case == "no_grad":
        with torch.no_grad():
            out = tclip._run_block(block, x, 2, tgelu, **kw)
    else:
        out = tclip._run_block(block, x, 2, tgelu, **kw)
    after = _counted()
    assert (after[0] - before[0], after[1] - before[1]) == counted
    assert spies.calls == calls
    assert out.shape == x.shape and out.dtype == x.dtype


HALVES_GATE_CASES = [
    ("bf16 (B, L, d), float weights", (2, 16, 128), None, True),
    ("float32 x", (2, 16, 128), "float32", False),
    ("2-D x", (16, 128), None, False),
    ("width not a multiple of 128", (2, 16, 192), None, False),
    ("int8 qkv", (2, 16, 128), "int8", False),
    ("qkv not three times the width", (2, 16, 128), "narrow qkv", False),
    ("out not square", (2, 16, 128), "wide out", False),
]


@pytest.mark.parametrize("case,shape,change,want", HALVES_GATE_CASES,
                         ids=[c[0] for c in HALVES_GATE_CASES])
def test_the_halves_gate(case, shape, change, want):
    """``ln_attn_halves_ok``: what B8's front and back can take, with no
    term on the heads; ``ln_attn_residual_ok`` is that gate and B8's
    attention panels."""
    from aa_clip_iqm_tpu_torch.ops import quant

    d = shape[-1]
    _, attn = (_torch(t) for t in _params(29, d))
    x = torch.zeros(shape, dtype=torch.float32 if change == "float32" else torch.bfloat16)
    if change == "int8":
        attn["qkv"] = quant.quantize_linear_params(attn["qkv"])
    elif change == "narrow qkv":
        attn["qkv"]["w"] = attn["qkv"]["w"][:, :2 * d]
    elif change == "wide out":
        attn["out"]["w"] = torch.zeros((d, 2 * d))
    assert tpb.ln_attn_halves_ok(x, attn) == want
    if not want:
        assert not tpb.ln_attn_residual_ok(x, attn, 2)


def test_the_halves_take_heads_that_b8_s_attention_cannot(monkeypatch):
    """Heads of 96 fail ``ln_attn_residual_ok`` (B8's attention stage holds
    whole heads in 128-column panels) and pass ``ln_attn_halves_ok``: the
    halves run around the routed attention, counted ``attn.proj_fused``,
    and agree with the chain in bf16 ulps."""
    from aa_clip_iqm_tpu_torch.models import clip as tclip
    from aa_clip_iqm_tpu_torch.ops.layers import gelu as tgelu

    d, heads = 384, 4
    block = _clip_block(27, d)
    x = torch.from_numpy(_x(28, 1, 130, d)).to(torch.bfloat16)
    assert tpb.ln_attn_halves_ok(x, block["attn"])
    assert not tpb.ln_attn_residual_ok(x, block["attn"], heads)
    spies = _Spies(monkeypatch)
    before = _counted()
    with torch.no_grad():
        out = tclip._run_block(block, x, heads, tgelu)
    assert _counted() == (before[0] + 1, before[1])
    assert spies.calls == {"front": 1, "back": 1}
    chain = tclip._run_block(block, x.clone().requires_grad_(True), heads, tgelu).detach()
    assert _counted() == (before[0] + 1, before[1] + 1)
    assert spies.calls == {"front": 1, "back": 1}
    assert bf16_close(out, chain, x), bf16_error(out, chain, x)


def test_the_fused_share_reads_the_counters(monkeypatch):
    """``benchmark/metrics/attn.proj_fused_share.py``: the fused share of the
    counted blocks, in percent; nothing without the counters or off the
    card."""
    from benchmark.harness import load_module
    from benchmark.trace import Trace
    from aa_clip_iqm_tpu_torch.utils import profiling

    read = load_module("metrics", "attn.proj_fused_share").read
    ctx = type("Ctx", (), {"trace": Trace([("k", 0.0, 10.0)], [], (0.0, 100.0))})()
    monkeypatch.setattr(profiling, "counters", lambda: {"attn.proj_fused": 48})
    assert read(ctx) == 100.0
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"attn.proj_fused": 36, "attn.proj_chain": 12})
    assert read(ctx) == 75.0
    monkeypatch.setattr(profiling, "counters", lambda: {"predict.calls": 3})
    assert read(ctx) is None
    ctx.trace = Trace([], [], (0.0, 1.0))                 # a CPU rehearsal: nothing
    assert read(ctx) is None
