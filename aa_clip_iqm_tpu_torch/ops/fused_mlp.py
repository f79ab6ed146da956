"""Fused LayerNorm -> MLP -> residual: the Hopper kernels and their plain twins.

Counterpart of ``ln_mlp_residual``, ``ln_mlp_residual_int8`` and
``ln_mlp_residual_frozen`` in ``aa_clip_iqm_tpu/ops/pallas_mlp.py`` (kernels
``_kernel``, ``_int8_kernel`` and ``_bwd_dx_kernel``). The kernels live in
``csrc/ln_mlp_residual.cu``, ``csrc/ln_mlp_residual_int8.cu`` and
``csrc/ln_mlp_residual_dx.cu``; see their headers for the designs. On a CPU
tensor every function here runs its plain twin
(:func:`ln_mlp_residual_reference`, :func:`ln_mlp_residual_int8_reference`,
:func:`ln_mlp_residual_dx_reference`); on a CUDA tensor it launches its
kernel or raises. The two forwards go through the custom ops
``aaclip::ln_mlp_residual`` and ``aaclip::ln_mlp_residual_int8``
(``ops/custom_ops.py``; their CUDA implementations are :func:`_launch` and
:func:`_int8_launch`); the dx kernel is launched directly. GELU, and its
derivative, are exact erf in all of them.

In bf16 at both CLIP towers' widths the forward kernel runs three stages on
the wgmma GEMM core (``ops/gemm.py``): the LayerNorm pass, GEMM 1 into the
hidden layer and GEMM 2 with the residual; :func:`ln_mlp_residual_stages` is
their plain version, with the kernel's roundings. The dx kernel runs four:
the LayerNorm pass, the dual GEMM into dh, GEMM 3 into du * ln_g and a row
pass; :func:`ln_mlp_residual_dx_stages` is their plain version. The int8
kernel runs three on the core's int8 form: the row pass into x_q, GEMM 1
(whose tiles exchange the hidden chunks' maxima, then write h_q) and GEMM 2
with the chunk fold and the residual; :func:`ln_mlp_residual_int8_stages`
is their plain version, GEMM 1 in its two steps.

Gradients (each function is a ``torch.autograd.Function`` when its input
requires one):
  - :func:`ln_mlp_residual_frozen`: dx only, from the dx kernel; the
    LayerNorm and MLP parameters must be frozen (it raises otherwise);
  - :func:`ln_mlp_residual`: the backward recomputes the plain chain and
    differentiates it (x and every parameter), as the JAX function does;
  - :func:`ln_mlp_residual_int8`: the straight-through estimator on the
    dequantized plain chain (``_int8_bwd``, pallas_mlp.py:364).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, custom_ops
from .gemm import (
    DACTS,
    gemm_bias_act_reference,
    gemm_bias_residual_reference,
    gemm_dual_dact_reference,
    gemm_f32_reference,
    gemm_s8_amax_reference,
    gemm_s8_proj_reference,
    gemm_s8_quant_reference,
    ln_quant_rows_reference,
    quantize_rows,
)
from .layers import frozen_layout, gelu, layer_norm, mlp_block, quick_gelu
from .quant import int8_matmul

#: Float-kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0
#: int8-kernel launches since the last reset.
INT8_LAUNCHES = 0
#: dx-kernel (frozen backward) launches since the last reset.
DX_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {gelu: 0, quick_gelu: 1}
_ACT_NAMES = {gelu: "gelu", quick_gelu: "quick_gelu"}


def reset_launches() -> None:
    global LAUNCHES, INT8_LAUNCHES, DX_LAUNCHES, PROBE_LAUNCHES
    LAUNCHES = 0
    INT8_LAUNCHES = 0
    DX_LAUNCHES = 0
    PROBE_LAUNCHES = 0


def ln_mlp_residual_reference(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """Plain PyTorch twin: ``x + mlp_block(layer_norm(x))``, the JAX
    ``_xla_chain`` (pallas_mlp.py:239)."""
    return x + mlp_block(mlp_params, layer_norm(ln_params, x, eps=eps), act)


def ln_mlp_residual_stages(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """The plain version of the three stages the kernel runs in bf16, each
    rounded where it (and the TPU kernel, pallas_mlp.py:142-157) rounds:
    LN(x) once, the hidden layer once after the bias and the activation in
    fp32, and the output once after the residual, the bias and the whole
    fp32 sum over the hidden axis. In fp32 it equals
    :func:`ln_mlp_residual_reference` bit for bit; in bf16 that chain rounds
    the hidden layer before the activation and the MLP branch before the
    residual add."""
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    hid = gemm_bias_act_reference(layer_norm(ln_params, x, eps=eps), c_fc["w"], c_fc["b"], act)
    return gemm_bias_residual_reference(hid, c_proj["w"], c_proj["b"], x)


def _lib():
    lib = _build.load("ln_mlp_residual")
    fn = lib.aaclip_ln_mlp_residual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _operand(t, dtype, device, what, fn="ln_mlp_residual"):
    if t.device != device:
        raise ValueError(f"{fn}: {what} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {what} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous() or t.data_ptr() % 32:
        raise ValueError(f"{fn}: {what} must be contiguous and 32-byte aligned")
    return t.data_ptr()


def _forward(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """x + c_proj(act(c_fc(layer_norm(x)))) without autograd, through
    ``aaclip::ln_mlp_residual``: the twin on the CPU, the kernel on the card.

    x: (..., d), bf16 or fp32, contiguous. The matmul weights must share x's
    dtype and layout (in, out); LayerNorm scale/bias and the biases are fp32.
    """
    custom_ops.check_device("ln_mlp_residual", x)
    name = _ACT_NAMES.get(act)
    if name is None:
        if x.device.type == "cpu":      # any activation has a plain version
            return ln_mlp_residual_reference(ln_params, mlp_params, x, act, eps)
        raise ValueError(f"ln_mlp_residual: unsupported activation {act!r}")
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    return custom_ops.ln_mlp_residual(x, ln_params["scale"], ln_params["bias"], c_fc["w"],
                                      c_fc["b"], c_proj["w"], c_proj["b"], name, float(eps))


def _launch(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """The kernel on a CUDA x (the CUDA implementation of the op)."""
    if x.device.type != "cuda":
        raise ValueError(f"ln_mlp_residual: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"ln_mlp_residual: dtype {x.dtype} not supported "
                        "(bfloat16 or float32)")
    if act not in _ACTS:
        raise ValueError(f"ln_mlp_residual: unsupported activation {act!r}")
    if not x.is_contiguous():
        raise ValueError("ln_mlp_residual: x must be contiguous")
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d = x.shape[-1]
    h = c_fc["w"].shape[-1]
    if tuple(c_fc["w"].shape) != (d, h) or tuple(c_proj["w"].shape) != (h, d):
        raise ValueError("ln_mlp_residual: weight shapes do not match x")
    m = x.numel() // d
    dev, f32 = x.device, torch.float32
    ptrs = [
        _operand(x, x.dtype, dev, "x"),
        _operand(ln_params["scale"], f32, dev, "ln scale"),
        _operand(ln_params["bias"], f32, dev, "ln bias"),
        _operand(c_fc["w"], x.dtype, dev, "c_fc weight"),
        _operand(c_fc["b"], f32, dev, "c_fc bias"),
        _operand(c_proj["w"], x.dtype, dev, "c_proj weight"),
        _operand(c_proj["b"], f32, dev, "c_proj bias"),
    ]
    # The GEMM path's scratch (the C entry takes that path for bf16 with d a
    # multiple of 128 and h of 256): LN(x) and the hidden layer (M, h), 90 MB
    # at ViT-L/518 batch 8.
    xin = hid = None
    if x.dtype == torch.bfloat16 and d % 128 == 0 and h % 256 == 0:
        xin = torch.empty((m, d), dtype=x.dtype, device=dev)
        hid = torch.empty((m, h), dtype=x.dtype, device=dev)
    y = torch.empty_like(x)
    err = _lib()(*ptrs, xin if xin is None else xin.data_ptr(),
                 hid if hid is None else hid.data_ptr(), y.data_ptr(), m, d, h, float(eps),
                 _ACTS[act], _DTYPES[x.dtype], _build.stream_ptr(dev))
    _build.check("ln_mlp_residual", err)
    global LAUNCHES
    LAUNCHES += 1
    return y


# --------------------------------------------------------------------------
# int8 weights, dynamic int8 activations
# --------------------------------------------------------------------------

def hidden_chunk(h: int) -> int:
    """Width of the hidden chunks that each get their own activation scale
    (``_chunk``, pallas_mlp.py:89): part of the numerics. 0 if none fits."""
    for ch in (1024, 512, 256, 128):
        if h % ch == 0:
            return ch
    return 0


def ln_mlp_residual_int8_ok(x, mlp_params, act) -> bool:
    """True when the fused int8 route takes this call site: the gate of
    pallas_mlp.py:121 without its backend test. bf16 x, a known activation,
    both matmuls quantized (``w_q``/``scale``/``b``), d a multiple of 128
    and a hidden width that chunks."""
    if act not in _ACTS or x.dtype != torch.bfloat16:
        return False
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    for p in (c_fc, c_proj):
        if "w_q" not in p or "scale" not in p or "b" not in p:
            return False
    d, h = x.shape[-1], c_fc["w_q"].shape[-1]
    return d % 128 == 0 and hidden_chunk(h) != 0


def ln_mlp_residual_int8_reference(ln_params, mlp_params, x, act,
                                   eps: float = 1e-5, ch: int = 0):
    """Plain PyTorch twin of the int8 kernel, step by step as
    ``_int8_kernel`` (pallas_mlp.py:161): fp32 LayerNorm kept in fp32, one
    activation scale per row before c_fc and one per (row, hidden chunk)
    before c_proj, exact int32 products, the weight scales folded into the
    fp32 epilogues, one cast at the end. ``ch``: the hidden chunk width,
    :func:`hidden_chunk` where 0."""
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d, h = x.shape[-1], c_fc["w_q"].shape[-1]
    ch = ch or hidden_chunk(h)
    x32 = x.reshape(-1, d).float()
    x_q, sx = quantize_rows(layer_norm(ln_params, x32, eps=eps))
    s_fc, s_proj = c_fc["scale"].reshape(h).float(), c_proj["scale"].reshape(d).float()
    b_fc = c_fc["b"].float()
    acc = torch.zeros_like(x32)
    for j in range(0, h, ch):
        hid = int8_matmul(x_q, c_fc["w_q"][:, j:j + ch].contiguous()).float()
        hid = act(hid * (sx * s_fc[j:j + ch]) + b_fc[j:j + ch])
        h_q, sh = quantize_rows(hid)
        acc = acc + int8_matmul(h_q, c_proj["w_q"][j:j + ch]).float() * sh
    y = x32 + acc * s_proj + c_proj["b"].float()
    return y.to(x.dtype).reshape(x.shape)


def ln_mlp_residual_int8_stages(ln_params, mlp_params, x, act, eps: float = 1e-5,
                                ch: int = 0, rows=None):
    """The plain version of the stages the int8 kernel runs (``ops/gemm.py``'s
    int8 modes): the row pass (x_q, sx), GEMM 1's chunk maxima (amax, (M, h /
    ch)) and its h_q and sh, and GEMM 2 (y, x's shape). Returns them in a
    dict under those names. It rounds where
    :func:`ln_mlp_residual_int8_reference` rounds, so its y equals the
    twin's bit for bit. ``ch`` as there. ``rows``: a row pass (x_q, sx) to
    run the GEMMs on in place of the plain one (a kernel's own, to hold its
    GEMMs apart from its LayerNorm's sum order)."""
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d, h = x.shape[-1], c_fc["w_q"].shape[-1]
    ch = ch or hidden_chunk(h)
    x2 = x.reshape(-1, d)
    x_q, sx = rows if rows is not None else ln_quant_rows_reference(ln_params, x2, eps)
    fc = (c_fc["w_q"], sx, c_fc["scale"], c_fc["b"], act)
    amax = gemm_s8_amax_reference(x_q, *fc, ch)
    h_q, sh = gemm_s8_quant_reference(x_q, *fc, amax, ch)
    y = gemm_s8_proj_reference(h_q, c_proj["w_q"], sh, c_proj["scale"], c_proj["b"], x2, ch)
    return {"x_q": x_q, "sx": sx, "amax": amax, "h_q": h_q, "sh": sh, "y": y.reshape(x.shape)}


def _transposed(w_q):
    """The weight as the kernel reads it: transposed, (out, in), k
    contiguous; laid out once per weight tensor (``layers.frozen_layout``)."""
    return frozen_layout(_t_contiguous, w_q)


def _t_contiguous(w):
    return w.t().contiguous()


def _int8_lib():
    lib = _build.load("ln_mlp_residual_int8")
    fn = lib.aaclip_ln_mlp_residual_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _int8_forward(ln_params, mlp_params, x, act, eps: float = 1e-5, stages: bool = False):
    """The int8 forward without autograd, through
    ``aaclip::ln_mlp_residual_int8``: the twin on the CPU, the kernel's
    stages on the card. With ``stages`` it returns the dict of
    :func:`ln_mlp_residual_int8_stages` (on the card, the kernel's own
    scratch: x_q, sx, amax, h_q, sh) instead of y, from one direct launch.

    x: (..., d) bf16, contiguous, d a multiple of 128. ``w_q`` is int8 (in,
    out), ``scale`` fp32 with ``out`` elements, LayerNorm parameters and
    biases fp32.
    """
    fn = "ln_mlp_residual_int8"
    custom_ops.check_device(fn, x)
    name = _ACT_NAMES.get(act)
    if x.device.type == "cpu" and (stages or name is None):
        if stages:
            return ln_mlp_residual_int8_stages(ln_params, mlp_params, x, act, eps)
        return ln_mlp_residual_int8_reference(ln_params, mlp_params, x, act, eps)
    if stages:
        return _int8_launch(ln_params, mlp_params, x, act, eps, stages=True)
    if name is None:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    return custom_ops.ln_mlp_residual_int8(
        x, ln_params["scale"], ln_params["bias"], c_fc["w_q"], c_fc["scale"], c_fc["b"],
        c_proj["w_q"], c_proj["scale"], c_proj["b"], name, float(eps))


def _int8_launch(ln_params, mlp_params, x, act, eps: float = 1e-5, stages: bool = False):
    """The kernel's stages on a CUDA x (the CUDA implementation of the op)."""
    fn = "ln_mlp_residual_int8"
    if act not in _ACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    h = mlp_params["c_fc"]["w_q"].shape[-1]
    ch = hidden_chunk(h)
    if not ch:
        raise ValueError(f"{fn}: d={x.shape[-1]}, h={h} not supported (d and h multiples of 128)")
    out = _int8_chain(fn, _int8_lib(), ln_params, mlp_params, x, ch, float(eps), _ACTS[act])
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return out if stages else out["y"]


def _int8_chain(fn, entry, ln_params, mlp_params, x, ch, *args):
    """Check the operands of an int8 chain's C ``entry`` (B3's or B9's),
    allocate its scratch and launch it with the trailing ``args`` (eps and
    the variant). Returns the dict of the stages' x_q, sx, amax, h_q, sh
    and y."""
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: dtype {x.dtype} not supported (bfloat16)")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d = x.shape[-1]
    h = c_fc["w_q"].shape[-1]
    if tuple(c_fc["w_q"].shape) != (d, h) or tuple(c_proj["w_q"].shape) != (h, d):
        raise ValueError(f"{fn}: weight shapes do not match x")
    if c_fc["scale"].numel() != h or c_proj["scale"].numel() != d:
        raise ValueError(f"{fn}: scale shapes do not match the weights")
    if d % 128 or h % ch:
        raise ValueError(f"{fn}: d={d}, h={h}, ch={ch} not supported (d a multiple of 128, "
                         "h of ch)")
    m = x.numel() // d
    dev, f32, i8 = x.device, torch.float32, torch.int8
    # Checked as given, before the transposed copies are made.
    _operand(c_fc["w_q"], i8, dev, "c_fc w_q", fn)
    _operand(c_proj["w_q"], i8, dev, "c_proj w_q", fn)
    ptrs = [
        _operand(x, torch.bfloat16, dev, "x", fn),
        _operand(ln_params["scale"], f32, dev, "ln scale", fn),
        _operand(ln_params["bias"], f32, dev, "ln bias", fn),
        _transposed(c_fc["w_q"]).data_ptr(),
        _operand(c_fc["scale"], f32, dev, "c_fc scale", fn),
        _operand(c_fc["b"], f32, dev, "c_fc bias", fn),
        _transposed(c_proj["w_q"]).data_ptr(),
        _operand(c_proj["scale"], f32, dev, "c_proj scale", fn),
        _operand(c_proj["b"], f32, dev, "c_proj bias", fn),
    ]
    # The stages' scratch: 56 MB at ViT-L/518 batch 8, most of it h_q; and
    # GEMM 1's counters of the warps done with each (192-row block, chunk).
    scratch = {"x_q": torch.empty((m, d), dtype=i8, device=dev),
               "sx": torch.empty(m, dtype=f32, device=dev),
               "amax": torch.empty((m, h // ch), dtype=f32, device=dev),
               "sh": torch.empty((m, h // ch), dtype=f32, device=dev),
               "count": torch.empty((-(-m // 192), h // ch), dtype=torch.int32, device=dev),
               "h_q": torch.empty((m, h), dtype=i8, device=dev)}
    y = torch.empty_like(x)
    err = entry(*ptrs, *(scratch[k].data_ptr()
                         for k in ("x_q", "sx", "amax", "sh", "count", "h_q")),
                y.data_ptr(), m, d, h, ch, *args, _build.stream_ptr(dev))
    del scratch["count"]
    _build.check("ln_mlp_residual_int8", err)
    return dict(scratch, y=y)


def ln_mlp_residual_int8_with_stages(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """One call of the int8 forward (the kernel on the card) that also
    returns its intermediates: the dict of :func:`ln_mlp_residual_int8_stages`,
    on the card the kernel's own x_q, sx, amax, h_q and sh. No autograd."""
    return _int8_forward(ln_params, mlp_params, x, act, eps, stages=True)


# --------------------------------------------------------------------------
# B9: the int8 probe's variants of the int8 kernel
# --------------------------------------------------------------------------

#: int8 probe kernel (B9) launches since the last reset.
PROBE_LAUNCHES = 0
#: The probe's hidden chunk widths.
PROBE_CHUNKS = (1024, 2048)
_SQRT_HALF = 0.7071067811865476
# Abramowitz-Stegun 7.1.26: p, then a1 .. a5.
_AS_ERF = (0.3275911, 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def erf_as(ax):
    """The magnitude of erf at ``ax`` = |x| on Abramowitz-Stegun 7.1.26,
    ``1 - poly(k) exp(-ax^2)`` with k = 1 / (1 + p ax). Evaluated in ax's
    dtype one operation at a time, every constant rounded to ax's dtype
    first, as JAX evaluates it on an array of that dtype (its scalars are
    weak-typed)."""
    def c(v):
        return torch.tensor(v, dtype=ax.dtype)

    p, a1, a2, a3, a4, a5 = _AS_ERF
    k = c(1.0) / (c(1.0) + c(p) * ax)
    poly = k * (c(a1) + k * (c(a2) + k * (c(a3) + k * (c(a4) + k * c(a5)))))
    return c(1.0) - poly * torch.exp(-ax * ax)


def erf_nocmp(x):
    """erf with the sign taken compare-free as ``x / (|x| + 1e-3)``
    (``_erf_nocmp``, tools/probe_mlp_int8_sweep.py:38) times
    :func:`erf_as`: that factor is not +-1 near 0, and it is part of the
    numerics. In x's dtype, as :func:`erf_as`."""
    ax = x.abs()
    return (x / (ax + torch.tensor(1e-3, dtype=x.dtype))) * erf_as(ax)


def gelu_nocmp(x):
    """``0.5 x (1 + erf_nocmp(x / sqrt 2))`` in x's dtype (``_gelu_nocmp``)."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype)

    return c(0.5) * x * (c(1.0) + erf_nocmp(x * c(_SQRT_HALF)))


def probe_activation(ep_bf16: bool):
    """The activation of the probe's GEMM 1 epilogue on the fp32
    pre-activation u: :func:`gelu_nocmp` on u, or with ``ep_bf16`` on u
    rounded to bf16, every operation then rounding to bf16, and the result
    widened to fp32 again."""
    if not ep_bf16:
        return gelu_nocmp
    return lambda u: gelu_nocmp(u.to(torch.bfloat16)).float()


def ln_mlp_residual_int8_probe_reference(ln_params, mlp_params, x, ep_bf16: bool, ch: int):
    """Plain PyTorch version of B9, ``_kernel_var`` (probe_mlp_int8_sweep.py
    :53): :func:`ln_mlp_residual_int8_reference` with the compare-free GELU
    (:func:`probe_activation`), the hidden chunk ``ch`` and the LayerNorm's
    eps fixed at 1e-5."""
    return ln_mlp_residual_int8_reference(ln_params, mlp_params, x,
                                          probe_activation(ep_bf16), 1e-5, ch)


def ln_mlp_residual_int8_probe_stages(ln_params, mlp_params, x, ep_bf16: bool, ch: int,
                                      rows=None):
    """The plain version of B9's stages: :func:`ln_mlp_residual_int8_stages`
    with the probe's activation and chunk (``rows`` as there). Its y equals
    :func:`ln_mlp_residual_int8_probe_reference`'s bit for bit."""
    return ln_mlp_residual_int8_stages(ln_params, mlp_params, x, probe_activation(ep_bf16),
                                       1e-5, ch, rows)


def _probe_lib():
    lib = _build.load("ln_mlp_residual_int8")
    fn = lib.aaclip_ln_mlp_residual_int8_probe
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 16 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ln_mlp_residual_int8_probe(ln_params, mlp_params, x, ep_bf16: bool, ch: int,
                               stages: bool = False):
    """B9, one layer of the int8 probe's chain: ``x + c_proj(gelu_nocmp(
    c_fc(layer_norm(x))))`` on int8 weights and dynamic int8 activations,
    one activation scale per row and one per (row, ``ch``-wide hidden
    chunk), the GELU's epilogue in fp32 or, with ``ep_bf16``, on bf16
    values. The kernel on a CUDA x, :func:`ln_mlp_residual_int8_probe_reference`
    on a CPU one; with ``stages`` the dict of
    :func:`ln_mlp_residual_int8_probe_stages` (on the card, the kernel's own
    scratch). No autograd.

    x: (..., d) bf16, contiguous, d a multiple of 128; ``ch`` 1024 or 2048,
    dividing h. Weights as for :func:`ln_mlp_residual_int8`.
    """
    fn = "ln_mlp_residual_int8_probe"
    if ch not in PROBE_CHUNKS:
        raise ValueError(f"{fn}: ch={ch} not supported {PROBE_CHUNKS}")
    custom_ops.check_device(fn, x)
    if x.device.type == "cpu":
        if stages:
            return ln_mlp_residual_int8_probe_stages(ln_params, mlp_params, x, ep_bf16, ch)
        return ln_mlp_residual_int8_probe_reference(ln_params, mlp_params, x, ep_bf16, ch)
    out = _int8_chain(fn, _probe_lib(), ln_params, mlp_params, x, ch, 1e-5, int(bool(ep_bf16)))
    global PROBE_LAUNCHES
    PROBE_LAUNCHES += 1
    return out if stages else out["y"]


# --------------------------------------------------------------------------
# Gradients
# --------------------------------------------------------------------------

def ln_mlp_residual_dx_reference(ln_params, mlp_params, x, g, act,
                                 eps: float = 1e-5):
    """Plain PyTorch dx of y = x + c_proj(act(c_fc(ln(x)))) for frozen
    LayerNorm / MLP parameters, step by step as ``_bwd_dx_kernel``
    (pallas_mlp.py:200) with the exact-erf derivative of GELU: the hidden
    chunk recomputed, da = g W_proj^T, dh = da * act'(hid) rounded to x's
    dtype, du += dh W_fc^T in float32, the closed-form LayerNorm backward per
    row, plus g."""
    dact = DACTS[act]
    dt = x.dtype
    d = x.shape[-1]
    w_fc = mlp_params["c_fc"]["w"].to(dt).float()
    w_proj = mlp_params["c_proj"]["w"].to(dt).float()
    b_fc = mlp_params["c_fc"]["b"].float()
    h = w_fc.shape[-1]
    ch = hidden_chunk(h) or h
    scale, bias = ln_params["scale"].float(), ln_params["bias"].float()
    x32 = x.reshape(-1, d).float()
    g32 = g.reshape(-1, d).to(dt).float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xn = (x32 - mu) * rstd
    xin = (xn * scale + bias).to(dt).float()
    du = torch.zeros_like(x32)
    for j in range(0, h, ch):
        hid = xin @ w_fc[:, j:j + ch] + b_fc[j:j + ch]
        da = g32 @ w_proj[j:j + ch].t()
        dh = (da * dact(hid)).to(dt).float()
        du = du + dh @ w_fc[:, j:j + ch].t()
    dxh = du * scale
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xn).mean(dim=-1, keepdim=True)
    dx = (dxh - m1 - xn * m2) * rstd
    return (dx + g32).to(dt).reshape(x.shape)


def ln_dx_rows_reference(x, t, g, eps: float = 1e-5):
    """The dx kernel's row pass: mean and rstd of x in fp32, then
    ``(t - mean(t) - xn * mean(t * xn)) * rstd + g`` rounded once to x's
    dtype, t = du * ln_g in fp32. x, g (M, d), t (M, d) fp32."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((x32 - mu).square().mean(dim=-1, keepdim=True) + eps)
    xn = (x32 - mu) * rstd
    m1 = t.mean(dim=-1, keepdim=True)
    m2 = (t * xn).mean(dim=-1, keepdim=True)
    return ((t - m1 - xn * m2) * rstd + g.float()).to(x.dtype)


def ln_mlp_residual_dx_stages(ln_params, mlp_params, x, g, act, eps: float = 1e-5):
    """The plain version of the four stages the dx kernel runs in bf16, each
    rounded where it rounds: LN(x) once; the dual GEMM's dh = (g W_proj^T)
    * act'(xin W_fc + b_fc) once after both fp32 products; GEMM 3's
    du = dh W_fc^T over the whole hidden axis in fp32, times ln_g, never
    rounded; the row pass once. It rounds where
    :func:`ln_mlp_residual_dx_reference` rounds, which sums du in chunks."""
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    dt, d = x.dtype, x.shape[-1]
    x2, g2 = x.reshape(-1, d), g.reshape(-1, d).to(dt)
    xin = layer_norm(ln_params, x2, eps=eps)
    dh = gemm_dual_dact_reference(xin, c_fc["w"], c_fc["b"], g2, c_proj["w"], act)
    t = gemm_f32_reference(dh, c_fc["w"], ln_params["scale"], w_kmajor=True)
    return ln_dx_rows_reference(x2, t, g2, eps).reshape(x.shape)


def _dx_lib():
    lib = _build.load("ln_mlp_residual_dx")
    fn = lib.aaclip_ln_mlp_residual_dx
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 11 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ln_mlp_residual_dx(ln_params, mlp_params, x, g, act, eps: float = 1e-5):
    """dx (same shape as x) of the fused chain for frozen parameters: the
    plain version on CPU tensors, the kernel on CUDA tensors (in bf16 at
    widths that are multiples of 128 its four stages on the GEMM core)."""
    fn = "ln_mlp_residual_dx"
    if x.device.type == "cpu":
        return ln_mlp_residual_dx_reference(ln_params, mlp_params, x, g, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {x.dtype} not supported (bfloat16 or float32)")
    if act not in _ACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    if not x.is_contiguous() or g.shape != x.shape:
        raise ValueError(f"{fn}: x must be contiguous and g of its shape")
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d = x.shape[-1]
    h = c_fc["w"].shape[-1]
    if tuple(c_fc["w"].shape) != (d, h) or tuple(c_proj["w"].shape) != (h, d):
        raise ValueError(f"{fn}: weight shapes do not match x")
    m = x.numel() // d
    dev, f32 = x.device, torch.float32
    ptrs = [
        _operand(x, x.dtype, dev, "x", fn),
        _operand(g, x.dtype, dev, "g", fn),
        _operand(ln_params["scale"], f32, dev, "ln scale", fn),
        _operand(ln_params["bias"], f32, dev, "ln bias", fn),
        _operand(c_fc["w"], x.dtype, dev, "c_fc weight", fn),
        _operand(c_fc["b"], f32, dev, "c_fc bias", fn),
        _operand(c_proj["w"], x.dtype, dev, "c_proj weight", fn),
    ]
    # The GEMM path's scratch (the C entry takes that path for bf16 with d
    # and h multiples of 128): LN(x) and dh in bf16, t = du * ln_g in fp32;
    # 315 MB at ViT-L/518 batch 8.
    scratch = [None, None, None]
    if x.dtype == torch.bfloat16 and d % 128 == 0 and h % 128 == 0:
        scratch = [torch.empty((m, d), dtype=x.dtype, device=dev),
                   torch.empty((m, h), dtype=x.dtype, device=dev),
                   torch.empty((m, d), dtype=f32, device=dev)]
    dx = torch.empty_like(x)
    err = _dx_lib()(*ptrs, *(t if t is None else t.data_ptr() for t in scratch), dx.data_ptr(),
                    m, d, h, float(eps), _ACTS[act], _DTYPES[x.dtype], _build.stream_ptr(dev))
    _build.check(fn, err)
    global DX_LAUNCHES
    DX_LAUNCHES += 1
    return dx


def _leaves(ln_params, mlp_params):
    """The float chain's parameter tensors, in a fixed order."""
    return (ln_params["scale"], ln_params["bias"], mlp_params["c_fc"]["w"],
            mlp_params["c_fc"]["b"], mlp_params["c_proj"]["w"],
            mlp_params["c_proj"]["b"])


def _trees(leaves):
    ls, lb, wf, bf, wp, bp = leaves
    return ({"scale": ls, "bias": lb},
            {"c_fc": {"w": wf, "b": bf}, "c_proj": {"w": wp, "b": bp}})


def _chain_grads(ctx, need, x, leaves, g):
    """Gradients of the plain chain at (x, *leaves) for the inputs flagged in
    ``need``: the chain is recomputed under grad mode and differentiated."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(n) for t, n in zip((x, *leaves), need)]
        y = ln_mlp_residual_reference(*_trees(ins[1:]), ins[0], ctx.act, ctx.eps)
        wanted = [t for t, n in zip(ins, need) if n]
        grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
    return [next(grads) if n else None for n in need]


class _LnMlpResidual(torch.autograd.Function):
    """Forward: the fused kernel (twin on the CPU). Backward: the plain chain
    recomputed and differentiated, for x and every parameter."""

    @staticmethod
    def forward(ctx, x, act, eps, *leaves):
        ctx.save_for_backward(x, *leaves)
        ctx.act, ctx.eps = act, eps
        return _forward(*_trees(leaves), x, act, eps)

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], *ctx.needs_input_grad[3:])
        dx, *dleaves = _chain_grads(ctx, need, x, leaves, g)
        return (dx, None, None, *dleaves)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ln_mlp_residual(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """x + c_proj(act(c_fc(layer_norm(x)))) in one kernel, differentiable in
    x and in every parameter (the backward recomputes the plain chain; no
    kernel there, as in the JAX package). For frozen parameters
    :func:`ln_mlp_residual_frozen` has the dx kernel.

    x: (..., d), bf16 or fp32, contiguous. The matmul weights must share x's
    dtype and layout (in, out); LayerNorm scale/bias and the biases are fp32.
    """
    leaves = _leaves(ln_params, mlp_params)
    if _needs_grad(x, *leaves):
        return _LnMlpResidual.apply(x, act, eps, *leaves)
    return _forward(ln_params, mlp_params, x, act, eps)


class _LnMlpResidualFrozen(torch.autograd.Function):
    """Forward: the fused kernel (twin on the CPU). Backward: dx alone, from
    the dx kernel (plain dx on the CPU)."""

    @staticmethod
    def forward(ctx, x, act, eps, *leaves):
        ctx.save_for_backward(x, *leaves)
        ctx.act, ctx.eps = act, eps
        return _forward(*_trees(leaves), x, act, eps)

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        dx = ln_mlp_residual_dx(*_trees(leaves), x, g.contiguous(), ctx.act, ctx.eps)
        return (dx, None, None, *([None] * len(leaves)))


def ln_mlp_residual_frozen(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """:func:`ln_mlp_residual` for frozen LayerNorm / MLP parameters: the
    backward is the dx-only kernel and no parameter gets a gradient. It
    raises if a parameter requires one (the JAX function returns zeros
    there without a word)."""
    leaves = _leaves(ln_params, mlp_params)
    if any(t.requires_grad for t in leaves):
        raise ValueError(
            "ln_mlp_residual_frozen: a LayerNorm / MLP parameter requires "
            "grad; this function differentiates x only, use ln_mlp_residual")
    if _needs_grad(x):
        return _LnMlpResidualFrozen.apply(x, act, eps, *leaves)
    return _forward(ln_params, mlp_params, x, act, eps)


class _LnMlpResidualInt8(torch.autograd.Function):
    """Forward: the fused int8 kernel (twin on the CPU). Backward: the
    straight-through estimator, the plain float chain on the dequantized
    weights recomputed and differentiated; ``w_q`` and ``scale`` get none."""

    @staticmethod
    def forward(ctx, x, act, eps, mlp_params, ls, lb, bf, bp):
        ctx.save_for_backward(x, ls, lb, bf, bp)
        ctx.act, ctx.eps, ctx.mlp = act, eps, mlp_params
        return _int8_forward({"scale": ls, "bias": lb}, mlp_params, x, act, eps)

    @staticmethod
    def backward(ctx, g):
        x, ls, lb, bf, bp = ctx.saved_tensors
        c_fc, c_proj = ctx.mlp["c_fc"], ctx.mlp["c_proj"]
        wf = (c_fc["w_q"].float() * c_fc["scale"].float()).to(x.dtype)
        wp = (c_proj["w_q"].float() * c_proj["scale"].float()).to(x.dtype)
        n = ctx.needs_input_grad
        need = (n[0], n[4], n[5], False, n[6], False, n[7])
        dx, dls, dlb, _, dbf, _, dbp = _chain_grads(
            ctx, need, x, (ls, lb, wf, bf, wp, bp), g)
        return (dx, None, None, None, dls, dlb, dbf, dbp)


def ln_mlp_residual_int8(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """:func:`ln_mlp_residual` with int8 MLP weights
    (``quant.quantize_linear_params`` dicts) in one kernel. Guard call sites
    with :func:`ln_mlp_residual_int8_ok`. Its gradient is the straight-
    through estimator on the dequantized plain chain: x, the LayerNorm
    parameters and the biases get real gradients, ``w_q`` and ``scale`` none.

    x: (..., d) bf16, contiguous, d a multiple of 128. ``w_q`` is int8 (in,
    out), ``scale`` fp32 with ``out`` elements, LayerNorm parameters and
    biases fp32.
    """
    floats = (ln_params["scale"], ln_params["bias"], mlp_params["c_fc"]["b"],
              mlp_params["c_proj"]["b"])
    if _needs_grad(x, *floats):
        return _LnMlpResidualInt8.apply(x, act, eps, mlp_params, *floats)
    return _int8_forward(ln_params, mlp_params, x, act, eps)
