"""Fused LayerNorm -> MLP -> residual: the Hopper kernels and their plain twins.

Counterpart of ``ln_mlp_residual`` and ``ln_mlp_residual_int8`` in
``aa_clip_iqm_tpu/ops/pallas_mlp.py`` (kernels ``_kernel`` and
``_int8_kernel``). The kernels live in ``csrc/ln_mlp_residual.cu`` and
``csrc/ln_mlp_residual_int8.cu``; see their headers for the designs. On a CPU
tensor :func:`ln_mlp_residual` and :func:`ln_mlp_residual_int8` run the plain
twins :func:`ln_mlp_residual_reference` and
:func:`ln_mlp_residual_int8_reference`; on a CUDA tensor they launch the
kernel or raise. GELU is exact erf in all of them.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from . import _build
from .layers import gelu, layer_norm, mlp_block, quick_gelu
from .quant import int8_matmul

#: Float-kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0
#: int8-kernel launches since the last reset.
INT8_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ACTS = {gelu: 0, quick_gelu: 1}


def reset_launches() -> None:
    global LAUNCHES, INT8_LAUNCHES
    LAUNCHES = 0
    INT8_LAUNCHES = 0


def ln_mlp_residual_reference(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """Plain PyTorch twin: ``x + mlp_block(layer_norm(x))``, the JAX
    ``_xla_chain`` (pallas_mlp.py:239)."""
    return x + mlp_block(mlp_params, layer_norm(ln_params, x, eps=eps), act)


def _lib():
    lib = _build.load("ln_mlp_residual")
    fn = lib.aaclip_ln_mlp_residual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [
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


def ln_mlp_residual(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """x + c_proj(act(c_fc(layer_norm(x)))) in one kernel.

    x: (..., d), bf16 or fp32, contiguous. The matmul weights must share x's
    dtype and layout (in, out); LayerNorm scale/bias and the biases are fp32.
    """
    if x.device.type == "cpu":
        return ln_mlp_residual_reference(ln_params, mlp_params, x, act, eps)
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
    y = torch.empty_like(x)
    err = _lib()(*ptrs, y.data_ptr(), m, d, h, float(eps), _ACTS[act],
                 _DTYPES[x.dtype], _build.stream_ptr(dev))
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


def _quantize_rows(t):
    """Dynamic per-row symmetric int8: (int8 values, fp32 scale (rows, 1))."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    return torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8), scale


def ln_mlp_residual_int8_reference(ln_params, mlp_params, x, act,
                                   eps: float = 1e-5):
    """Plain PyTorch twin of the int8 kernel, step by step as
    ``_int8_kernel`` (pallas_mlp.py:161): fp32 LayerNorm kept in fp32, one
    activation scale per row before c_fc and one per (row, hidden chunk)
    before c_proj, exact int32 products, the weight scales folded into the
    fp32 epilogues, one cast at the end."""
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d, h = x.shape[-1], c_fc["w_q"].shape[-1]
    ch = hidden_chunk(h)
    x32 = x.reshape(-1, d).float()
    x_q, sx = _quantize_rows(layer_norm(ln_params, x32, eps=eps))
    s_fc, s_proj = c_fc["scale"].reshape(h).float(), c_proj["scale"].reshape(d).float()
    b_fc = c_fc["b"].float()
    acc = torch.zeros_like(x32)
    for j in range(0, h, ch):
        hid = int8_matmul(x_q, c_fc["w_q"][:, j:j + ch].contiguous()).float()
        hid = act(hid * (sx * s_fc[j:j + ch]) + b_fc[j:j + ch])
        h_q, sh = _quantize_rows(hid)
        acc = acc + int8_matmul(h_q, c_proj["w_q"][j:j + ch]).float() * sh
    y = x32 + acc * s_proj + c_proj["b"].float()
    return y.to(x.dtype).reshape(x.shape)


# Weights as the kernel reads them: transposed, k contiguous. Laid out once
# per weight tensor (the backbone is frozen, so a weight is never updated in
# place) and dropped with it.
_TRANSPOSED = {}


def _transposed(w_q):
    key = id(w_q)
    hit = _TRANSPOSED.get(key)
    if hit is not None and hit[0]() is w_q:
        return hit[1]
    w_t = w_q.t().contiguous()
    _TRANSPOSED[key] = (weakref.ref(w_q, lambda _: _TRANSPOSED.pop(key, None)), w_t)
    return w_t


def _int8_lib():
    lib = _build.load("ln_mlp_residual_int8")
    fn = lib.aaclip_ln_mlp_residual_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ln_mlp_residual_int8(ln_params, mlp_params, x, act, eps: float = 1e-5):
    """:func:`ln_mlp_residual` with int8 MLP weights
    (``quant.quantize_linear_params`` dicts) in one kernel. Guard call sites
    with :func:`ln_mlp_residual_int8_ok`.

    x: (..., d) bf16, contiguous, d a multiple of 128 up to 1024. ``w_q`` is
    int8 (in, out), ``scale`` fp32 with ``out`` elements, LayerNorm
    parameters and biases fp32.
    """
    fn = "ln_mlp_residual_int8"
    if x.device.type == "cpu":
        return ln_mlp_residual_int8_reference(ln_params, mlp_params, x, act, eps)
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: dtype {x.dtype} not supported (bfloat16)")
    if act not in _ACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    if not x.is_contiguous():
        raise ValueError(f"{fn}: x must be contiguous")
    c_fc, c_proj = mlp_params["c_fc"], mlp_params["c_proj"]
    d = x.shape[-1]
    h = c_fc["w_q"].shape[-1]
    ch = hidden_chunk(h)
    if tuple(c_fc["w_q"].shape) != (d, h) or tuple(c_proj["w_q"].shape) != (h, d):
        raise ValueError(f"{fn}: weight shapes do not match x")
    if c_fc["scale"].numel() != h or c_proj["scale"].numel() != d:
        raise ValueError(f"{fn}: scale shapes do not match the weights")
    if d % 128 or d > 1024 or not ch:
        raise ValueError(f"{fn}: d={d}, h={h} not supported (d a multiple of "
                         "128 up to 1024, h a multiple of 128)")
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
    y = torch.empty_like(x)
    err = _int8_lib()(*ptrs, y.data_ptr(), m, d, h, ch, float(eps), _ACTS[act],
                      _build.stream_ptr(dev))
    _build.check("ln_mlp_residual_int8", err)
    global INT8_LAUNCHES
    INT8_LAUNCHES += 1
    return y
