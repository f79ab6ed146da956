"""The Hopper GEMM core of B2, B5 and B8, and the plain versions of its stages.

B2 (``csrc/ln_mlp_residual.cu``), B5 (``csrc/ln_mlp_residual_dx.cu``) and B8
(``csrc/ln_attn_residual.cu``) run their products on one hand-written wgmma
GEMM core, ``csrc/gemm_sm90.cuh`` (see its header for the design), after a
row-wise LayerNorm pass. Each stage has a plain version with the kernel's
roundings:

- the LayerNorm pass is :func:`.layers.layer_norm` (fp32 statistics, one
  rounding to x's dtype);
- epilogue (a), :func:`gemm_bias_act_reference`: ``act(a @ w + b)`` in fp32,
  one rounding;
- epilogue (b), :func:`gemm_bias_residual_reference`: ``res + (a @ w + b)``
  in fp32, one rounding;
- the dual mode (c), :func:`gemm_dual_dact_reference`: ``(a2 @ w2t.T) *
  act'(a @ w + b)`` with both products in fp32, one rounding; ``w2t`` is a
  weight stored (out, in) and read K-major;
- epilogue (d), :func:`gemm_f32_reference`: ``(a @ w) * scale`` kept in fp32,
  with ``w`` stored (in, out) or, K-major, (out, in).

The product is computed as :func:`.layers.linear` computes it before its
rounding, so that without an activation stage (a) equals ``linear`` bit for
bit. :func:`gemm_bias_act`, :func:`gemm_bias_residual`, :func:`gemm_f32` and
:func:`gemm_dual_dact` launch one product of the core alone on CUDA tensors
(the plain version on CPU tensors): the card tests and ``chip_smoke.py`` use
them; the model reaches the core only through B2, B5 and B8.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layers import gelu, quick_gelu

#: Launches of the core alone since the last reset (B2 and B8 count their own).
LAUNCHES = 0

_ACTS = {gelu: 0, quick_gelu: 1, None: 2}

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def dgelu(x):
    """d/dx of the exact GELU: Phi(x) + x phi(x)."""
    return (0.5 * (1.0 + torch.erf(x * _SQRT_HALF))
            + x * _INV_SQRT_2PI * torch.exp(-0.5 * x * x))


def dquick_gelu(x):
    s = torch.sigmoid(1.702 * x)
    return s + x * 1.702 * s * (1.0 - s)


#: Each activation's exact derivative, as epilogue (c) takes it.
DACTS = {gelu: dgelu, quick_gelu: dquick_gelu}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def _acc_bias(a, w, b):
    """fp32 ``a @ w + b`` over the rows of ``a``, as ``linear`` takes it."""
    a2 = a.reshape(-1, a.shape[-1])
    w = w.to(a.dtype)
    if a.is_cuda and a.dtype != torch.float32:
        return torch.addmm(b.float(), a2, w, out_dtype=torch.float32)
    return torch.addmm(b.float(), a2.float(), w.float())


def gemm_bias_act_reference(a, w, b, act=None):
    """Epilogue (a): ``act(a @ w + b)`` in fp32, rounded once to a's dtype.
    a (..., K), w (K, N) stored (in, out), b (N,) -> (..., N)."""
    y = _acc_bias(a, w, b)
    if act is not None:
        y = act(y)
    return y.to(a.dtype).reshape(*a.shape[:-1], w.shape[-1])


def gemm_bias_residual_reference(a, w, b, res):
    """Epilogue (b): ``res + (a @ w + b)`` in fp32, rounded once to res's
    dtype. a (..., K), w (K, N), b (N,), res (..., N)."""
    y = res.reshape(-1, res.shape[-1]).float() + _acc_bias(a, w, b)
    return y.to(res.dtype).reshape(res.shape)


def _acc(a, w):
    """fp32 ``a @ w`` over the rows of ``a`` (w (K, N), any strides)."""
    return _acc_bias(a, w, torch.zeros(w.shape[-1], device=a.device))


def gemm_dual_dact_reference(a, w, b, a2, w2t, act):
    """The dual mode (c): ``(a2 @ w2t.T) * act'(a @ w + b)``, both products
    and the bias in fp32, rounded once to a's dtype. a, a2 (..., K); w
    (K, N) stored (in, out); w2t (N, K) stored (out, in), the K-major
    operand; b (N,)."""
    y = _acc(a2, w2t.t()) * DACTS[act](_acc_bias(a, w, b))
    return y.to(a.dtype).reshape(*a.shape[:-1], w.shape[-1])


def gemm_f32_reference(a, w, scale=None, w_kmajor: bool = False):
    """Epilogue (d): ``(a @ W) * scale`` in fp32, not rounded; W is w (K, N),
    or w.T for ``w_kmajor`` (w (N, K)); ``scale`` (N,) or None."""
    wt = w.t() if w_kmajor else w
    y = _acc(a, wt)
    if scale is not None:
        y = y * scale.float()
    return y.reshape(*a.shape[:-1], wt.shape[-1])


def _lib():
    lib = _build.load("ln_mlp_residual")
    fn = lib.aaclip_ln_mlp_residual_gemm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(a, w, b, res, act, tile_n):
    fn = "gemm"
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {a.device}")
    k, n = w.shape
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: a and w must be bfloat16")
    if a.shape[-1] != k or b.shape != (n,) or (res is not None and res.shape[-1] != n):
        raise ValueError(f"{fn}: shapes do not match")
    if n % 128 or k % 64 or tile_n not in (0, 128, 256) or (tile_n and n % tile_n):
        raise ValueError(f"{fn}: N={n}, K={k}, tile_n={tile_n} not supported (N a multiple "
                         "of 128 and of the tile, K of 64)")
    if act not in _ACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    tensors = [a, w, b.float()] + ([res] if res is not None else [])
    for t in tensors:
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be contiguous, 16-byte aligned, on one card")
    m = a.numel() // k
    bias = tensors[2]
    out = torch.empty((*a.shape[:-1], n), dtype=torch.bfloat16, device=a.device)
    err = _lib()(a.data_ptr(), k, w.data_ptr(), n, bias.data_ptr(),
                 res.data_ptr() if res is not None else None, n, out.data_ptr(), n, m, n, k,
                 _ACTS[act], tile_n, _build.stream_ptr(a.device))
    _build.check("ln_mlp_residual", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


def _dx_lib(entry):
    lib = _build.load("ln_mlp_residual_dx")
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([p, i, p, i, i, p, p, i, i, i, i, i, p] if entry.endswith("f32")
                       else [p, i, p, i, p, p, i, p, i, p, i, i, i, i, i, p])
        fn.restype = ctypes.c_int
    return fn


def _checked(fn, a, *tensors):
    """The operands the core takes: bf16 a and weights on one card,
    contiguous and 16-byte aligned (fp32 vectors may be None)."""
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {a.device}")
    for t in (a, *tensors):
        if t is None:
            continue
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be contiguous, 16-byte aligned, on one card")


def gemm_f32(a, w, scale=None, w_kmajor: bool = False, tile_n: int = 0):
    """:func:`gemm_f32_reference` through the core on a CUDA tensor: bf16 a
    (..., K) and w, N a multiple of 128, K of 64; ``tile_n`` 0, 128 or 256."""
    if a.device.type == "cpu":
        return gemm_f32_reference(a, w, scale, w_kmajor)
    fn = "gemm_f32"
    n, k = w.shape if w_kmajor else w.shape[::-1]
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: a and w must be bfloat16")
    if a.shape[-1] != k or (scale is not None and scale.shape != (n,)):
        raise ValueError(f"{fn}: shapes do not match")
    if n % 128 or k % 64 or tile_n not in (0, 128, 256) or (tile_n and n % tile_n):
        raise ValueError(f"{fn}: N={n}, K={k}, tile_n={tile_n} not supported (N a multiple "
                         "of 128 and of the tile, K of 64)")
    scale = None if scale is None else scale.float().contiguous()
    _checked(fn, a, w, scale)
    m = a.numel() // k
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    err = _dx_lib("aaclip_ln_mlp_residual_dx_gemm_f32")(
        a.data_ptr(), k, w.data_ptr(), w.shape[-1], int(w_kmajor),
        None if scale is None else scale.data_ptr(), out.data_ptr(), n, m, n, k, tile_n,
        _build.stream_ptr(a.device))
    _build.check("ln_mlp_residual_dx", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


def gemm_dual_dact(a, w, b, a2, w2t, act):
    """:func:`gemm_dual_dact_reference` through the core on a CUDA tensor:
    bf16 a, a2 (..., K), w (K, N), w2t (N, K), N a multiple of 128, K of
    64; ``act`` GELU or QuickGELU."""
    if a.device.type == "cpu":
        return gemm_dual_dact_reference(a, w, b, a2, w2t, act)
    fn = "gemm_dual_dact"
    k, n = w.shape
    if any(t.dtype != torch.bfloat16 for t in (a, w, a2, w2t)):
        raise TypeError(f"{fn}: a, a2 and the weights must be bfloat16")
    if a.shape != a2.shape or a.shape[-1] != k or w2t.shape != (n, k) or b.shape != (n,):
        raise ValueError(f"{fn}: shapes do not match")
    if n % 128 or k % 64:
        raise ValueError(f"{fn}: N={n}, K={k} not supported (N a multiple of 128, K of 64)")
    if act not in DACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    bias = b.float().contiguous()
    _checked(fn, a, w, bias, a2, w2t)
    m = a.numel() // k
    out = torch.empty((*a.shape[:-1], n), dtype=torch.bfloat16, device=a.device)
    err = _dx_lib("aaclip_ln_mlp_residual_dx_gemm_dual")(
        a.data_ptr(), k, w.data_ptr(), n, bias.data_ptr(), a2.data_ptr(), k, w2t.data_ptr(), k,
        out.data_ptr(), n, m, n, k, _ACTS[act], _build.stream_ptr(a.device))
    _build.check("ln_mlp_residual_dx", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


def gemm_bias_act(a, w, b, act=None, tile_n: int = 0):
    """:func:`gemm_bias_act_reference` through the core on a CUDA tensor.
    bf16 a (..., K) and w (K, N), N a multiple of 128, K of 64; ``tile_n``
    0 (the core's choice), 128 or 256."""
    if a.device.type == "cpu":
        return gemm_bias_act_reference(a, w, b, act)
    return _launch(a, w, b, None, act, tile_n)


def gemm_bias_residual(a, w, b, res, tile_n: int = 0):
    """:func:`gemm_bias_residual_reference` through the core on a CUDA
    tensor; as :func:`gemm_bias_act`, res bf16 (..., N)."""
    if a.device.type == "cpu":
        return gemm_bias_residual_reference(a, w, b, res)
    return _launch(a, w, b, res, None, tile_n)
