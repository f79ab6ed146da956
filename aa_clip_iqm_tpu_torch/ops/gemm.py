"""The Hopper GEMM core of B2 and B8, and the plain versions of its stages.

B2 (``csrc/ln_mlp_residual.cu``) and B8 (``csrc/ln_attn_residual.cu``) run
their products on one hand-written wgmma GEMM core, ``csrc/gemm_sm90.cuh``
(see its header for the design), after a row-wise LayerNorm pass. Each stage
has a plain version with the kernel's roundings:

- the LayerNorm pass is :func:`.layers.layer_norm` (fp32 statistics, one
  rounding to x's dtype);
- epilogue (a), :func:`gemm_bias_act_reference`: ``act(a @ w + b)`` in fp32,
  one rounding;
- epilogue (b), :func:`gemm_bias_residual_reference`: ``res + (a @ w + b)``
  in fp32, one rounding.

The product is computed as :func:`.layers.linear` computes it before its
rounding, so that without an activation stage (a) equals ``linear`` bit for
bit. :func:`gemm_bias_act` and :func:`gemm_bias_residual` launch one product
of the core alone on CUDA tensors (the plain version on CPU tensors), with a
choice of tile width: the card tests and ``chip_smoke.py`` use them; the
model reaches the core only through B2 and B8.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layers import gelu, quick_gelu

#: Launches of the core alone since the last reset (B2 and B8 count their own).
LAUNCHES = 0

_ACTS = {gelu: 0, quick_gelu: 1, None: 2}


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
