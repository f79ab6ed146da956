"""The post-norm EVA block's kernels (``csrc/eva_postnorm.cu``) and their
plain versions.

No TPU kernel stands behind them: the JAX package has no EVA tower. The
block (``models.clip._run_eva_postnorm_block``, EVA02-CLIP-E/14+'s) runs
four products and two row passes:

- :func:`gemm_act`: ``act(a @ w + b)`` in fp32, rounded once, on the GEMM
  core's epilogue (a) (the qkv product without an activation, W1 with the
  exact GELU); the plain version is ``gemm.gemm_bias_act_reference``;
- :func:`gemm_f32`: ``a @ w`` kept in fp32, on the core's epilogue (d) (the
  out-projection and W2, whose outputs reach their LayerNorm unrounded);
  the plain version is ``gemm.gemm_f32_reference``;
- :func:`ln_residual_rows`: ``x + LN(z + bias)``, fp32 statistics, one
  rounding to x's dtype; the plain version is
  :func:`ln_residual_rows_reference`.

Each wrapper runs its plain version on a CPU tensor and its kernel on a
CUDA tensor, or raises: no fallback. :func:`check_postnorm` states the
block's conditions for them on the card, and raises where one fails. None has a backward: the model runs the stock chain
where a gradient is recorded.
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p as ptr

import torch

from . import _build
from .gemm import gemm_bias_act_reference, gemm_f32_reference
from .layers import gelu

#: The row pass's widest row (2,048 columns: 16 float4 a lane).
ROWS_MAX_WIDTH = 2048

_GEMM = _build.Entry("eva_postnorm", "eva_postnorm_gemm",
                     [ptr, c_int, ptr, c_int, ptr, ptr] + [c_int] * 5)
_GEMM_F32 = _build.Entry("eva_postnorm", "eva_postnorm_gemm_f32",
                         [ptr, c_int, ptr, c_int, ptr] + [c_int] * 4)
_ROWS = _build.Entry("eva_postnorm", "ln_residual_rows", [ptr] * 6 + [c_int, c_int, c_float])
_ACTS = {gelu: 0, None: 2}


def check_postnorm(x, block) -> None:
    """Raise ``ValueError`` naming the first condition that the block's
    kernels refuse for x (B, L, d) and the block's weights on the card: bf16
    contiguous 3-D x, bf16 contiguous weights, d and the hidden width
    multiples of 128 (the core's N and K), d at most
    :data:`ROWS_MAX_WIDTH`. A CPU x passes: the plain versions take any
    shape."""
    if x.device.type != "cuda":
        return
    d = x.shape[-1]
    mlp = block["mlp"]
    hidden = mlp["c_fc"]["w"].shape[-1]
    ws = {"qkv": block["attn"]["qkv"]["w"], "out": block["attn"]["out"]["w"],
          "c_fc": mlp["c_fc"]["w"], "c_proj": mlp["c_proj"]["w"]}
    bad = [w for w, t in ws.items() if t.dtype != torch.bfloat16 or not t.is_contiguous()]
    for failed, why in (
            (x.dtype != torch.bfloat16, f"x is {x.dtype}, not bfloat16"),
            (x.dim() != 3, f"x has {x.dim()} dimensions, not 3"),
            (not x.is_contiguous(), "x is not contiguous"),
            (d % 128 or d > ROWS_MAX_WIDTH,
             f"width {d} is not a multiple of 128 at most {ROWS_MAX_WIDTH}"),
            (hidden % 128, f"hidden width {hidden} is not a multiple of 128"),
            (bad, f"weights {', '.join(bad)} are not contiguous bfloat16")):
        if failed:
            raise ValueError(f"post-norm EVA block on the card: {why}")


def _check(fn, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be contiguous, 16-byte aligned, on one card")


def _product_shape(fn, a, w):
    k, n = w.shape
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: a and w must be bfloat16, got {a.dtype} and {w.dtype}")
    if a.shape[-1] != k or n % 128 or k % 64:
        raise ValueError(f"{fn}: a {tuple(a.shape)} . w {tuple(w.shape)} not supported "
                         "(N a multiple of 128, K of 64)")
    return a.numel() // k, n, k


def gemm_act(a, w, b, act=None):
    """``act(a @ w + b)`` rounded once to a's dtype: a (..., K), w (K, N)
    stored (in, out), b (N,); ``act`` None or the exact GELU. The core's
    epilogue (a) on a CUDA a, the plain version on a CPU a."""
    if a.device.type == "cpu":
        return gemm_bias_act_reference(a, w, b, act)
    if act not in _ACTS:
        raise ValueError(f"eva_postnorm_gemm: unsupported activation {act!r}")
    m, n, k = _product_shape("eva_postnorm_gemm", a, w)
    if b.shape != (n,):
        raise ValueError(f"eva_postnorm_gemm: bias {tuple(b.shape)} for N={n}")
    bias = b.float()
    _check("eva_postnorm_gemm", a, w, bias)
    out = torch.empty((*a.shape[:-1], n), dtype=a.dtype, device=a.device)
    _GEMM(a.device, a.data_ptr(), k, w.data_ptr(), n, bias.data_ptr(), out.data_ptr(), n, m, n,
          k, _ACTS[act])
    return out


def gemm_f32(a, w):
    """``a @ w`` in fp32, not rounded: a (..., K), w (K, N). The core's
    epilogue (d) on a CUDA a, the plain version on a CPU a."""
    if a.device.type == "cpu":
        return gemm_f32_reference(a, w)
    m, n, k = _product_shape("eva_postnorm_gemm_f32", a, w)
    _check("eva_postnorm_gemm_f32", a, w)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    _GEMM_F32(a.device, a.data_ptr(), k, w.data_ptr(), n, out.data_ptr(), n, m, n, k)
    return out


def ln_residual_rows_reference(z, bias, ln_params, x, eps: float = 1e-6):
    """``x + LN(z + bias)`` as the row pass computes it: v = z + bias in
    fp32, its mean, then the mean of (v - mean)^2, rstd = 1 / sqrt(var +
    eps), x + ((v - mean) * rstd * scale + shift) in fp32, rounded once to
    x's dtype."""
    v = z.float() + bias.float()
    mean = v.mean(dim=-1, keepdim=True)
    c = v - mean
    rstd = torch.rsqrt(c.square().mean(dim=-1, keepdim=True) + eps)
    y = x.float() + (c * rstd * ln_params["scale"].float() + ln_params["bias"].float())
    return y.to(x.dtype)


def ln_residual_rows(z, bias, ln_params, x, eps: float = 1e-6):
    """:func:`ln_residual_rows_reference`: the row pass on a CUDA x (bf16,
    z fp32, both contiguous (..., d), d a multiple of 4 and at most
    :data:`ROWS_MAX_WIDTH`), the plain version on a CPU x."""
    if x.device.type == "cpu":
        return ln_residual_rows_reference(z, bias, ln_params, x, eps)
    fn = "ln_residual_rows"
    d = x.shape[-1]
    if x.dtype != torch.bfloat16 or z.dtype != torch.float32 or z.shape != x.shape:
        raise TypeError(f"{fn}: takes fp32 z and bf16 x of one shape, got {z.dtype} "
                        f"{tuple(z.shape)} and {x.dtype} {tuple(x.shape)}")
    if d % 4 or d > ROWS_MAX_WIDTH:
        raise ValueError(f"{fn}: width {d} not supported (a multiple of 4, at most "
                         f"{ROWS_MAX_WIDTH})")
    vecs = [bias.float(), ln_params["scale"].float(), ln_params["bias"].float()]
    if any(v.shape != (d,) for v in vecs):
        raise ValueError(f"{fn}: bias, scale and shift must be ({d},)")
    _check(fn, z, x, *vecs)
    y = torch.empty_like(x)
    _ROWS(x.device, z.data_ptr(), *(t.data_ptr() for t in vecs), x.data_ptr(), y.data_ptr(),
          x.numel() // d, d, float(eps))
    return y
