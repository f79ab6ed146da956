"""Elementary transformer layers as plain functions on tensors.

Counterpart of ``aa_clip_iqm_tpu/ops/layers.py``. Parameters are dicts of
tensors with the JAX package's layout: a linear weight ``w`` is stored
``(in, out)`` and applied as ``x @ w``. Numerics follow the JAX functions:
LayerNorm statistics in float32, exact-erf GELU, products accumulated in
float32, the bias added in float32, and one cast back to the input dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(params, x, eps: float = 1e-5):
    """LayerNorm over the last axis in float32 (statistics and the float32
    scale/bias), cast once back to x.dtype. The input is upcast first: on
    CUDA, F.layer_norm takes no bf16 input with float32 parameters."""
    y = F.layer_norm(x.float(), x.shape[-1:], params["scale"].float(),
                     params["bias"].float(), eps)
    return y.to(x.dtype)


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


ACTIVATIONS = {"gelu": gelu, "quick_gelu": quick_gelu}


def linear(params, x):
    """y = x @ W + b, W stored (in, out): the product accumulated in float32,
    the bias added in float32, one rounding to x.dtype. Params carrying an
    int8-quantized weight ({"w_q", "scale"} from ops.quant) go to the int8
    product: one hook covers every projection in the model."""
    if "w_q" in params:
        from .quant import int8_linear

        return int8_linear(params, x)
    w = params["w"].to(x.dtype)
    b = params.get("b")
    if b is None:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = torch.addmm(b.float(), x2, w)
    elif x.is_cuda:
        # cuBLAS keeps the float32 accumulator as the output, the float32
        # bias joins it in the epilogue, and the cast rounds once.
        y = torch.addmm(b.float(), x2, w, out_dtype=torch.float32).to(x.dtype)
    else:
        # The CPU has no float32-output bf16 product; products of bf16
        # values are exact in float32, so the upcast product is the same.
        y = torch.addmm(b.float(), x2.float(), w.float()).to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def leaky_relu(x, negative_slope: float = 0.01):
    return torch.where(x >= 0, x, negative_slope * x)


def simple_adapter(params, x):
    """Bias-free Linear + LeakyReLU (reference SimpleAdapter)."""
    return leaky_relu(linear(params, x))


def simple_proj(params, x, relu: bool):
    """Bias-free Linear, optional LeakyReLU (reference SimpleProj)."""
    y = linear(params, x)
    return leaky_relu(y) if relu else y


def l2_normalize(x, dim: int = -1):
    n = torch.linalg.vector_norm(x.float(), dim=dim, keepdim=True)
    return (x.float() / n).to(x.dtype)


def norm_preserving_blend(x, adapted, weight: float):
    """x <- w * adapted * |x|/|adapted| + (1-w) * x, in float32."""
    x32 = x.float()
    a32 = adapted.float()
    xn = torch.linalg.vector_norm(x32, dim=-1, keepdim=True)
    an = torch.linalg.vector_norm(a32, dim=-1, keepdim=True)
    out = weight * (a32 * xn / an) + (1.0 - weight) * x32
    return out.to(x.dtype)


def mlp_block(params, x, act):
    """Transformer MLP: c_fc -> act -> c_proj."""
    h = linear(params["c_fc"], x)
    h = act(h)
    return linear(params["c_proj"], h)
