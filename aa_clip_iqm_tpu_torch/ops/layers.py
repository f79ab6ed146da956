"""Elementary transformer layers as plain functions on tensors.

Counterpart of ``aa_clip_iqm_tpu/ops/layers.py``. Parameters are dicts of
tensors with the JAX package's layout: a linear weight ``w`` is stored
``(in, out)`` and applied as ``x @ w``. Numerics follow the JAX functions:
LayerNorm statistics in float32, exact-erf GELU, products accumulated in
float32, the bias added in float32, and one cast back to the input dtype.
"""
from __future__ import annotations

import weakref

import torch
import torch.nn.functional as F

from . import custom_ops


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


class _AddmmF32Bias(torch.autograd.Function):
    """bf16 ``x2 @ w + b`` on the card with the float32 bias joining the
    float32 accumulator before the one rounding (``addmm`` with a float32
    output, which autograd cannot differentiate itself). The backward is the
    two transposed products and the column sum of the cotangent."""

    @staticmethod
    def forward(ctx, b, x2, w):
        ctx.save_for_backward(x2, w)
        ctx.b_dtype = b.dtype
        return torch.addmm(b.float(), x2, w, out_dtype=torch.float32).to(x2.dtype)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        need_b, need_x, need_w = ctx.needs_input_grad
        db = g.float().sum(dim=0).to(ctx.b_dtype) if need_b else None
        dx = torch.matmul(g, w.t()) if need_x else None
        dw = torch.matmul(x2.t(), g) if need_w else None
        return db, dx, dw


def linear(params, x):
    """y = x @ W + b, W stored (in, out): the product accumulated in float32,
    the bias added in float32, one rounding to x.dtype. The weight is cast to
    x.dtype at each call, so float32 master weights train under a bf16
    forward (autograd differentiates the cast). Params carrying an
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
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad
                                        or b.requires_grad):
            y = _AddmmF32Bias.apply(b, x2, w)
        elif custom_ops.is_traced(x2):
            # The same call as one op of the trace (custom_ops.addmm_f32).
            y = custom_ops.addmm_f32(b.float(), x2, w).to(x.dtype)
        else:
            y = torch.addmm(b.float(), x2, w, out_dtype=torch.float32).to(x.dtype)
    else:
        # The CPU has no float32-output bf16 product; products of bf16
        # values are exact in float32, so the upcast product is the same.
        y = torch.addmm(b.float(), x2.float(), w.float()).to(x.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


class _MmF32(torch.autograd.Function):
    """bf16 ``x2 @ w`` on the card with the float32 accumulator as the
    output (``mm`` with a float32 output, which autograd cannot
    differentiate itself). The backward's products run in the input dtype:
    the cotangent arrives from a cast of the bf16 result, so it is exact
    there."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.mm(x2, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        need_x, need_w = ctx.needs_input_grad
        dx = torch.matmul(g, w.t()) if need_x else None
        dw = torch.matmul(x2.t(), g) if need_w else None
        return dx, dw


def linear_partial(params, x):
    """``x @ W`` accumulated and returned in float32, without the bias: one
    rank's share of a row-split product, which the tensor-parallel block sums
    over its ranks before it adds the bias and rounds once, so that the
    result is :func:`linear`'s."""
    w = params["w"].to(x.dtype)
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32:
        y = torch.matmul(x2, w)
    elif x.is_cuda:
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            y = _MmF32.apply(x2, w)
        else:
            y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        # As in linear: products of bf16 values are exact in float32.
        y = torch.matmul(x2.float(), w.float())
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


def patch_dropout_indices(generator, batch: int, num_tokens: int, rate: float,
                          device=None):
    """Per-sample kept-token indices for patch dropout: keep
    max(1, int(L*(1-rate))) of L tokens, uniformly without replacement (the
    top-k of normal scores drawn from ``generator``, a ``torch.Generator``).

    Returns (B, K) int64 sorted ascending, so the kept tokens preserve their
    spatial order and the stage-2 loss can gather the matching mask cells.
    The draws are torch's, not the JAX package's: tests hand both the same
    indices.
    """
    keep = max(1, int(num_tokens * (1.0 - rate)))
    scores = torch.randn((batch, num_tokens), generator=generator,
                         device=generator.device)
    idx = torch.topk(scores, keep, dim=-1).indices
    idx = torch.sort(idx, dim=-1).values
    return idx if device is None else idx.to(device)


# What frozen_layout made, by (build, the first source): the sources' ids and
# the result, dropped with the first source.
_LAYOUTS: dict = {}


def frozen_layout(build, *sources):
    """``build(*sources)`` for tensors of a frozen backbone (a kernel's layout
    of a layer's weights), made at the first call and kept while the first
    source lives: a frozen weight is never updated in place, so the result
    stays right, and a CUDA graph that keeps the tree keeps it. The first
    call makes new tensors, which a capture must not (they would live in its
    pool): it must come before the capture (the detector's warm-up run)."""
    key, ids = (build, id(sources[0])), tuple(map(id, sources))
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0]() is sources[0] and hit[1] == ids:
        return hit[2]
    if sources[0].is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{getattr(build, '__name__', build)}: a layout of frozen weights "
                           "is first made during a CUDA graph capture; run the program once "
                           "before capturing it")
    with torch.inference_mode(False), torch.no_grad():
        out = build(*sources)
    _LAYOUTS[key] = (weakref.ref(sources[0], lambda _: _LAYOUTS.pop(key, None)), ids, out)
    return out
