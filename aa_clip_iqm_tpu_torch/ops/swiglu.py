"""EVA-02's MLP half, LayerNorm -> SwiGLU -> sub-LN -> out-projection ->
residual: the Hopper kernel ``ln_swiglu_residual`` and its plain versions.

No TPU kernel stands behind it: the JAX package has no EVA-02 tower. The
MLP's parameters (``models.clip``'s EVA-02 block):

    mlp = {"w12": {"w": (d, 2h), "b": (2h,)},   # [W1 | W2], stored (in, out)
           "ln":  {"scale": (h,), "bias": (h,)},  # the sub-LN, LN_ffn
           "w3":  {"w": (h, d), "b": (d,)}}

and ``y = x + LN_ffn(SiLU(u W1 + b1) * (u W2 + b2)) W3 + b3`` with ``u =
LN2(x)``. :func:`ln_swiglu_residual_reference` is that chain on stock calls
(the CPU's route and the plain twin). On the card the kernel
(``csrc/ln_swiglu_residual.cu``, whose header has the design) reads the
weights laid out once per weight tensor (:func:`lay_out`, kept by
``layers.frozen_layout``): the hidden width
padded to a multiple of 128 with zero weights and biases, and LN_ffn's
scale folded into W3 (``W3' = diag(gamma) W3``, ``s3 = 1^T W3'``, ``b3' = b3
+ beta W3``), so that the out product runs on the raw hidden layer and its
epilogue normalises: ``((g W3') - mu s3) * rstd + b3'``, with mu and rstd
taken over the h real columns of g, never the padded ones.
:func:`ln_swiglu_residual_stages` is the plain version of the kernel's
three stages, with its roundings. Neither has a backward: the model runs
the chain where a gradient is recorded.
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .gemm import _acc, _acc_bias
from .layers import frozen_layout, layer_norm, linear

#: Kernel launches since the last reset: the whole MLP half, and the
#: LayerNorm pass alone (:func:`layer_norm_rows`).
LAUNCHES = 0
LN_LAUNCHES = 0
#: The hidden layer's tile width in the kernel's dual product; the hidden
#: width is padded to a multiple of it.
HIDDEN_TILE = 128


def reset_launches() -> None:
    global LAUNCHES, LN_LAUNCHES
    LAUNCHES = LN_LAUNCHES = 0


def swiglu_mlp(mlp, u, eps: float = 1e-6):
    """The MLP on ``u = LN2(x)``: ``LN_ffn(SiLU(u W1 + b1) * (u W2 + b2)) W3
    + b3`` on stock calls, each product rounded to u's dtype as
    :func:`.layers.linear` rounds."""
    h = mlp["ln"]["scale"].shape[0]
    a = linear(mlp["w12"], u)
    g = F.silu(a[..., :h]) * a[..., h:]
    return linear(mlp["w3"], layer_norm(mlp["ln"], g, eps=eps))


def ln_swiglu_residual_reference(ln_params, mlp, x, eps: float = 1e-6,
                                 ffn_eps: float = 1e-6):
    """The plain twin: ``x + swiglu_mlp(mlp, LN2(x))``."""
    return x + swiglu_mlp(mlp, layer_norm(ln_params, x, eps=eps), ffn_eps)


def leaves(mlp):
    """The MLP's tensors in :func:`lay_out`'s order."""
    return (mlp["w12"]["w"], mlp["w12"]["b"], mlp["ln"]["scale"], mlp["ln"]["bias"],
            mlp["w3"]["w"], mlp["w3"]["b"])


def lay_out(w12, b12, gamma, beta, w3, b3):
    """The kernel's weights from the MLP's (:func:`leaves`; plain calls, any
    device): ``w12t`` (2 hp, d) [W1 | W2]^T with zero rows from h to hp in
    each half, ``b12`` (2 hp) float32 likewise, ``w3t`` (d, hp) W3'^T in the
    weights' dtype with zero columns past h, ``s3`` and ``b3`` (d) float32
    (``1^T W3'`` from the rounded W3', and ``b3 + beta W3``), ``h`` and
    ``hp``."""
    gamma, beta = gamma.float(), beta.float()
    d, h = w12.shape[0], w12.shape[1] // 2
    hp = -(-h // HIDDEN_TILE) * HIDDEN_TILE
    dev, dtype = w12.device, w12.dtype
    w12t = torch.zeros((2 * hp, d), dtype=dtype, device=dev)
    w12t[:h] = w12[:, :h].t()
    w12t[hp:hp + h] = w12[:, h:].t()
    b = torch.zeros(2 * hp, dtype=torch.float32, device=dev)
    b[:h] = b12[:h].float()
    b[hp:hp + h] = b12[h:].float()
    w3f = (w3.float() * gamma[:, None]).to(dtype)
    w3t = torch.zeros((d, hp), dtype=dtype, device=dev)
    w3t[:, :h] = w3f.t()
    return SimpleNamespace(w12t=w12t, b12=b, w3t=w3t, s3=w3f.float().sum(0),
                           b3=b3.float() + beta @ w3.float(), h=h, hp=hp)


def ln_swiglu_residual_stages(ln_params, mlp, x, eps: float = 1e-6, ffn_eps: float = 1e-6,
                              ops=None):
    """The plain version of the kernel's stages, each rounded where it
    rounds: u = LN2(x) once; g = SiLU(a1) * a2 from the fp32 products and
    biases, once; then, from the rounded g in fp32, mu = sum(g) * (1 / h),
    var = max(sum(g^2) * (1 / h) - mu^2, 0), rstd = 1 / sqrt(var + ffn_eps),
    and y = x + ((g W3' - mu s3) * rstd + b3') rounded once. ``ops``: the
    laid-out weights (:func:`lay_out` where None)."""
    ops = lay_out(*leaves(mlp)) if ops is None else ops
    d, hp = x.shape[-1], ops.hp
    u = layer_norm(ln_params, x.reshape(-1, d), eps=eps)
    a = _acc_bias(u, ops.w12t.t(), ops.b12)
    g = (F.silu(a[:, :hp]) * a[:, hp:]).to(x.dtype).float()
    inv_h = np.float32(1.0 / ops.h).item()
    mu = g.sum(-1, keepdim=True) * inv_h
    var = (g.square().sum(-1, keepdim=True) * inv_h - mu * mu).clamp_min(0.0)
    acc = _acc(g.to(x.dtype), ops.w3t.t())
    y = x.reshape(-1, d).float() + ((acc - mu * ops.s3) * torch.rsqrt(var + ffn_eps) + ops.b3)
    return y.to(x.dtype).reshape(x.shape)


def _lib():
    lib = _build.load("ln_swiglu_residual")
    fn = lib.aaclip_ln_swiglu_residual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ln_lib():
    fn = _build.load("ln_swiglu_residual").aaclip_ln_swiglu_residual_layer_norm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def layer_norm_rows(ln_params, x, eps: float = 1e-6):
    """LayerNorm over x's last axis with float32 statistics, one rounding to
    x's dtype: the kernel's LayerNorm pass alone (bf16 in and out, no float32
    copy of x) on a CUDA x, which has to be contiguous bf16 of a width that
    is a multiple of 8; :func:`.layers.layer_norm` on a CPU x. The EVA-02
    block's LN1 and attention sub-LN."""
    if x.device.type == "cpu":
        return layer_norm(ln_params, x, eps=eps)
    d = x.shape[-1]
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or not x.is_contiguous() or d % 8:
        raise ValueError(f"layer_norm_rows: takes a contiguous bf16 CUDA x of a width that is a "
                         f"multiple of 8; got {tuple(x.shape)} {x.dtype} on {x.device}")
    g, b = (ln_params[k].to(torch.float32).contiguous() for k in ("scale", "bias"))
    y = torch.empty_like(x)
    err = _ln_lib()(x.data_ptr(), g.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel() // d, d,
                    float(eps), _build.stream_ptr(x.device))
    _build.check("ln_swiglu_residual", err)
    global LN_LAUNCHES
    LN_LAUNCHES += 1
    return y


def _launch(ln_params, mlp, x, eps: float, ffn_eps: float):
    fn = "ln_swiglu_residual"
    d = x.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or d % 128:
        raise ValueError(f"{fn}: takes contiguous bf16 x of a width that is a multiple of "
                         f"128; got {tuple(x.shape)} {x.dtype}")
    ops = frozen_layout(lay_out, *leaves(mlp))
    if ops.w12t.dtype != x.dtype or ops.w12t.shape[1] != d:
        raise ValueError(f"{fn}: weights {tuple(mlp['w12']['w'].shape)} "
                         f"{mlp['w12']['w'].dtype} do not fit x {tuple(x.shape)}")
    m, dev = x.numel() // d, x.device
    f32 = torch.float32
    ln = [ln_params["scale"].to(f32).contiguous(), ln_params["bias"].to(f32).contiguous()]
    xin = torch.empty((m, d), dtype=x.dtype, device=dev)
    hid = torch.empty((m, ops.hp), dtype=x.dtype, device=dev)
    stats = torch.empty((m, ops.hp // HIDDEN_TILE, 2), dtype=f32, device=dev)
    y = torch.empty_like(x)
    ptrs = [t.data_ptr() for t in (x, *ln, ops.w12t, ops.b12, ops.w3t, ops.s3, ops.b3, xin,
                                   hid, stats, y)]
    err = _lib()(*ptrs, m, d, ops.h, ops.hp, float(eps), float(ffn_eps),
                 _build.stream_ptr(dev))
    _build.check(fn, err)
    global LAUNCHES
    LAUNCHES += 1
    return y


def ln_swiglu_residual(ln_params, mlp, x, eps: float = 1e-6, ffn_eps: float = 1e-6):
    """``x + LN_ffn(SiLU(u W1 + b1) * (u W2 + b2)) W3 + b3``, ``u =
    LN2(x)`` (``ln_params``, ``eps``; LN_ffn's is ``ffn_eps``): the kernel on
    a CUDA x (bf16, contiguous, d a multiple of 128), the plain twin on a
    CPU x. No gradient."""
    if x.device.type == "cpu":
        return ln_swiglu_residual_reference(ln_params, mlp, x, eps, ffn_eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_swiglu_residual: unsupported device {x.device}")
    return _launch(ln_params, mlp, x, eps, ffn_eps)
