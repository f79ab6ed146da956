"""Fused attention half of a transformer block: the Hopper kernel and its plain twin.

Counterpart of ``ln_attn_residual`` in
``aa_clip_iqm_tpu/ops/pallas_attn_block.py`` (TPU kernel ``_kernel``):
``x + out_proj(attn(qkv_proj(layer_norm(x))))``, plain or value-value
(``vv``: q, k and v all from the value projection). The kernel lives in
``csrc/ln_attn_residual.cu``; see its header for the design (four launches:
the LayerNorm pass, the qkv projection on the wgmma GEMM core of
``ops/gemm.py``, B1's attention, the out-projection with the residual on the
same core); :func:`ln_attn_residual_stages` is their plain version, with the
kernel's roundings. On a CPU tensor :func:`ln_attn_residual` runs the plain twin
:func:`ln_attn_residual_reference`; on a CUDA tensor it launches the kernel
or raises, through the custom op ``aaclip::ln_attn_residual``
(``ops/custom_ops.py``; its CUDA implementation is :func:`_launch`). Its
gradient is autograd through the plain chain, for x and every
parameter, as JAX's ``_bwd`` (pallas_attn_block.py:224) is an XLA recompute.

The gate :func:`ln_attn_residual_ok` is JAX's without its backend test and
without its ``L % 128`` term: the kernel masks its own ragged key tail, as
B1 does, so the tower is never padded.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, custom_ops
from .gemm import gemm_bias_act_reference, gemm_bias_residual_reference
from .layers import layer_norm, linear
from .packed_attention import (flash_mha_packed_reference, flash_mha_packed_stages,
                               mha_reference)

#: Kernel calls since the last reset (one per call; each call is four launches).
LAUNCHES = 0
#: The one head width the kernel is built for (ViT-L: 16 heads of 64).
HEAD_DIM = 64


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def ln_attn_residual_ok(x, attn_params, num_heads: int) -> bool:
    """Whether the fused route takes this call site: the gate of
    pallas_attn_block.py:116 without its backend test and without L % 128.
    bf16 x, float (not int8) qkv weights, square projections, whole heads
    in 128-column panels."""
    if x.dtype != torch.bfloat16 or x.dim() != 3:
        return False
    if "w" not in attn_params["qkv"]:        # int8 ({"w_q", "scale", "b"})
        return False
    w = attn_params["qkv"]["w"]
    d = x.shape[-1]
    if not w.is_floating_point():
        return False
    if w.shape[-1] != 3 * d or tuple(attn_params["out"]["w"].shape) != (d, d):
        return False
    if d % 128 or d % num_heads:
        return False
    hd = d // num_heads
    group = max(1, 128 // hd)
    return (group * hd) % 128 == 0 and num_heads % group == 0


def ln_attn_residual_reference(ln_params, attn_params, x, num_heads: int,
                               vv: bool = False, valid_len=None, eps: float = 1e-5):
    """Plain PyTorch twin, JAX's ``_xla_chain`` (pallas_attn_block.py:104):
    LayerNorm, the qkv projection, packed attention, the out-projection and
    the residual, each rounded to x's dtype as the chain rounds it."""
    h = layer_norm(ln_params, x, eps=eps)
    qkv = linear(attn_params["qkv"], h)
    hd = x.shape[-1] // num_heads
    out = flash_mha_packed_reference(qkv, num_heads, hd ** -0.5, vv, valid_len)
    return x + linear(attn_params["out"], out)


def ln_attn_residual_stages(ln_params, attn_params, x, num_heads: int, vv: bool = False,
                            valid_len=None, eps: float = 1e-5, walk: bool = False):
    """The plain version of the four stages the kernel runs, each rounded
    where it rounds: LN(x), the projection (for ``vv`` only its value
    section), the attention output, and the output once after the residual,
    the bias and the fp32 out-projection. The first three equal the twin's
    intermediates bit for bit; the twin rounds the out-projection before the
    residual add. With ``walk`` the attention output is that of the plain
    version of the attention kernel's tile walk
    (:func:`.packed_attention.flash_mha_packed_stages`), as the kernel's
    third launch computes it."""
    d = x.shape[-1]
    qkv_p, out_p = attn_params["qkv"], attn_params["out"]
    w, b = (qkv_p["w"][:, 2 * d:], qkv_p["b"][2 * d:]) if vv else (qkv_p["w"], qkv_p["b"])
    proj = gemm_bias_act_reference(layer_norm(ln_params, x, eps=eps), w, b)
    q, k, v = (proj,) * 3 if vv else proj.split(d, dim=-1)
    scale = (d // num_heads) ** -0.5
    if walk:
        o = flash_mha_packed_stages(torch.cat([q, k, v], dim=-1), num_heads, scale, False,
                                    valid_len)
    else:
        o = mha_reference(q, k, v, num_heads, scale, valid_len)
    return gemm_bias_residual_reference(o, out_p["w"], out_p["b"], x)


def _lib():
    lib = _build.load("ln_attn_residual")
    fn = lib.aaclip_ln_attn_residual
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _operand(t, dtype, device, what):
    """``t`` as the kernel reads it: on x's device, in ``dtype``, contiguous
    (a copy only where the caller's tensor is not already so)."""
    if t.device != device:
        raise ValueError(f"ln_attn_residual: {what} is on {t.device}, x on {device}")
    t = t.to(dtype).contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"ln_attn_residual: {what} must be 16-byte aligned")
    return t


def _forward(ln_params, attn_params, x, num_heads: int, vv: bool, valid_len,
             eps: float):
    """The fused branch without autograd, through ``aaclip::ln_attn_residual``:
    the twin on the CPU, the kernel on the card."""
    custom_ops.check_device("ln_attn_residual", x)
    qkv_p, out_p = attn_params["qkv"], attn_params["out"]
    return custom_ops.ln_attn_residual(
        x, ln_params["scale"], ln_params["bias"], qkv_p["w"], qkv_p["b"], out_p["w"],
        out_p["b"], int(num_heads), bool(vv), None if valid_len is None else int(valid_len),
        float(eps))


def _launch(ln_params, attn_params, x, num_heads: int, vv: bool, valid_len, eps: float):
    """The kernel on a CUDA x (the CUDA implementation of the op)."""
    fn = "ln_attn_residual"
    if x.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {x.device}")
    if not ln_attn_residual_ok(x, attn_params, num_heads):
        raise ValueError(f"{fn}: the call fails ln_attn_residual_ok (bf16 (B, L, d) x, "
                         "float square projections, whole heads in 128-column panels)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{fn}: x must be contiguous and 16-byte aligned")
    b, l, d = x.shape
    hd = d // num_heads
    if hd != HEAD_DIM:
        raise ValueError(f"{fn}: {num_heads} heads of {hd}; the kernel takes heads of "
                         f"{HEAD_DIM}")
    vl = l if valid_len is None else int(valid_len)
    if vl <= 0:
        raise ValueError(f"{fn}: valid_len {vl} must be positive")
    dev, bf16, f32 = x.device, torch.bfloat16, torch.float32
    qkv_p, out_p = attn_params["qkv"], attn_params["out"]
    ops = [_operand(ln_params["scale"], f32, dev, "ln scale"),
           _operand(ln_params["bias"], f32, dev, "ln bias"),
           _operand(qkv_p["w"], bf16, dev, "qkv weight"),
           _operand(qkv_p["b"], f32, dev, "qkv bias"),
           _operand(out_p["w"], bf16, dev, "out weight"),
           _operand(out_p["b"], f32, dev, "out bias")]
    # The intermediates in device memory, side by side in one scratch: the
    # projection that attention reads, the packed (B*L, 3d) qkv or for vv the
    # (B*L, d) value section, then d columns for LN(x) and, over it, the
    # attention output.
    scratch = torch.empty((b * l, (d if vv else 3 * d) + d), dtype=bf16, device=dev)
    y = torch.empty_like(x)
    err = _lib()(x.data_ptr(), *(t.data_ptr() for t in ops), scratch.data_ptr(), y.data_ptr(),
                 b, l, d, num_heads, vl, float(eps), float(hd ** -0.5), int(bool(vv)),
                 _build.stream_ptr(dev))
    _build.check("ln_attn_residual", err)
    global LAUNCHES
    LAUNCHES += 1
    return y


def _leaves(ln_params, attn_params):
    """The chain's parameter tensors, in a fixed order."""
    return (ln_params["scale"], ln_params["bias"], attn_params["qkv"]["w"],
            attn_params["qkv"]["b"], attn_params["out"]["w"], attn_params["out"]["b"])


def _trees(leaves):
    ls, lb, wq, bq, wo, bo = leaves
    return ({"scale": ls, "bias": lb},
            {"qkv": {"w": wq, "b": bq}, "out": {"w": wo, "b": bo}})


class _LnAttnResidual(torch.autograd.Function):
    """Forward: the fused kernel (twin on the CPU). Backward: the plain chain
    recomputed and differentiated, for x and every parameter, as JAX's
    ``_bwd`` (pallas_attn_block.py:224)."""

    @staticmethod
    def forward(ctx, x, num_heads, vv, valid_len, eps, *leaves):
        ctx.save_for_backward(x, *leaves)
        ctx.args = (num_heads, vv, valid_len, eps)
        return _forward(*_trees(leaves), x, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        x, *leaves = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], *ctx.needs_input_grad[5:])
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((x, *leaves), need)]
            y = ln_attn_residual_reference(*_trees(ins[1:]), ins[0], *ctx.args)
            wanted = [t for t, n in zip(ins, need) if n]
            grads = iter(torch.autograd.grad(y, wanted, g) if wanted else ())
        dx, *dleaves = [next(grads) if n else None for n in need]
        return (dx, None, None, None, None, *dleaves)


def ln_attn_residual(ln_params, attn_params, x, num_heads: int, vv: bool = False,
                     valid_len=None, eps: float = 1e-5):
    """x + out_proj(attn(qkv_proj(layer_norm(x)))), differentiable in x and
    every parameter. x: (B, L, d) bf16; guard call sites with
    :func:`ln_attn_residual_ok`. ``vv`` points q, k and v at the value
    projection; ``valid_len``: keys at or past it are masked."""
    leaves = _leaves(ln_params, attn_params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *leaves)):
        return _LnAttnResidual.apply(x, num_heads, bool(vv), valid_len, eps, *leaves)
    return _forward(ln_params, attn_params, x, num_heads, vv, valid_len, eps)
