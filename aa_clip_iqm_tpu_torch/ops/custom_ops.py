"""The forward kernels of the serving path as ``torch.library`` custom ops.

One namespace, ``aaclip::``:

  ``flash_mha_packed``      B1, packed-qkv attention (``packed_attention.py``)
  ``flash_mha_packed_lse``  B1 writing each row's log-sum-exp too (the
                            stage-2 forward that B4/B6 read)
  ``ln_mlp_residual``       B2, fused LayerNorm -> MLP -> residual
                            (``fused_mlp.py``)
  ``ln_mlp_residual_int8``  B3, the same on int8 weights
  ``flash_mha``             B7, unpacked (BH, L, hd) attention
                            (``flash_attention.py``)
  ``ln_attn_residual``      B8, the fused attention half-block
                            (``attn_block.py``)
  ``ln_attn_front``         B8's LayerNorm pass and qkv product alone
  ``ln_attn_back``          B8's out-projection with the residual alone

Each op has three implementations:

- CUDA: the module's ``_launch`` (the ctypes launch of the hand-written
  kernel, with its checks and its launch counter);
- CPU: the module's plain version, what the CPU has always run;
- fake (also the meta device's): output shapes and dtypes only. On a fake
  CUDA tensor it also applies the card kernel's own shape limits (B1, B7 and
  B8 take heads of 64, B1 also of 112 and 72; B3 needs d a multiple of 128 and a
  hidden width that chunks), so that a trace for the card fails where the
  card would.

One more op, ``aaclip::addmm_f32``, is no kernel of the port: it wraps
cuBLAS's ``addmm`` with a float32 output (``ops/layers.linear``'s bf16
projection on the card) so that a trace records it whole, where some
PyTorch versions' decomposition of that overload fails.

Parameter dicts are passed as their tensors, the activation by name
(``"gelu"``, ``"quick_gelu"`` or, for B2 only, ``"gelu_tanh"``). The public
wrappers (``flash_mha_packed``, ``ln_mlp_residual``, ...) and their
``autograd.Function`` forwards call these ops, so an eager call, a training
step, a CUDA graph capture and a ``torch.export`` program all reach the
same launch, and the counters count wherever a kernel is launched. The
backward kernels (B4, B5, B6) are not ops: no exported program runs a
backward.

Nothing here imports a kernel module at import time (they import this one);
the implementations import them when called.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

#: The forward ops, as ``torch.ops.aaclip.<name>``.
OPS = ("flash_mha_packed", "flash_mha_packed_lse", "ln_mlp_residual",
       "ln_mlp_residual_int8", "flash_mha", "ln_attn_residual", "ln_attn_front",
       "ln_attn_back")
#: The card kernels' head width (B1, B7, B8).
HEAD_DIM = 64


def is_traced(t) -> bool:
    """Whether ``t`` stands for a tensor under a tracer (a fake tensor, or a
    functional wrapper of one) rather than holding data."""
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def check_device(fn: str, t) -> None:
    """The wrappers' device rule: a CPU tensor runs the plain version, a CUDA
    tensor the kernel, a traced tensor of any device the fake; anything else
    is refused."""
    if t.device.type not in ("cpu", "cuda") and not is_traced(t):
        raise ValueError(f"{fn}: unsupported device {t.device}")


def _cuda_head_width(fn: str, t: Tensor, width: int, num_heads: int, extra=()) -> None:
    if t.device.type == "cuda" and (width % num_heads
                                    or width // num_heads not in (HEAD_DIM, *extra)):
        raise ValueError(f"{fn}: head width {width / num_heads:g}; the kernel takes "
                         f"{' or '.join(map(str, (HEAD_DIM, *extra)))}")


def _activation(act: str):
    from .layers import ACTIVATIONS

    if act not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {act!r}")
    return ACTIVATIONS[act]


def _ln(scale, bias):
    return {"scale": scale, "bias": bias}


# --------------------------------------------------------------------------
# B1: packed-qkv attention
# --------------------------------------------------------------------------

def _packed_out_shape(fn: str, qkv: Tensor, num_heads: int):
    from .packed_attention import FORWARD_HEAD_DIMS

    b, l, threew = qkv.shape
    _cuda_head_width(fn, qkv, threew // 3, num_heads, FORWARD_HEAD_DIMS[1:])
    return b, l, threew // 3


@torch.library.custom_op("aaclip::flash_mha_packed", mutates_args=(), device_types="cpu")
def flash_mha_packed(qkv: Tensor, num_heads: int, scale: float, vv: bool,
                     valid_len: Optional[int]) -> Tensor:
    from .packed_attention import flash_mha_packed_reference

    return flash_mha_packed_reference(qkv, num_heads, scale, vv, valid_len)


@flash_mha_packed.register_kernel("cuda")
def _(qkv, num_heads, scale, vv, valid_len):
    from .packed_attention import _launch

    return _launch(qkv, num_heads, scale, vv, valid_len, with_lse=False)


@flash_mha_packed.register_fake
def _(qkv, num_heads, scale, vv, valid_len):
    return qkv.new_empty(_packed_out_shape("flash_mha_packed", qkv, num_heads))


@torch.library.custom_op("aaclip::flash_mha_packed_lse", mutates_args=(), device_types="cpu")
def flash_mha_packed_lse(qkv: Tensor, num_heads: int, scale: float, vv: bool,
                         valid_len: Optional[int]) -> Tuple[Tensor, Tensor]:
    from .packed_attention import flash_mha_packed_reference, packed_lse_reference

    return (flash_mha_packed_reference(qkv, num_heads, scale, vv, valid_len),
            packed_lse_reference(qkv, num_heads, scale, vv, valid_len))


@flash_mha_packed_lse.register_kernel("cuda")
def _(qkv, num_heads, scale, vv, valid_len):
    from .packed_attention import _launch

    return _launch(qkv, num_heads, scale, vv, valid_len, with_lse=True)


@flash_mha_packed_lse.register_fake
def _(qkv, num_heads, scale, vv, valid_len):
    b, l, w = _packed_out_shape("flash_mha_packed_lse", qkv, num_heads)
    return (qkv.new_empty((b, l, w)),
            qkv.new_empty((b, num_heads, l), dtype=torch.float32))


# --------------------------------------------------------------------------
# B2 and B3: fused LayerNorm -> MLP -> residual
# --------------------------------------------------------------------------

@torch.library.custom_op("aaclip::ln_mlp_residual", mutates_args=(), device_types="cpu")
def ln_mlp_residual(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_fc: Tensor,
                    b_fc: Tensor, w_proj: Tensor, b_proj: Tensor, act: str,
                    eps: float) -> Tensor:
    from .fused_mlp import ln_mlp_residual_reference

    mlp = {"c_fc": {"w": w_fc, "b": b_fc}, "c_proj": {"w": w_proj, "b": b_proj}}
    return ln_mlp_residual_reference(_ln(ln_scale, ln_bias), mlp, x, _activation(act), eps)


@ln_mlp_residual.register_kernel("cuda")
def _(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, act, eps):
    from .fused_mlp import _launch

    mlp = {"c_fc": {"w": w_fc, "b": b_fc}, "c_proj": {"w": w_proj, "b": b_proj}}
    return _launch(_ln(ln_scale, ln_bias), mlp, x, _activation(act), eps)


@ln_mlp_residual.register_fake
def _(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj, act, eps):
    _activation(act)
    d, h = x.shape[-1], w_fc.shape[-1]
    if tuple(w_fc.shape) != (d, h) or tuple(w_proj.shape) != (h, d):
        raise ValueError("ln_mlp_residual: weight shapes do not match x")
    return torch.empty_like(x)


@torch.library.custom_op("aaclip::ln_mlp_residual_int8", mutates_args=(), device_types="cpu")
def ln_mlp_residual_int8(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_fc_q: Tensor,
                         s_fc: Tensor, b_fc: Tensor, w_proj_q: Tensor, s_proj: Tensor,
                         b_proj: Tensor, act: str, eps: float) -> Tensor:
    from .fused_mlp import ln_mlp_residual_int8_reference

    mlp = {"c_fc": {"w_q": w_fc_q, "scale": s_fc, "b": b_fc},
           "c_proj": {"w_q": w_proj_q, "scale": s_proj, "b": b_proj}}
    return ln_mlp_residual_int8_reference(_ln(ln_scale, ln_bias), mlp, x, _activation(act), eps)


@ln_mlp_residual_int8.register_kernel("cuda")
def _(x, ln_scale, ln_bias, w_fc_q, s_fc, b_fc, w_proj_q, s_proj, b_proj, act, eps):
    from .fused_mlp import _int8_launch

    mlp = {"c_fc": {"w_q": w_fc_q, "scale": s_fc, "b": b_fc},
           "c_proj": {"w_q": w_proj_q, "scale": s_proj, "b": b_proj}}
    return _int8_launch(_ln(ln_scale, ln_bias), mlp, x, _activation(act), eps)


@ln_mlp_residual_int8.register_fake
def _(x, ln_scale, ln_bias, w_fc_q, s_fc, b_fc, w_proj_q, s_proj, b_proj, act, eps):
    from .fused_mlp import hidden_chunk

    _activation(act)
    fn = "ln_mlp_residual_int8"
    d, h = x.shape[-1], w_fc_q.shape[-1]
    if tuple(w_fc_q.shape) != (d, h) or tuple(w_proj_q.shape) != (h, d):
        raise ValueError(f"{fn}: weight shapes do not match x")
    if x.device.type == "cuda":
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{fn}: dtype {x.dtype} not supported (bfloat16)")
        if d % 128 or not hidden_chunk(h):
            raise ValueError(f"{fn}: d={d}, h={h} not supported (d and h multiples of 128)")
    return torch.empty_like(x)


# --------------------------------------------------------------------------
# B7: unpacked flash attention
# --------------------------------------------------------------------------

@torch.library.custom_op("aaclip::flash_mha", mutates_args=(), device_types="cpu")
def flash_mha(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    from .flash_attention import flash_mha_reference

    return flash_mha_reference(q, k, v, scale)


@flash_mha.register_kernel("cuda")
def _(q, k, v, scale):
    from .flash_attention import _launch

    return _launch(q, k, v, scale)


@flash_mha.register_fake
def _(q, k, v, scale):
    if q.device.type == "cuda" and q.shape[-1] != HEAD_DIM:
        raise ValueError(f"flash_mha: head width {q.shape[-1]}; the kernel takes {HEAD_DIM}")
    return torch.empty_like(q)


# --------------------------------------------------------------------------
# B8: the fused attention half-block, and its halves alone
# --------------------------------------------------------------------------

def _attn_params(w_qkv, b_qkv, w_out, b_out):
    return {"qkv": {"w": w_qkv, "b": b_qkv}, "out": {"w": w_out, "b": b_out}}


@torch.library.custom_op("aaclip::ln_attn_residual", mutates_args=(), device_types="cpu")
def ln_attn_residual(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_qkv: Tensor,
                     b_qkv: Tensor, w_out: Tensor, b_out: Tensor, num_heads: int, vv: bool,
                     valid_len: Optional[int], eps: float) -> Tensor:
    from .attn_block import ln_attn_residual_reference

    return ln_attn_residual_reference(_ln(ln_scale, ln_bias),
                                      _attn_params(w_qkv, b_qkv, w_out, b_out), x,
                                      num_heads, vv, valid_len, eps)


@ln_attn_residual.register_kernel("cuda")
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads, vv, valid_len, eps):
    from .attn_block import _launch

    return _launch(_ln(ln_scale, ln_bias), _attn_params(w_qkv, b_qkv, w_out, b_out), x,
                   num_heads, vv, valid_len, eps)


@ln_attn_residual.register_fake
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out, num_heads, vv, valid_len, eps):
    from .attn_block import ln_attn_residual_ok

    if x.device.type == "cuda":
        if not ln_attn_residual_ok(x, _attn_params(w_qkv, b_qkv, w_out, b_out), num_heads):
            raise ValueError("ln_attn_residual: the call fails ln_attn_residual_ok (bf16 "
                             "(B, L, d) x, float square projections, whole heads in "
                             "128-column panels)")
        _cuda_head_width("ln_attn_residual", x, x.shape[-1], num_heads)
    return torch.empty_like(x)


def _cuda_half(fn: str, x: Tensor, w: Tensor, cols: int) -> None:
    """The halves' limits on the card: bf16 x of a width d that is a
    multiple of 128, and a (d, cols) weight."""
    d = x.shape[-1]
    if x.device.type == "cuda" and (x.dtype != torch.bfloat16 or d % 128):
        raise ValueError(f"{fn}: takes bf16 x of a width that is a multiple of 128; got "
                         f"{tuple(x.shape)} {x.dtype}")
    if tuple(w.shape) != (d, cols):
        raise ValueError(f"{fn}: weight {tuple(w.shape)} for width {d}")


@torch.library.custom_op("aaclip::ln_attn_front", mutates_args=(), device_types="cpu")
def ln_attn_front(x: Tensor, ln_scale: Tensor, ln_bias: Tensor, w_qkv: Tensor, b_qkv: Tensor,
                  eps: float) -> Tensor:
    from .attn_block import ln_attn_front_reference

    return ln_attn_front_reference(_ln(ln_scale, ln_bias), {"w": w_qkv, "b": b_qkv}, x, eps)


@ln_attn_front.register_kernel("cuda")
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, eps):
    from .attn_block import _launch_front

    return _launch_front(_ln(ln_scale, ln_bias), {"w": w_qkv, "b": b_qkv}, x, eps)


@ln_attn_front.register_fake
def _(x, ln_scale, ln_bias, w_qkv, b_qkv, eps):
    d = x.shape[-1]
    _cuda_half("ln_attn_front", x, w_qkv, 3 * d)
    return x.new_empty((*x.shape[:-1], 3 * d))


@torch.library.custom_op("aaclip::ln_attn_back", mutates_args=(), device_types="cpu")
def ln_attn_back(o: Tensor, x: Tensor, w_out: Tensor, b_out: Tensor) -> Tensor:
    from .attn_block import ln_attn_back_reference

    return ln_attn_back_reference({"w": w_out, "b": b_out}, o, x)


@ln_attn_back.register_kernel("cuda")
def _(o, x, w_out, b_out):
    from .attn_block import _launch_back

    return _launch_back({"w": w_out, "b": b_out}, o, x)


@ln_attn_back.register_fake
def _(o, x, w_out, b_out):
    _cuda_half("ln_attn_back", x, w_out, x.shape[-1])
    if o.shape != x.shape:
        raise ValueError(f"ln_attn_back: o {tuple(o.shape)} for x {tuple(x.shape)}")
    return torch.empty_like(x)


# --------------------------------------------------------------------------
# cuBLAS's bf16 projection with a float32 output, for traces
# --------------------------------------------------------------------------

@torch.library.custom_op("aaclip::addmm_f32", mutates_args=(), device_types="cuda")
def addmm_f32(b: Tensor, x: Tensor, w: Tensor) -> Tensor:
    """b + x @ w, the float32 bias joining the float32 accumulator, returned
    in float32 (``torch.addmm(..., out_dtype=torch.float32)``)."""
    return torch.addmm(b, x, w, out_dtype=torch.float32)


@addmm_f32.register_fake
def _(b, x, w):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32)
