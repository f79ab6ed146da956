"""Unpacked (B, H, L, hd) flash attention: the Hopper kernel and its plain twin.

Counterpart of ``flash_mha`` in ``aa_clip_iqm_tpu/ops/pallas_attention.py``
(``_flash_forward`` with its two TPU kernels: ``_row_kernel``, a whole-row
softmax while the padded length is at most ``ROW_KERNEL_MAX_TOKENS``, and
``_flash_kernel``, an online softmax over key blocks above it). On Hopper one
online-softmax kernel, ``csrc/flash_attention.cu``, covers both lengths: the
split on the TPU is a VMEM budget, and a Hopper block holds neither (L, L)
row. ``ROW_KERNEL_MAX_TOKENS`` is kept as the JAX constant (tests lower it
on both sides as the JAX tests do); it selects nothing here.

On a CPU tensor :func:`flash_mha` runs the plain twin
:func:`flash_mha_reference`; on a CUDA tensor it launches the kernel or
raises, through the custom op ``aaclip::flash_mha`` (``ops/custom_ops.py``;
its CUDA implementation is :func:`_launch`). As in JAX, an additive mask or fewer than ``2 * BLK_Q`` tokens take
the plain ``sdpa`` on any device. The gradient is autograd through the plain
recompute, as JAX's ``_bwd`` (pallas_attention.py:215) is an XLA recompute:
there is no backward kernel to port.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, custom_ops

#: Query rows of one TPU program; below 2 * BLK_Q tokens ``flash_mha`` takes
#: the plain ``sdpa``, as in JAX.
BLK_Q = 128
#: The TPU's row/online kernel split (pallas_attention.py:150); kept for the
#: tests, which lower it on both sides. The Hopper kernel is the same below
#: and above it.
ROW_KERNEL_MAX_TOKENS = 8192
#: The one head width the kernel is built for (ViT-L: 16 heads of 64).
HEAD_DIM = 64
#: Keys per tile of the bf16 walk (``csrc/attention_fwd.cuh``): the TPU
#: online kernel's ``blk_k`` (pallas_attention.py:157).
TILE_KEYS = 128
LOG2E = 1.4426950408889634

#: Kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flash_mha_reference(q, k, v, scale: float):
    """Plain PyTorch twin, ``_reference_sdpa`` (pallas_attention.py:196) on
    (..., L, hd) tensors: the unmasked ``sdpa``."""
    from .attention import sdpa  # here: attention imports this module

    return sdpa(q, k, v, scale)


def attention_fwd_stages(q, k, v, scale: float, n_keys=None, with_lse: bool = False):
    """The plain version of the kernel's tile walk (``csrc/attention_fwd.cuh``,
    the bf16 path shared by B1, B7 and B8's attention stage), rounding where
    it rounds: over tiles of ``TILE_KEYS`` keys, S = Q K^T in fp32 with keys
    at or past ``n_keys`` masked, the running max m of S scale log2 e,
    alpha = 2^(m_old - m_new), P = 2^(S scale log2 e - m_new) summed in fp32 and
    rounded to the input dtype before P V (fp32 accumulation, O rescaled by
    alpha), and O times 1 / l rounded once. q, k, v (BH, L, hd) -> (BH, L,
    hd); with ``with_lse`` also each row's natural-log log-sum-exp m ln 2 +
    log(l), (BH, L) fp32."""
    bh, l, hd = q.shape
    n = l if n_keys is None else min(int(n_keys), l)
    dt = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full((bh, l, 1), float("-inf"), device=q.device)
    lsum = torch.zeros((bh, l, 1), device=q.device)
    acc = torch.zeros((bh, l, hd), device=q.device)
    for k0 in range(0, n, TILE_KEYS):
        k1 = min(k0 + TILE_KEYS, l)   # the kernel's rows past L are masked keys
        s = torch.matmul(qf, kf[:, k0:k1].transpose(-1, -2))
        if k1 > n:
            s[..., n - k0:] = float("-inf")
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * (scale * LOG2E))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * (scale * LOG2E) - m_new)
        lsum = lsum * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(dt).float(), vf[:, k0:k1])
        m = m_new
    out = (acc * (1.0 / lsum)).to(dt)
    if with_lse:
        return out, (m * math.log(2.0) + torch.log(lsum)).squeeze(-1)
    return out


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.aaclip_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _forward(q, k, v, scale: float):
    """(BH, L, hd) attention without autograd, through ``aaclip::flash_mha``:
    the twin on the CPU, the kernel on the card."""
    custom_ops.check_device("flash_mha", q)
    return custom_ops.flash_mha(q, k, v, float(scale))


def _launch(q, k, v, scale: float):
    """The kernel on CUDA q, k, v (the CUDA implementation of the op)."""
    fn = "flash_mha"
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {q.dtype} not supported (bfloat16 or float32)")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{fn}: {name} is {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}, q {q.dtype} {tuple(q.shape)} on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")
    bh, l, hd = q.shape
    if hd != HEAD_DIM:
        raise ValueError(f"{fn}: head width {hd}; the kernel takes {HEAD_DIM}")
    out = torch.empty_like(q)
    err = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, l,
                 hd, float(scale), _DTYPES[q.dtype], _build.stream_ptr(q.device))
    _build.check("flash_attention", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel (twin on the CPU). Backward: autograd through the
    plain recompute, as JAX's ``_bwd`` (pallas_attention.py:215)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _forward(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flash_mha_reference(*ins, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, ins, g)
        return dq, dk, dv, None


def flash_mha(q, k, v, scale: float, attn_mask=None):
    """(B, H, L, hd) attention, differentiable in q, k and v. Falls back to
    the plain ``sdpa`` when an additive mask is given or for fewer than
    ``2 * BLK_Q`` tokens, as the JAX function does; otherwise the kernel on
    the card, the twin on the CPU."""
    if attn_mask is not None or q.shape[-2] < 2 * BLK_Q:
        from .attention import sdpa

        return sdpa(q, k, v, scale, attn_mask)
    b, h, l, hd = q.shape
    q3 = q.reshape(b * h, l, hd).contiguous()
    # Value-value attention passes one tensor three times: lay it out once.
    k3 = q3 if k is q else k.reshape(b * h, l, hd).contiguous()
    v3 = q3 if v is q else v.reshape(b * h, l, hd).contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q3, k3, v3)):
        out = _FlashAttention.apply(q3, k3, v3, scale)
    else:
        out = _forward(q3, k3, v3, scale)
    return out.reshape(b, h, l, hd)
