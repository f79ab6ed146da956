"""Packed-qkv self-attention: the Hopper kernels and their plain twins.

Counterpart of ``flash_mha_packed`` in
``aa_clip_iqm_tpu/ops/pallas_attention.py``: the forward kernel
``_row_kernel_grouped`` and the backward kernel ``_bwd_kernel_grouped``. The
kernels live in ``csrc/packed_attention.cu`` and
``csrc/packed_attention_bwd.cu``; see their headers for the designs. On a CPU
tensor :func:`flash_mha_packed` runs the plain twin
:func:`flash_mha_packed_reference` and its gradient is
:func:`flash_mha_packed_bwd_reference`; on a CUDA tensor both directions
launch a kernel or raise. The backward of the value-value variant
(``vv=True``) has no kernel yet: on a CUDA tensor it raises
``NotImplementedError``, on the CPU it runs the plain version.

The tower is not padded: the kernels mask the ragged key tail themselves, and
still honour an explicit ``valid_len`` (keys at or past it are masked).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: Forward-kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0
#: Backward-kernel launches since the last reset.
BWD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The one head width the kernel is built for (ViT-L: 16 heads of 64).
HEAD_DIM = 64


def reset_launches() -> None:
    global LAUNCHES, BWD_LAUNCHES
    LAUNCHES = 0
    BWD_LAUNCHES = 0


def flash_mha_packed_reference(qkv, num_heads: int, scale: float,
                               vv: bool = False, valid_len=None):
    """Plain PyTorch twin: a transcription of ``_packed_reference``
    (pallas_attention.py:615). qkv (B, L, 3W) -> (B, L, W)."""
    from .attention import sdpa  # here: attention imports this module

    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads
    q, k, v = qkv.split(w, dim=-1)
    if vv:
        q = k = v

    def split(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    mask = None
    if valid_len is not None and valid_len < l:
        keys = torch.arange(l, device=qkv.device)
        mask = torch.where(keys < valid_len, 0.0, float("-inf"))[None, :]
    out = sdpa(split(q), split(k), split(v), scale, mask)
    return out.transpose(1, 2).reshape(b, l, w)


def _lib():
    lib = _build.load("packed_attention")
    fn = lib.aaclip_packed_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_qkv(fn: str, qkv, num_heads: int, valid_len):
    """What both kernels ask of a CUDA qkv; returns (B, L, W, hd, valid_len)."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{fn}: dtype {qkv.dtype} not supported "
                        "(bfloat16 or float32)")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"{fn}: qkv must be a contiguous (B, L, 3W)"
                         f" tensor, got shape {tuple(qkv.shape)}")
    b, l, threew = qkv.shape
    w = threew // 3
    if threew % 3 or w % num_heads or w % 8:
        raise ValueError(f"{fn}: width {threew} does not split "
                         f"into 3 x {num_heads} heads")
    hd = w // num_heads
    if hd != HEAD_DIM:
        raise ValueError(f"{fn}: head width {hd}; the kernel "
                         f"takes {HEAD_DIM}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{fn}: qkv must be 16-byte aligned")
    vl = l if valid_len is None else int(valid_len)
    if vl <= 0:
        raise ValueError(f"{fn}: valid_len {vl} must be positive")
    return b, l, w, hd, vl


def _forward(qkv, num_heads: int, scale: float, vv: bool, valid_len):
    """The forward without autograd: twin on the CPU, kernel on the card."""
    if qkv.device.type == "cpu":
        return flash_mha_packed_reference(qkv, num_heads, scale, vv, valid_len)
    b, l, w, hd, vl = _check_qkv("flash_mha_packed", qkv, num_heads, valid_len)
    out = torch.empty((b, l, w), dtype=qkv.dtype, device=qkv.device)
    err = _lib()(qkv.data_ptr(), out.data_ptr(), b, l, w, num_heads, hd, vl,
                 float(scale), int(bool(vv)), _DTYPES[qkv.dtype],
                 _build.stream_ptr(qkv.device))
    _build.check("packed_attention", err)
    global LAUNCHES
    LAUNCHES += 1
    return out


# --------------------------------------------------------------------------
# Backward
# --------------------------------------------------------------------------

def flash_mha_packed_bwd_reference(qkv, dO, num_heads: int, scale: float,
                                   vv: bool = False, valid_len=None):
    """Plain PyTorch gradient of :func:`flash_mha_packed_reference` with
    respect to qkv, step by step as ``_bwd_kernel_grouped``
    (pallas_attention.py:332) and, for ``vv``, ``_vv_bwd_kernel_grouped``
    (:400), with whole rows where those walk q-blocks: the scores and the
    softmax in float32, P and dS rounded to the input dtype before their
    products, q scaled before the scores and dQ after, dK and dV accumulated
    in float32 and rounded once. qkv (B, L, 3W), dO (B, L, W) -> (B, L, 3W).
    """
    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads
    dt = qkv.dtype

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    def merge(t):
        return t.transpose(1, 2).reshape(b, l, w).to(dt)

    def rounded(t):
        return t.to(dt).float()

    q, k, v = (heads(t) for t in qkv.split(w, dim=-1))
    g = rounded(heads(dO).float())
    if vv:
        q = k = v
    qs = q.float() * scale
    s = torch.matmul(qs, k.float().transpose(-1, -2))
    if valid_len is not None and valid_len < l:
        keys = torch.arange(l, device=qkv.device)
        s = s + torch.where(keys < valid_len, 0.0, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    d_val = torch.matmul(rounded(p).transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    d_row = (p * dp).sum(dim=-1, keepdim=True)
    dsb = rounded(p * (dp - d_row))
    if vv:
        a = v.float()
        d_a = (d_val + torch.matmul(dsb, a) * scale
               + torch.matmul(dsb.transpose(-1, -2), a) * scale)
        zeros = qkv.new_zeros((b, l, 2 * w))
        return torch.cat([zeros, merge(d_a)], dim=-1)
    d_q = torch.matmul(dsb, k.float()) * scale
    d_k = torch.matmul(dsb.transpose(-1, -2), rounded(qs))
    return torch.cat([merge(d_q), merge(d_k), merge(d_val)], dim=-1)


def _bwd_lib():
    lib = _build.load("packed_attention_bwd")
    fn = lib.aaclip_packed_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def flash_mha_packed_bwd(qkv, dO, num_heads: int, scale: float,
                         vv: bool = False, valid_len=None):
    """dqkv (B, L, 3W) from qkv (B, L, 3W) and dO (B, L, W): the plain version
    on CPU tensors, the kernel on CUDA tensors. The value-value variant has
    no kernel yet (``_vv_bwd_kernel_grouped``, pallas_attention.py:400, is
    still to port) and raises on a CUDA tensor."""
    if qkv.device.type == "cpu":
        return flash_mha_packed_bwd_reference(qkv, dO, num_heads, scale, vv,
                                              valid_len)
    fn = "flash_mha_packed_bwd"
    b, l, w, hd, vl = _check_qkv(fn, qkv, num_heads, valid_len)
    if vv:
        raise NotImplementedError(
            f"{fn}: the backward of value-value attention (vv=True) has no "
            "CUDA kernel yet (_vv_bwd_kernel_grouped, pallas_attention.py:400,"
            " is still to port); run it on CPU tensors or keep the surgery "
            "tower out of the gradient")
    if dO.device != qkv.device or dO.dtype != qkv.dtype:
        raise TypeError(f"{fn}: dO is {dO.dtype} on {dO.device}, qkv "
                        f"{qkv.dtype} on {qkv.device}")
    if tuple(dO.shape) != (b, l, w) or not dO.is_contiguous() or dO.data_ptr() % 16:
        raise ValueError(f"{fn}: dO must be a contiguous, 16-byte aligned "
                         f"{(b, l, w)} tensor, got {tuple(dO.shape)}")
    dqkv = torch.empty_like(qkv)
    # Row statistics of the recomputed softmax, written by the first kernel
    # and read by the second: log-sum-exp and D = rowsum(P * dP), float32.
    stats = torch.empty((2, b, num_heads, l), dtype=torch.float32,
                        device=qkv.device)
    err = _bwd_lib()(qkv.data_ptr(), dO.data_ptr(), dqkv.data_ptr(),
                     stats[0].data_ptr(), stats[1].data_ptr(), b, l, w,
                     num_heads, hd, vl, float(scale), _DTYPES[qkv.dtype],
                     _build.stream_ptr(qkv.device))
    _build.check("packed_attention_bwd", err)
    global BWD_LAUNCHES
    BWD_LAUNCHES += 1
    return dqkv


class _FlashMhaPacked(torch.autograd.Function):
    """Forward: the packed-attention kernel (twin on the CPU), saving qkv.
    Backward: :func:`flash_mha_packed_bwd`."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, vv, valid_len):
        ctx.save_for_backward(qkv)
        ctx.args = (num_heads, scale, vv, valid_len)
        return _forward(qkv, num_heads, scale, vv, valid_len)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        return (flash_mha_packed_bwd(qkv, g.contiguous(), *ctx.args),
                None, None, None, None)


def flash_mha_packed(qkv, num_heads: int, scale: float, vv: bool = False,
                     valid_len=None):
    """Attention straight off the packed qkv projection, differentiable in
    qkv.

    qkv: (B, L, 3W), bf16 or fp32. Returns (B, L, W) in merged-head layout.
    ``vv`` points q, k and v at the value columns (CLIP-Surgery value-value
    attention). ``valid_len``: keys at or past it are masked.
    """
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FlashMhaPacked.apply(qkv, num_heads, scale, bool(vv), valid_len)
    return _forward(qkv, num_heads, scale, vv, valid_len)
