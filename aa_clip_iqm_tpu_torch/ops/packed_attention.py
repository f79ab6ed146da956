"""Packed-qkv self-attention: the Hopper kernels and their plain twins.

Counterpart of ``flash_mha_packed`` in
``aa_clip_iqm_tpu/ops/pallas_attention.py``: the forward kernel
``_row_kernel_grouped`` (B1) and the backward kernels ``_bwd_kernel_grouped``
(B4) and, for the value-value variant, ``_vv_bwd_kernel_grouped`` (B6). The
kernels live in ``csrc/packed_attention.cu`` and
``csrc/packed_attention_bwd.cu``; see their headers for the designs. On a CPU
tensor :func:`flash_mha_packed` runs the plain twin
:func:`flash_mha_packed_reference` and its gradient is
:func:`flash_mha_packed_bwd_reference`; on a CUDA tensor both directions
launch a kernel or raise. The forward goes through the custom ops
``aaclip::flash_mha_packed`` and ``aaclip::flash_mha_packed_lse``
(``ops/custom_ops.py``), whose CUDA implementation is :func:`_launch`. When
qkv needs a gradient the forward also returns
each row's log-sum-exp (:func:`packed_lse_reference` is its plain version),
and the backward kernels rebuild P from it instead of sweeping the keys for
the softmax statistics. :func:`flash_mha_packed_stages` and
:func:`flash_mha_packed_bwd_stages` are the plain versions of the forward's
tile walk and of the backward, rounding where the kernels round.

The tower is not padded: the kernels mask the ragged key tail themselves, and
still honour an explicit ``valid_len`` (keys at or past it are masked).
"""
from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from . import _build, custom_ops
from .flash_attention import attention_fwd_stages

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The head width of every kernel here (ViT-L: 16 heads of 64).
HEAD_DIM = 64
#: The forward's second head width, an instance of its own (EVA02-CLIP-E/14+:
#: 16 heads of 112). The backward kernels take :data:`HEAD_DIM` only.
WIDE_HEAD_DIM = 112
#: Its third, an instance of its own too (SigLIP So400m: 16 heads of 72).
HEAD_DIM_72 = 72
FORWARD_HEAD_DIMS = (HEAD_DIM, WIDE_HEAD_DIM, HEAD_DIM_72)


def flash_mha_packed_reference(qkv, num_heads: int, scale: float,
                               vv: bool = False, valid_len=None):
    """Plain PyTorch twin: a transcription of ``_packed_reference``
    (pallas_attention.py:615). qkv (B, L, 3W) -> (B, L, W)."""
    q, k, v = qkv.split(qkv.shape[-1] // 3, dim=-1)
    if vv:
        q = k = v
    return mha_reference(q, k, v, num_heads, scale, valid_len)


def mha_reference(q, k, v, num_heads: int, scale: float, valid_len=None):
    """Plain multi-head attention on merged-head q, k, v (B, L, W) ->
    (B, L, W): ``sdpa`` per head, keys at or past ``valid_len`` masked."""
    from .attention import sdpa  # here: attention imports this module

    b, l, w = q.shape
    hd = w // num_heads

    def split(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    mask = None
    if valid_len is not None and valid_len < l:
        keys = torch.arange(l, device=q.device)
        mask = torch.where(keys < valid_len, 0.0, float("-inf"))[None, :]
    out = sdpa(split(q), split(k), split(v), scale, mask)
    return out.transpose(1, 2).reshape(b, l, w)


def _scores(qkv, num_heads: int, scale: float, vv: bool, valid_len):
    """fp32 scale * Q K^T per head (B, H, L, L), keys at or past
    ``valid_len`` at -inf; and K and V per head (B, H, L, hd)."""
    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(w, dim=-1))
    if vv:
        q = k = v
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if valid_len is not None and valid_len < l:
        keys = torch.arange(l, device=qkv.device)
        s = s + torch.where(keys < valid_len, 0.0, float("-inf"))
    return s, k, v


def packed_lse_reference(qkv, num_heads: int, scale: float, vv: bool = False,
                         valid_len=None):
    """Plain log-sum-exp of each row of the masked scaled scores, what the
    forward kernel writes for the backward: qkv (B, L, 3W) -> (B, H, L)
    fp32."""
    return torch.logsumexp(_scores(qkv, num_heads, scale, vv, valid_len)[0], dim=-1)


def flash_mha_packed_stages(qkv, num_heads: int, scale: float, vv: bool = False,
                            valid_len=None, with_lse: bool = False):
    """The plain version of the forward kernel's tile walk on the packed
    layout (:func:`..flash_attention.attention_fwd_stages` per head, keys at
    or past ``valid_len`` masked): qkv (B, L, 3W) -> (B, L, W); with
    ``with_lse`` also the rows' log-sum-exp (B, H, L) fp32."""
    b, l, threew = qkv.shape
    w = threew // 3
    hd = w // num_heads

    def heads(t):
        return t.reshape(b, l, num_heads, hd).transpose(1, 2).reshape(b * num_heads, l, hd)

    q, k, v = (heads(t) for t in qkv.split(w, dim=-1))
    if vv:
        q = k = v
    out, lse = attention_fwd_stages(q, k, v, scale, valid_len, with_lse=True)
    out = out.reshape(b, num_heads, l, hd).transpose(1, 2).reshape(b, l, w)
    return (out, lse.reshape(b, num_heads, l)) if with_lse else out


_FORWARD = _build.Entry("packed_attention", "packed_attention",
                        [c_void_p] * 3 + [c_int] * 6 + [c_float, c_int, c_int])
# The forward at head width 112, counted ``packed_attention_hd112``.
_FORWARD_HD112 = _build.Entry("packed_attention", "packed_attention_hd112",
                              [c_void_p] * 3 + [c_int] * 6 + [c_float, c_int, c_int])
# The forward at head width 72, counted ``packed_attention_hd72``.
_FORWARD_HD72 = _build.Entry("packed_attention", "packed_attention_hd72",
                             [c_void_p] * 3 + [c_int] * 6 + [c_float, c_int, c_int])
_FORWARDS = {HEAD_DIM: _FORWARD, WIDE_HEAD_DIM: _FORWARD_HD112, HEAD_DIM_72: _FORWARD_HD72}
# B4, counted ``packed_attention_bwd``; for ``vv`` B6, counted
# ``packed_attention_vv_bwd``.
_BACKWARD = _build.Entry("packed_attention_bwd", "packed_attention_bwd",
                         [c_void_p] * 6 + [c_int] * 6 + [c_float, c_int, c_int])


def _check_qkv(fn: str, qkv, num_heads: int, valid_len, head_dims=(HEAD_DIM,)):
    """What the kernels ask of a CUDA qkv, heads of one of ``head_dims``;
    returns (B, L, W, hd, valid_len)."""
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
    if hd not in head_dims:
        raise ValueError(f"{fn}: head width {hd}; the kernel "
                         f"takes {' or '.join(map(str, head_dims))}")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{fn}: qkv must be 16-byte aligned")
    vl = l if valid_len is None else int(valid_len)
    if vl <= 0:
        raise ValueError(f"{fn}: valid_len {vl} must be positive")
    return b, l, w, hd, vl


def _forward(qkv, num_heads: int, scale: float, vv: bool, valid_len,
             with_lse: bool = False):
    """The forward without autograd, through ``aaclip::flash_mha_packed``
    (``aaclip::flash_mha_packed_lse`` with ``with_lse``): the twin on the
    CPU, the kernel on the card. With ``with_lse`` it returns (out, lse),
    lse (B, H, L) fp32."""
    custom_ops.check_device("flash_mha_packed", qkv)
    op = custom_ops.flash_mha_packed_lse if with_lse else custom_ops.flash_mha_packed
    return op(qkv, int(num_heads), float(scale), bool(vv),
              None if valid_len is None else int(valid_len))


def _launch(qkv, num_heads: int, scale: float, vv: bool, valid_len,
            with_lse: bool = False):
    """The kernel on a CUDA qkv (the CUDA implementation of the two ops):
    the instance of the heads' width."""
    b, l, w, hd, vl = _check_qkv("flash_mha_packed", qkv, num_heads, valid_len,
                                 FORWARD_HEAD_DIMS)
    out = torch.empty((b, l, w), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, num_heads, l), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    _FORWARDS[hd](qkv.device, qkv.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(), b, l, w, num_heads, hd, vl,
                  float(scale), int(bool(vv)), _DTYPES[qkv.dtype])
    return (out, lse) if with_lse else out


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


def flash_mha_packed_bwd_stages(qkv, dO, num_heads: int, scale: float, vv: bool = False,
                                valid_len=None, lse=None):
    """The plain version of the backward kernels' stages, rounding where
    they round: P = exp(scale Q K^T - lse) from the forward's log-sum-exp
    (B, H, L), D = rowsum(P * dP) in fp32, P and dS rounded to the input
    dtype before their products, the scale applied to the fp32 products (S,
    dQ, dK); for ``vv`` the three terms of dA summed in fp32 and rounded
    once, zeros in the q and k columns. qkv (B, L, 3W), dO (B, L, W) ->
    (B, L, 3W)."""
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

    s, k, v = _scores(qkv, num_heads, scale, vv, valid_len)
    q = v if vv else heads(qkv[..., :w])
    g = heads(dO.to(dt)).float()
    p = torch.exp(s - lse.float()[..., None])
    d_val = torch.matmul(rounded(p).transpose(-1, -2), g)
    dp = torch.matmul(g, v.float().transpose(-1, -2))
    dsb = rounded(p * (dp - (p * dp).sum(dim=-1, keepdim=True)))
    if vv:
        a = v.float()
        d_a = (d_val + torch.matmul(dsb, a) * scale
               + torch.matmul(dsb.transpose(-1, -2), a) * scale)
        return torch.cat([qkv.new_zeros((b, l, 2 * w)), merge(d_a)], dim=-1)
    d_q = torch.matmul(dsb, k.float()) * scale
    d_k = torch.matmul(dsb.transpose(-1, -2), q.float()) * scale
    return torch.cat([merge(d_q), merge(d_k), merge(d_val)], dim=-1)


def flash_mha_packed_bwd(qkv, dO, num_heads: int, scale: float, vv: bool = False,
                         valid_len=None, lse=None):
    """dqkv (B, L, 3W) from qkv (B, L, 3W) and dO (B, L, W): the plain
    version on CPU tensors (``lse`` unread), the kernels on CUDA tensors (B4,
    or B6 for ``vv``, whose q and k columns come out zero), which need the
    forward's log-sum-exp ``lse`` (B, H, L) fp32: they launch no forward of
    their own."""
    if qkv.device.type == "cpu":
        return flash_mha_packed_bwd_reference(qkv, dO, num_heads, scale, vv,
                                              valid_len)
    fn = "flash_mha_packed_bwd"
    b, l, w, hd, vl = _check_qkv(fn, qkv, num_heads, valid_len)
    if lse is None:
        raise ValueError(f"{fn}: the kernels need the forward's lse")
    for name, t, dtype, shape in (("dO", dO, qkv.dtype, (b, l, w)),
                                  ("lse", lse, torch.float32, (b, num_heads, l))):
        if t.device != qkv.device or t.dtype != dtype:
            raise TypeError(f"{fn}: {name} is {t.dtype} on {t.device}, want {dtype} "
                            f"on {qkv.device}")
        if tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} must be a contiguous, 16-byte aligned "
                             f"{shape} tensor, got {tuple(t.shape)}")
    dqkv = torch.empty_like(qkv)
    # Each query's {lse log2 e, D}, from the dq kernel to the dk/dv kernel,
    # over L rounded up to 64 (past L: {inf, 0}).
    stats = torch.empty((b, num_heads, -(-l // 64) * 64, 2), dtype=torch.float32,
                        device=qkv.device)
    # vv: the query term of dA per token, float32, from the dq kernel to the
    # dk/dv kernel, which adds the value and key terms and rounds once.
    qterm = (torch.empty((b, l, w), dtype=torch.float32, device=qkv.device)
             if vv else None)
    _BACKWARD(qkv.device, qkv.data_ptr(), dO.data_ptr(), lse.data_ptr(), dqkv.data_ptr(),
              stats.data_ptr(), None if qterm is None else qterm.data_ptr(), b, l, w, num_heads,
              hd, vl, float(scale), int(bool(vv)), _DTYPES[qkv.dtype],
              counter="packed_attention_vv_bwd" if vv else None)
    return dqkv


class _FlashMhaPacked(torch.autograd.Function):
    """Forward: the packed-attention kernel (twin on the CPU), saving qkv and
    the rows' log-sum-exp. Backward: :func:`flash_mha_packed_bwd`."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, vv, valid_len):
        out, lse = _forward(qkv, num_heads, scale, vv, valid_len, with_lse=True)
        ctx.save_for_backward(qkv, lse)
        ctx.args = (num_heads, scale, vv, valid_len)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, lse = ctx.saved_tensors
        return (flash_mha_packed_bwd(qkv, g.contiguous(), *ctx.args, lse=lse),
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
