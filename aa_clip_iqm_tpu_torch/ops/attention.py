"""Multi-head attention ops: plain path + the packed-qkv kernel.

Counterpart of ``aa_clip_iqm_tpu/ops/attention.py``. Weight layout: packed
qkv stored transposed for right-multiplication,
    params = {"qkv": {"w": (d, 3d), "b": (3d,)}, "out": {"w": (d, d), "b": (d,)}}

Self-attention routes as the JAX package's ``use_pallas`` path does: where
:func:`packed_ok` holds (no mask, 256 to ``ROW_KERNEL_MAX_TOKENS`` tokens,
whole heads in 128-column panels) through
:func:`.packed_attention.flash_mha_packed` (B1) straight off the packed
projection, otherwise through :func:`.flash_attention.flash_mha` on split
heads (B7 above ``ROW_KERNEL_MAX_TOKENS`` tokens or with an odd head layout;
the plain ``sdpa`` with a mask or below 256 tokens). Each kernel wrapper runs
its plain twin on a CPU tensor. The IQM cross-attention stays plain, as in
the JAX package.
"""
from __future__ import annotations

import torch

from . import flash_attention
from .flash_attention import flash_mha
from .layers import linear
from .packed_attention import flash_mha_packed


def _split_heads(x, num_heads):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, l, hd = x.shape
    return x.transpose(1, 2).reshape(b, l, h * hd)


def qkv_project(params, x):
    y = linear(params["qkv"], x)
    return y.chunk(3, dim=-1)


def sdpa(q, k, v, scale, attn_mask=None):
    """Scaled dot-product attention, q/k/v (B, H, L, hd): fp32 logits and
    softmax, probabilities cast to v's dtype, fp32 accumulation.
    attn_mask: additive (Lq, Lk) or broadcastable."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if attn_mask is not None:
        logits = logits + attn_mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def packed_ok(x, num_heads: int, attn_mask) -> bool:
    """Whether the packed kernel takes this call: ``_packed_pallas_ok``
    (attention.py:56) without its backend test. No mask, at least
    ``2 * BLK_Q`` and at most ``ROW_KERNEL_MAX_TOKENS`` tokens, and whole
    heads in 128-column panels."""
    l, w = x.shape[1], x.shape[-1]
    if (attn_mask is not None or l < 2 * flash_attention.BLK_Q
            or l > flash_attention.ROW_KERNEL_MAX_TOKENS or w % num_heads):
        return False
    hd = w // num_heads
    group = max(1, 128 // hd)
    return (group * hd) % 128 == 0 and num_heads % group == 0


def mha(params, x, num_heads: int, attn_mask=None, valid_len=None):
    """Self-attention block core (torch MultiheadAttention parity): the packed
    kernel straight off the packed projection where :func:`packed_ok` holds
    (``valid_len`` masks keys at or past it), else ``flash_mha`` on split
    heads."""
    hd = x.shape[-1] // num_heads
    scale = hd ** -0.5
    if packed_ok(x, num_heads, attn_mask):
        qkv = linear(params["qkv"], x)
        out = flash_mha_packed(qkv, num_heads, scale, valid_len=valid_len)
        return linear(params["out"], out)
    q, k, v = qkv_project(params, x)
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    out = flash_mha(qh, kh, vh, scale, attn_mask=attn_mask)
    return linear(params["out"], _merge_heads(out))


def vv_attention(params, x, num_heads: int, valid_len=None):
    """CLIP-Surgery value-value attention (q = k = v) over the token axis:
    the packed kernel with ``vv=True`` where :func:`packed_ok` holds, else
    ``flash_mha`` on the split value heads."""
    hd = x.shape[-1] // num_heads
    scale = hd ** -0.5
    if packed_ok(x, num_heads, None):
        qkv = linear(params["qkv"], x)
        out = flash_mha_packed(qkv, num_heads, scale, vv=True, valid_len=valid_len)
        return linear(params["out"], out)
    _, _, v = qkv_project(params, x)
    vh = _split_heads(v, num_heads)
    out = flash_mha(vh, vh, vh, scale)
    return linear(params["out"], _merge_heads(out))


def vv_attention_batch_axis(params, x, num_heads: int):
    """The executed reference's surgery attention: at every token index,
    each sample's value heads attend over the samples of the batch (the
    reference's custom attention unpacks B, N, C from an (L, N, C) input).
    It depends on the batch's composition, so the shipped pipeline never
    uses it; it is here to reproduce the reference's stage-1 features. Plain
    PyTorch on every device: B1 attends over the token axis, which is not
    this."""
    _, _, v = qkv_project(params, x)                     # (B, L, d)
    hd = x.shape[-1] // num_heads
    vh = _split_heads(v, num_heads).float()              # (B, H, L, hd)
    logits = torch.einsum("bhld,chld->lhbc", vh, vh) * hd ** -0.5
    attn = torch.softmax(logits, dim=-1)                 # (L, H, B, B)
    out = torch.einsum("lhbc,chld->bhld", attn, vh).to(v.dtype)
    return linear(params["out"], _merge_heads(out))


def causal_mask(length: int, dtype=torch.float32, device=None):
    """Additive causal mask (upper-triangular -inf)."""
    mask = torch.full((length, length), float("-inf"), dtype=dtype, device=device)
    return torch.triu(mask, diagonal=1)


def cross_attention(params, q_in, kv_in, num_heads: int, attn_mask=None):
    """Separate q/k/v projections (used by IQM).

    params: {"q": {...}, "k": {...}, "v": {...}}. Returns merged heads.
    """
    q = linear(params["q"], q_in)
    k = linear(params["k"], kv_in)
    v = linear(params["v"], kv_in)
    hd = q.shape[-1] // num_heads
    out = sdpa(_split_heads(q, num_heads), _split_heads(k, num_heads),
               _split_heads(v, num_heads), hd ** -0.5, attn_mask)
    return _merge_heads(out)
