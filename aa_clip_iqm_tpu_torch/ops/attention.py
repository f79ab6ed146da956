"""Multi-head attention ops: plain path + the packed-qkv kernel.

Counterpart of ``aa_clip_iqm_tpu/ops/attention.py``. Weight layout: packed
qkv stored transposed for right-multiplication,
    params = {"qkv": {"w": (d, 3d), "b": (3d,)}, "out": {"w": (d, d), "b": (d,)}}

Self-attention routes as the JAX package's ``use_pallas`` path does: where
:func:`packed_ok` holds (no mask, 256 to ``ROW_KERNEL_MAX_TOKENS`` tokens,
whole heads in 128-column panels or heads of 112) through
:func:`.packed_attention.flash_mha_packed` (B1) straight off the packed
projection, otherwise through :func:`.flash_attention.flash_mha` on split
heads (B7 above ``ROW_KERNEL_MAX_TOKENS`` tokens or with an odd head layout;
the plain ``sdpa`` with a mask or below 256 tokens). Each kernel wrapper runs
its plain twin on a CPU tensor. The IQM cross-attention stays plain, as in
the JAX package.

``use_pallas=False`` is the JAX package's XLA route on stock PyTorch calls:
the projections on cuBLAS and :func:`library_sdpa` (PyTorch's
``scaled_dot_product_attention`` on the card, :func:`sdpa` on the CPU), no
hand-written kernel. The port's default is ``True``, where JAX's is
``False``: the port's main path runs its kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import flash_attention
from .flash_attention import flash_mha
from .layers import linear
from .packed_attention import WIDE_HEAD_DIM, flash_mha_packed


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


def library_sdpa(q, k, v, scale, attn_mask=None):
    """The stock attention call of the ``use_pallas=False`` route: PyTorch's
    ``scaled_dot_product_attention`` on a CUDA tensor (the additive mask cast
    to q's dtype), the plain :func:`sdpa` elsewhere."""
    if not q.is_cuda:
        return sdpa(q, k, v, scale, attn_mask)
    if attn_mask is not None:
        attn_mask = attn_mask.to(q.dtype)
    return F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, scale=scale)


def packed_ok(x, num_heads: int, attn_mask, width=None) -> bool:
    """Whether the packed kernel takes this call: ``_packed_pallas_ok``
    (attention.py:56) without its backend test. No mask, at least
    ``2 * BLK_Q`` and at most ``ROW_KERNEL_MAX_TOKENS`` tokens, and whole
    heads in 128-column panels, or heads of 112 (B1's second instance,
    which JAX's TPU kernel has not). ``width``: the attention's width, the
    heads' columns (x's width unless the heads are a tensor-parallel
    share)."""
    l = x.shape[1]
    w = x.shape[-1] if width is None else width
    if (attn_mask is not None or l < 2 * flash_attention.BLK_Q
            or l > flash_attention.ROW_KERNEL_MAX_TOKENS or w % num_heads):
        return False
    hd = w // num_heads
    group = max(1, 128 // hd)
    return hd == WIDE_HEAD_DIM or ((group * hd) % 128 == 0 and num_heads % group == 0)


def attention_width(params) -> int:
    """Columns of the heads that ``params["qkv"]`` projects to (a third of
    its output): the model width, or a tensor-parallel rank's share of it."""
    qkv = params["qkv"]
    return (qkv["w"] if "w" in qkv else qkv["w_q"]).shape[-1] // 3


def mha_heads(params, x, num_heads: int, attn_mask=None, valid_len=None,
              use_pallas: bool = True):
    """Self-attention of the ``num_heads`` heads that ``params["qkv"]``
    projects to, before the out-projection: (B, L, num_heads * head width)
    in merged-head layout. The packed kernel straight off the packed
    projection where :func:`packed_ok` holds (``valid_len`` masks keys at or
    past it), else ``flash_mha`` on split heads; ``use_pallas=False``:
    :func:`library_sdpa` on split heads, as JAX's XLA route (which, like
    JAX's, takes no ``valid_len``)."""
    return attend_qkv(linear(params["qkv"], x), num_heads, attn_mask=attn_mask,
                      valid_len=valid_len, use_pallas=use_pallas)


def attend_qkv(qkv, num_heads: int, attn_mask=None, valid_len=None, use_pallas: bool = True):
    """Self-attention on a packed projection ``qkv`` (B, L, 3w), in
    merged-head layout (B, L, w): :func:`mha_heads`' route after its
    projection (the packed kernel where :func:`packed_ok` holds, else split
    heads)."""
    width = qkv.shape[-1] // 3
    scale = (width // num_heads) ** -0.5
    if use_pallas and packed_ok(qkv, num_heads, attn_mask, width):
        return flash_mha_packed(qkv, num_heads, scale, valid_len=valid_len)
    qh, kh, vh = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    attend = flash_mha if use_pallas else library_sdpa
    return _merge_heads(attend(qh, kh, vh, scale, attn_mask=attn_mask))


def mha(params, x, num_heads: int, attn_mask=None, valid_len=None,
        use_pallas: bool = True):
    """Self-attention block core (torch MultiheadAttention parity):
    :func:`mha_heads`, then the out-projection."""
    return linear(params["out"], mha_heads(params, x, num_heads, attn_mask=attn_mask,
                                           valid_len=valid_len, use_pallas=use_pallas))


def vv_heads(params, x, num_heads: int, valid_len=None, use_pallas: bool = True):
    """CLIP-Surgery value-value attention (q = k = v) over the token axis of
    the ``num_heads`` heads ``params["qkv"]`` projects to, before the
    out-projection: the packed kernel with ``vv=True`` where
    :func:`packed_ok` holds, else ``flash_mha`` on the split value heads
    (:func:`library_sdpa` with ``use_pallas=False``)."""
    width = attention_width(params)
    scale = (width // num_heads) ** -0.5
    if use_pallas and packed_ok(x, num_heads, None, width):
        qkv = linear(params["qkv"], x)
        return flash_mha_packed(qkv, num_heads, scale, vv=True, valid_len=valid_len)
    _, _, v = qkv_project(params, x)
    vh = _split_heads(v, num_heads)
    attend = flash_mha if use_pallas else library_sdpa
    return _merge_heads(attend(vh, vh, vh, scale))


def vv_attention(params, x, num_heads: int, valid_len=None, use_pallas: bool = True):
    """:func:`vv_heads`, then the out-projection."""
    return linear(params["out"], vv_heads(params, x, num_heads, valid_len=valid_len,
                                          use_pallas=use_pallas))


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
