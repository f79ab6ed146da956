"""The plain reference of EVA02-CLIP's vision tower under AA-CLIP, in float32.

Written from the published description: EVA-CLIP (Sun et al., arXiv
2303.15389) and its configuration ``EVA02-CLIP-L-14-336.json``
(baaivision/EVA, ``EVA-CLIP/rei/eva_clip/model_configs/``), whose vision
tower is EVA-02's (arXiv 2303.11331; timm's ``eva02_large_patch14_clip_336``):

- a patch embedding with a bias, a class token, an absolute positional
  embedding, and no LayerNorm before the blocks;
- blocks of ``x + proj(LN_attn(attn(LN1 x)))`` then ``x + W3(LN_ffn(SiLU(W1
  LN2 x) * W2 LN2 x))``, every LayerNorm of eps 1e-6; q and v with a bias, k
  without one; 2-D rotary embedding (``VisionRotaryEmbeddingFast`` with
  ``pt_hw_seq_len`` 16 and ``intp_freq``) of the patch rows' q and k, the
  class row left out;
- the final ``norm`` (the taps' and the pooled token's LayerNorm, AA-CLIP's
  ln_post) and a ``head`` with a bias.

It reads the program's parameter layout (a linear weight stored (in, out);
the packed q/k/v weight ``attn.qkv.w`` with its q and v biases apart,
``attn.q.b`` and ``attn.v.b``) and upcasts every weight to float32; it
imports nothing of the program. The text tower, the anchors, the trained
heads, IQM and the scoring are AA-CLIP's on ViT-L's text tower:
``reference/model.py``'s, reused as they are. :func:`in_clips_place` puts
this tower where ``model.predict`` looks its tower up.

Departures from the published description: none in the vision tower. The
text tower's GELU is exact (assumed: the EVA-CLIP configuration sets no
QuickGELU, and ``reference/model.py``'s tower is exact).
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from . import model
from .model import attention, blend, f32, leaky, lin, ln, matmul

EPS = 1e-6
ROPE_THETA = 10000.0


def rope_cos_sin(grid: int, ref_grid: int, head_dim: int, device=None):
    """(cos, sin), each (grid * grid, head_dim) float32, as EVA-02's
    ``VisionRotaryEmbeddingFast`` builds them: per axis dim = head_dim / 2
    with frequencies ``1 / theta^(arange(0, dim, 2) / dim)``, positions
    ``arange(grid) / grid * ref_grid``, each frequency repeated for a pair,
    rows' angles in the first half, columns' in the second (float64 here)."""
    dim = head_dim // 2
    freqs = 1.0 / ROPE_THETA ** (torch.arange(0, dim, 2, dtype=torch.float64)[: dim // 2] / dim)
    t = torch.arange(grid, dtype=torch.float64) / grid * ref_grid
    f = torch.repeat_interleave(t[:, None] * freqs[None, :], 2, dim=-1)      # (grid, dim)
    both = torch.cat([f[:, None, :].expand(grid, grid, dim),
                      f[None, :, :].expand(grid, grid, dim)], dim=-1).reshape(grid * grid, -1)
    return both.cos().float().to(device), both.sin().float().to(device)


def rotate_half(x):
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x = x.unflatten(-1, (-1, 2))
    return torch.stack((-x[..., 1], x[..., 0]), dim=-1).flatten(-2)


def block(p, x, heads, cos, sin, head_chunk=16, mm=matmul):
    """One EVA-02 block on x (B, L, d), L - 1 patches; cos, sin (L - 1,
    head_dim). ``mm`` is the projections' product."""
    b, n, d = x.shape
    a = p["attn"]
    u = ln(p["ln_1"], x, EPS)
    w = f32(a["qkv"]["w"])
    q = mm(u, w[:, :d]) + f32(a["q"]["b"])
    k = mm(u, w[:, d:2 * d])
    v = mm(u, w[:, 2 * d:]) + f32(a["v"]["b"])
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2) for t in (q, k, v))
    q = torch.cat([q[:, :, :1], q[:, :, 1:] * cos + rotate_half(q[:, :, 1:]) * sin], dim=2)
    k = torch.cat([k[:, :, :1], k[:, :, 1:] * cos + rotate_half(k[:, :, 1:]) * sin], dim=2)
    o = attention(q, k, v, head_chunk=head_chunk).transpose(1, 2).reshape(b, n, d)
    x = x + lin(a["out"], ln(a["ln"], o, EPS), mm)
    m = p["mlp"]
    hidden = m["w3"]["w"].shape[0]
    h12 = lin(m["w12"], ln(p["ln_2"], x, EPS), mm)
    g = F.silu(h12[..., :hidden]) * h12[..., hidden:]
    return x + lin(m["w3"], ln(m["ln"], g, EPS), mm)


def vision(p, cfg, images, adapters, pos_embed, head_chunk=16, mm=matmul):
    """The adapted EVA-02 vision tower, with ``reference/model.py``'s
    ``vision`` signature. images (B, 3, S, S) float32 normalized. Returns
    (the taps' patch tokens after the final norm, the last block's
    output)."""
    v, a = cfg["vision"], cfg["adapter"]
    width, ps = v["width"], cfg["patch_size"]
    w = f32(p["patch_embed"]["w"]).t().reshape(width, 3, ps, ps)
    x = F.conv2d(images, w, f32(p["patch_embed"]["b"]), stride=ps).flatten(2).transpose(1, 2)
    cls = f32(p["class_embedding"]).expand(x.shape[0], 1, width)
    x = torch.cat([cls, x], dim=1) + f32(pos_embed)
    grid = math.isqrt(x.shape[1] - 1)
    heads = width // v["head_width"]
    cos, sin = rope_cos_sin(grid, v["rope_ref_grid"], v["head_width"], x.device)
    taps = []
    for i, blk in enumerate(p["blocks"]):
        x = block(blk, x, heads, cos, sin, head_chunk, mm)
        if i < a["image_adapt_until"]:
            x = blend(x, leaky(mm(x, f32(adapters[i]["w"]))), a["image_adapt_weight"])
        if i + 1 in a["levels"]:
            taps.append(ln(p["ln_post"], x[:, 1:], EPS))
    return taps, x


def pooled(p, x):
    """The image embedding: the final norm of the class token, then the
    head."""
    return lin(p["head"], ln(p["ln_post"], x[:, 0], EPS))


@contextlib.contextmanager
def in_clips_place(tower=vision):
    """``reference/model.py`` with ``tower`` (this module's :func:`vision`,
    or it on other products) as its vision tower for the block's length:
    ``model.predict`` looks ``vision`` up when it is called, and so do the
    comparisons built on it."""
    saved = model.vision
    model.vision = tower
    try:
        yield
    finally:
        model.vision = saved


def predict(frozen, trainable, cfg, images_u8, anchors, pos_embed, head_chunk=16):
    """``reference/model.predict`` (maps (B, S, S) and scores (B,)) on this
    vision tower."""
    with in_clips_place():
        return model.predict(frozen, trainable, cfg, images_u8, anchors, pos_embed, head_chunk)
