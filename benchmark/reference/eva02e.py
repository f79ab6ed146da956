"""The plain reference of EVA02-CLIP-E/14+'s vision tower under AA-CLIP, in
float32.

Written from the published description: EVA-CLIP (Sun et al., arXiv
2303.15389) and its configuration ``EVA02-CLIP-bigE-14-plus.json``
(baaivision/EVA, ``EVA-CLIP/rei/eva_clip/model_configs/``), whose vision
tower is EVA-CLIP's ``eva_vit_model.py`` with ``postnorm`` (timm's
``eva02_enormous_patch14_clip_224``, ``use_post_norm=True``):

- a patch embedding with a bias, a class token, an absolute positional
  embedding, and no LayerNorm before the blocks;
- blocks of ``x + LN1(attn(x))`` then ``x + LN2(fc2(GELU(fc1 x)))``, every
  LayerNorm of eps 1e-6; q and v with a bias, k without one, softmax at the
  scale head_width^-0.5; the out-projection and both MLP products with a
  bias; the exact (erf) GELU; no rotary embedding and no sub-LN;
- the final ``norm`` (the taps' and the pooled token's LayerNorm, AA-CLIP's
  ln_post) and a ``head`` with a bias.

It reads the program's parameter layout (a linear weight stored (in, out);
the packed q/k/v weight ``attn.qkv.w`` with its q and v biases apart,
``attn.q.b`` and ``attn.v.b``; the MLP's ``c_fc`` and ``c_proj``) and
upcasts every weight to float32; it imports nothing of the program. The
text tower (OpenCLIP bigG's: 32 pre-norm blocks of width 1280, heads of
64), the anchors, the trained heads, IQM and the scoring are
``reference/model.py``'s, and the final norm, the head and
:func:`..eva02.in_clips_place` are ``reference/eva02.py``'s, each reused as
it is.

Departures from the published description: none in the vision tower. The
AA-CLIP placements on this tower (adapters on blocks 0-15, taps after
blocks 16, 32, 48 and 64, text adapters on blocks 0-7) are an assumption:
AA-CLIP publishes none for it. The text tower's GELU is exact (OpenCLIP
bigG's), and its LayerNorms keep ``reference/model.py``'s eps 1e-5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import eva02
from .model import attention, blend, f32, leaky, lin, ln, matmul

EPS = eva02.EPS


def block(p, x, heads, head_chunk=16, mm=matmul):
    """One post-norm EVA block on x (B, L, d). ``mm`` is the projections'
    product."""
    b, n, d = x.shape
    a, m = p["attn"], p["mlp"]
    w = f32(a["qkv"]["w"])
    q = mm(x, w[:, :d]) + f32(a["q"]["b"])
    k = mm(x, w[:, d:2 * d])
    v = mm(x, w[:, 2 * d:]) + f32(a["v"]["b"])
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2) for t in (q, k, v))
    o = attention(q, k, v, head_chunk=head_chunk).transpose(1, 2).reshape(b, n, d)
    x = x + ln(p["ln_1"], lin(a["out"], o, mm), EPS)
    h = F.gelu(lin(m["c_fc"], x, mm))
    return x + ln(p["ln_2"], lin(m["c_proj"], h, mm), EPS)


def vision(p, cfg, images, adapters, pos_embed, head_chunk=16, mm=matmul, run_block=block):
    """The adapted post-norm EVA vision tower, with ``reference/model.py``'s
    ``vision`` signature. images (B, 3, S, S) float32 normalized. Returns
    (the taps' patch tokens after the final norm, the last block's output).
    ``run_block``: the block (a test's planted fault takes another)."""
    v, a = cfg["vision"], cfg["adapter"]
    width, ps = v["width"], cfg["patch_size"]
    w = f32(p["patch_embed"]["w"]).t().reshape(width, 3, ps, ps)
    x = F.conv2d(images, w, f32(p["patch_embed"]["b"]), stride=ps).flatten(2).transpose(1, 2)
    cls = f32(p["class_embedding"]).expand(x.shape[0], 1, width)
    x = torch.cat([cls, x], dim=1) + f32(pos_embed)
    heads = width // v["head_width"]
    taps = []
    for i, blk in enumerate(p["blocks"]):
        x = run_block(blk, x, heads, head_chunk, mm)
        if i < a["image_adapt_until"]:
            x = blend(x, leaky(mm(x, f32(adapters[i]["w"]))), a["image_adapt_weight"])
        if i + 1 in a["levels"]:
            taps.append(ln(p["ln_post"], x[:, 1:], EPS))
    return taps, x


pooled = eva02.pooled


def in_clips_place(tower=vision):
    """``reference/model.py`` with ``tower`` (this module's :func:`vision`,
    or it on other products) as its vision tower: ``eva02.in_clips_place``."""
    return eva02.in_clips_place(tower)
