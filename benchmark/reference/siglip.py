"""The plain reference of SigLIP So400m/14's towers under AA-CLIP, in float32.

Written from the published description: SigLIP (Zhai et al., arXiv
2303.15343), its shape (Alabdulmohsin et al., "Getting ViT in Shape", arXiv
2305.13035) and OpenCLIP's configuration ``ViT-SO400M-14-SigLIP-384.json``,
whose vision tower is timm's ``vit_so400m_patch14_siglip_384``:

- a patch embedding with a bias, an absolute positional embedding of the
  patches alone, no class token and no LayerNorm before the blocks;
- pre-norm blocks ``x + out(attn(LN1 x))`` then ``x + fc2(GELU_tanh(fc1 LN2
  x))``, every LayerNorm of eps 1e-6, biases on q, k, v, the out-projection
  and both MLP products, softmax at the scale head_width^-0.5, the MLP's
  hidden width ``int(width * mlp_ratio)`` (4,304 at width 1,152), unpadded;
- the final norm over every row, then the attention-pool head (timm's
  ``AttentionPoolLatent``, ``timm_pool: "map"``): one learned probe as the
  query, keys and values from the normed rows, the out-projection, then
  ``o + MLP(LN(o))``; no projection after it (``timm_proj: "none"``);
- a text tower of the same blocks with no mask, its final norm at eps 1e-6,
  the last position pooled, and a head with a bias.

It reads the program's parameter layout (a linear weight stored (in, out);
the head's probe ``map.probe.w`` (1, width) and its packed q/k/v
in-projection ``map.attn.qkv``; the text head ``head``) and upcasts every
weight to float32; it imports nothing of the program. The anchors' prompt
ensemble, the trained heads, IQM and the scoring are ``reference/model.py``'s,
reused as they are; :func:`in_clips_place` puts this module's towers, text
anchors and positional-embedding resize where ``model.predict`` and the
drivers' comparison look them up.

Departures from the published description, all AA-CLIP's placements or the
repository's means: the adapters (on vision blocks 0-6 and text blocks 0-6)
and the taps (after blocks 7, 14, 20 and 27), where each tap is the final
norm of every row (the tower has no class row to drop); the attention-pool
output stands where AA-CLIP reads the class token (IQM's class query); and
the prompts' ids are the repository's CLIP BPE ids modulo the vocabulary,
ended and padded to 64 with id 1, in place of SigLIP's SentencePiece ids.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import model, tokenizer
from .model import attention, blend, f32, l2n, leaky, lin, ln, matmul

EPS = 1e-6
PAD_ID = 1


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def block(p, x, heads, mask=None, head_chunk=16, mm=matmul):
    """One SigLIP block on x (B, L, d). ``mm`` is the projections'
    product."""
    b, n, d = x.shape
    qkv = lin(p["attn"]["qkv"], ln(p["ln_1"], x, EPS), mm)
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2) for t in qkv.split(d, dim=-1))
    a = attention(q, k, v, mask, head_chunk).transpose(1, 2).reshape(b, n, d)
    x = x + lin(p["attn"]["out"], a, mm)
    h = gelu_tanh(lin(p["mlp"]["c_fc"], ln(p["ln_2"], x, EPS), mm))
    return x + lin(p["mlp"]["c_proj"], h, mm)


def map_head(p, z, heads, mm=matmul):
    """The attention-pool head on the normed rows z (B, L, d): (B, 1, d)."""
    b, n, d = z.shape
    w, bias = f32(p["attn"]["qkv"]["w"]), f32(p["attn"]["qkv"]["b"])
    q = mm(f32(p["probe"]["w"]), w[:, :d]) + bias[:d]
    k = mm(z, w[:, d:2 * d]) + bias[d:2 * d]
    v = mm(z, w[:, 2 * d:]) + bias[2 * d:]
    qh = q.reshape(1, heads, 1, d // heads).expand(b, -1, -1, -1)
    kh, vh = (t.reshape(b, n, heads, d // heads).transpose(1, 2) for t in (k, v))
    o = attention(qh, kh, vh).transpose(1, 2).reshape(b, 1, d)
    o = lin(p["attn"]["out"], o, mm)
    m = p["mlp"]
    return o + lin(m["c_proj"], gelu_tanh(lin(m["c_fc"], ln(p["ln"], o, EPS), mm)), mm)


def vision(p, cfg, images, adapters, pos_embed, head_chunk=16, mm=matmul, run_block=block):
    """The adapted SigLIP vision tower, with ``reference/model.py``'s
    ``vision`` signature. images (B, 3, S, S) float32 normalized. Returns
    (the taps: every row after the final norm; the attention pool's output
    as a (B, 1, width) row, where ``model.heads`` reads the class token).
    ``run_block``: the block (a test's planted fault takes another)."""
    v, a = cfg["vision"], cfg["adapter"]
    width, ps = v["width"], cfg["patch_size"]
    w = f32(p["patch_embed"]["w"]).t().reshape(width, 3, ps, ps)
    x = F.conv2d(images, w, f32(p["patch_embed"]["b"]), stride=ps).flatten(2).transpose(1, 2)
    x = x + f32(pos_embed)
    heads = width // v["head_width"]
    taps = []
    for i, blk in enumerate(p["blocks"]):
        x = run_block(blk, x, heads, head_chunk=head_chunk, mm=mm)
        if i < a["image_adapt_until"]:
            x = blend(x, leaky(mm(x, f32(adapters[i]["w"]))), a["image_adapt_weight"])
        if i + 1 in a["levels"]:
            taps.append(ln(p["ln_post"], x, EPS))
    return taps, map_head(p["map"], ln(p["ln_post"], x, EPS), heads, mm)


def resize_pos_embed(pos, grid):
    """(g*g, width) -> (grid*grid, width): every row is the grid's, resized
    bicubically (antialiased, corners not aligned), in float64."""
    g = math.isqrt(pos.shape[0])
    if g == grid:
        return pos
    img = pos.double().reshape(1, g, g, -1).permute(0, 3, 1, 2)
    img = F.interpolate(img, size=(grid, grid), mode="bicubic", align_corners=False,
                        antialias=True)
    return img.permute(0, 2, 3, 1).reshape(grid * grid, -1).to(pos.dtype)


def tokenize(texts, context_length: int, vocab_size: int) -> np.ndarray:
    """(N, context_length) int64: each text's BPE ids modulo the vocabulary,
    then the end id, truncated to the context and padded with the end id."""
    out = np.full((len(texts), context_length), PAD_ID, np.int64)
    for i, text in enumerate(texts):
        ids = [t % vocab_size for t in tokenizer.encode(text)][:context_length - 1] + [PAD_ID]
        out[i, :len(ids)] = ids
    return out


def text_anchors(frozen, trainable, cfg, device, mm=matmul):
    """``model.text_anchors`` on SigLIP's text tower: no mask, the final
    norm at eps 1e-6, the last position pooled, then the text adapter's
    projection."""
    pr = model.prompts()
    t, a = cfg["text"], cfg["adapter"]
    p, ta = frozen["text"], trainable["text_adapter"]
    out = {}
    for cls, real in pr["real_names"].items():
        cols = []
        for state in ("normal", "abnormal"):
            sentences = [tpl.format(s.format(real)) for s in pr["states"][state]
                         for tpl in pr["templates"]]
            tokens = torch.from_numpy(tokenize(sentences, t["context_length"],
                                               t["vocab_size"])).to(device)
            x = f32(p["token_embedding"])[tokens] + f32(p["positional_embedding"])
            for i, blk in enumerate(p["blocks"]):
                x = block(blk, x, t["heads"], mm=mm)
                if i < a["text_adapt_until"]:
                    x = blend(x, leaky(mm(x, f32(ta["layers"][i]["w"]))), a["text_adapt_weight"])
            pooled = ln(p["ln_final"], x, EPS)[:, -1]
            emb = leaky(mm(pooled, f32(ta["proj"]["w"])))
            m = l2n(emb).mean(dim=0)
            cols.append(m / m.norm())
        out[cls] = torch.stack(cols, dim=1)
    return out


@contextlib.contextmanager
def in_clips_place(tower=vision):
    """``reference/model.py`` with ``tower`` (this module's :func:`vision`,
    or it on other products) as its vision tower, and this module's text
    anchors and positional-embedding resize, for the block's length:
    ``model.predict`` and the drivers' comparison look them up when they
    are called."""
    saved = model.vision, model.text_anchors, model.resize_pos_embed
    model.vision, model.text_anchors, model.resize_pos_embed = (tower, text_anchors,
                                                                resize_pos_embed)
    try:
        yield
    finally:
        model.vision, model.text_anchors, model.resize_pos_embed = saved
