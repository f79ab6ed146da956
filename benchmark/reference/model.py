"""The plain reference of AA-CLIP with the IQM head, in float32.

Written from the published description (AA-CLIP, arXiv 2503.06661: a
frozen CLIP ViT with residual adapters on its first blocks and on the text
tower's, multi-level taps projected into the text space, the
anomaly-aware anchors, and the IQM query transformer of this framework)
with stock PyTorch calls: ``conv2d`` for the patch embedding, softmax
attention by matmuls, ``F.interpolate`` for the positional-embedding resize
and the map upsampling, ``conv2d`` with reflect padding for the Gaussian
blur. It reads weights from a parameter dict in the program's layout (a
linear weight stored (in, out)) and upcasts every one to float32; it imports
nothing of the program.

Every function takes ``cfg``, the configuration file's dict
(``benchmark/configs/<name>.json``).
"""
from __future__ import annotations

import json
import math
import os

import torch
import torch.nn.functional as F

from . import tokenizer

PROMPTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "prompts.json")


def prompts():
    with open(PROMPTS) as f:
        return json.load(f)


def f32(t):
    return t.float()


def ln(p, x, eps=1e-5):
    return F.layer_norm(x, x.shape[-1:], f32(p["scale"]), f32(p["bias"]), eps)


def matmul(x, w):
    return x @ w


def fp8_matmul(x, w):
    """The control's product: both operands rounded to float8 e4m3, each
    scaled by its largest magnitude to the format's largest value (448),
    then multiplied in float32."""
    def q(t):
        s = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / s).to(torch.float8_e4m3fn).float() * s
    return q(x) @ q(w)


def lin(p, x, mm=matmul):
    y = mm(x, f32(p["w"]))
    return y + f32(p["b"]) if "b" in p else y


def leaky(x):
    return F.leaky_relu(x, 0.01)


def l2n(x):
    return x / x.norm(dim=-1, keepdim=True)


def attention(q, k, v, mask=None, head_chunk=16):
    """(B, H, L, hd) softmax attention, a few heads at a time."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for h in range(0, q.shape[1], head_chunk):
        s = q[:, h:h + head_chunk] @ k[:, h:h + head_chunk].transpose(-1, -2) * scale
        if mask is not None:
            s = s + mask
        outs.append(torch.softmax(s, dim=-1) @ v[:, h:h + head_chunk])
    return torch.cat(outs, dim=1)


def block(p, x, heads, mask=None, head_chunk=16, mm=matmul):
    """Pre-norm residual block: x + attn(ln_1 x); x + mlp(ln_2 x), exact
    GELU. ``mm`` is the projections' product."""
    b, n, d = x.shape
    qkv = lin(p["attn"]["qkv"], ln(p["ln_1"], x), mm)
    q, k, v = (t.reshape(b, n, heads, d // heads).transpose(1, 2) for t in qkv.split(d, dim=-1))
    a = attention(q, k, v, mask, head_chunk).transpose(1, 2).reshape(b, n, d)
    x = x + lin(p["attn"]["out"], a, mm)
    h = F.gelu(lin(p["mlp"]["c_fc"], ln(p["ln_2"], x), mm))
    return x + lin(p["mlp"]["c_proj"], h, mm)


def blend(x, adapted, w):
    """The norm-preserving residual blend of an adapter's output."""
    return w * adapted * x.norm(dim=-1, keepdim=True) / adapted.norm(dim=-1, keepdim=True) \
        + (1 - w) * x


def resize_pos_embed(pos, grid):
    """(1 + g*g, width) -> (1 + grid*grid, width): the class row passes, the
    grid is resized bicubically (antialiased, corners not aligned), in
    float64."""
    g = math.isqrt(pos.shape[0] - 1)
    if g == grid:
        return pos
    img = pos[1:].double().reshape(1, g, g, -1).permute(0, 3, 1, 2)
    img = F.interpolate(img, size=(grid, grid), mode="bicubic", align_corners=False,
                        antialias=True)
    img = img.permute(0, 2, 3, 1).reshape(grid * grid, -1).to(pos.dtype)
    return torch.cat([pos[:1], img], dim=0)


def normalize(images_u8, cfg_prompts):
    mean = torch.tensor(cfg_prompts["image_mean"], dtype=torch.float32,
                        device=images_u8.device).reshape(1, 3, 1, 1)
    std = torch.tensor(cfg_prompts["image_std"], dtype=torch.float32,
                       device=images_u8.device).reshape(1, 3, 1, 1)
    return (images_u8.float() / 255.0 - mean) / std


def vision(p, cfg, images, adapters, pos_embed, head_chunk=16, mm=matmul):
    """The adapted vision tower. images (B, 3, S, S) float32 normalized.
    Returns (the taps' patch tokens after ln_post, the last block's output).
    ``mm``: the product of the blocks' and adapters' projections."""
    v, a = cfg["vision"], cfg["adapter"]
    width, ps = v["width"], cfg["patch_size"]
    w = f32(p["patch_embed"]["w"]).t().reshape(width, 3, ps, ps)
    x = F.conv2d(images, w, stride=ps).flatten(2).transpose(1, 2)
    cls = f32(p["class_embedding"]).expand(x.shape[0], 1, width)
    x = torch.cat([cls, x], dim=1) + f32(pos_embed)
    x = ln(p["ln_pre"], x)
    taps = []
    heads = width // v["head_width"]
    for i, blk in enumerate(p["blocks"]):
        x = block(blk, x, heads, head_chunk=head_chunk, mm=mm)
        if i < a["image_adapt_until"]:
            x = blend(x, leaky(mm(x, f32(adapters[i]["w"]))), a["image_adapt_weight"])
        if i + 1 in a["levels"]:
            taps.append(ln(p["ln_post"], x[:, 1:]))
    return taps, x


def text_anchors(frozen, trainable, cfg, device, mm=matmul):
    """The per-class (embed_dim, 2) anchors from the adapted text tower over
    the dataset's prompt ensemble: each sentence's embedding normalized, the
    mean of each state's, normalized again. ``mm`` is the product of every
    projection of the tower (``fp8_matmul`` for the control)."""
    pr = prompts()
    t, a = cfg["text"], cfg["adapter"]
    p, ta = frozen["text"], trainable["text_adapter"]
    out = {}
    for cls, real in pr["real_names"].items():
        cols = []
        for state in ("normal", "abnormal"):
            sentences = [tpl.format(s.format(real)) for s in pr["states"][state]
                         for tpl in pr["templates"]]
            tokens = torch.from_numpy(tokenizer.tokenize(sentences, t["context_length"])).to(device)
            n = t["context_length"]
            x = f32(p["token_embedding"])[tokens] + f32(p["positional_embedding"])
            mask = torch.full((n, n), float("-inf"), device=device).triu(1)
            for i, blk in enumerate(p["blocks"]):
                x = block(blk, x, t["heads"], mask=mask, mm=mm)
                if i < a["text_adapt_until"]:
                    x = blend(x, leaky(mm(x, f32(ta["layers"][i]["w"]))), a["text_adapt_weight"])
            x = ln(p["ln_final"], x)
            pooled = x[torch.arange(x.shape[0], device=device), tokens.argmax(dim=-1)]
            emb = leaky(mm(pooled, f32(ta["proj"]["w"])))
            m = l2n(emb).mean(dim=0)
            cols.append(m / m.norm())
        out[cls] = torch.stack(cols, dim=1)
    return out


def _mha(p, q_in, kv_in, heads, mm=matmul):
    q, k, v = lin(p["q"], q_in, mm), lin(p["k"], kv_in, mm), lin(p["v"], kv_in, mm)
    b, nq, d = q.shape
    split = lambda t: t.reshape(b, t.shape[1], heads, d // heads).transpose(1, 2)  # noqa: E731
    o = attention(split(q), split(k), split(v)).transpose(1, 2).reshape(b, nq, d)
    return o


def iqm(p, cfg, queries, visual, text, mm=matmul):
    """The IQM query transformer: per layer self-attention, attention to the
    visual tokens and to the two text tokens, each a post-LN residual
    sub-block, their fixed-weight sum, then the feed-forward sub-block."""
    c = cfg["iqm"]
    eps, heads = c["layer_norm_eps"], c["num_attention_heads"]

    def sub(sp, q_in, kv_in):
        h = lin(sp["out_dense"], _mha(sp, q_in, kv_in, heads, mm), mm)
        return ln(sp["out_ln"], h + q_in, eps)

    x = ln(p["layernorm"], queries, eps)
    w_self, w_vis, w_txt = c["fuse"]
    for layer in p["layers"]:
        s = sub(layer["self"], x, x)
        vis = sub(layer["cross"], s, visual)
        txt = sub(layer["text_cross"], vis, text)
        fused = w_self * s + w_vis * vis + w_txt * txt
        f = layer["ffn_q"]
        h = lin(f["output"], F.gelu(lin(f["intermediate"], fused, mm)), mm)
        x = ln(f["ln"], h + fused, eps)
    return x


def heads(trainable, cfg, taps, x_final, anchors, mm=matmul):
    """The trained heads on the taps: the per-level segmentation tokens, the
    detection token and the IQM's two projected queries."""
    ia, relu = trainable["image_adapter"], cfg["adapter"]["relu"]

    def proj(p, t):
        y = mm(t, f32(p["w"]))
        return leaky(y) if relu else y

    seg = [l2n(proj(ia["seg_proj"][i], t)) for i, t in enumerate(taps)]
    det = l2n(proj(ia["det_proj"], taps[-1])).mean(dim=1)
    mlp = trainable["class_query_mlp"]
    q = lin(mlp["fc2"], torch.relu(lin(mlp["fc1"], x_final[:, 0], mm)), mm)
    queries = q[:, None, :].repeat(1, 2, 1) + f32(trainable["pos_embedding"])[:, :2]
    visual = torch.cat([proj(trainable["query_adapters"][i], t) for i, t in enumerate(taps)], 1)
    visual = lin(trainable["visual_feature_proj"], visual, mm)
    text = lin(trainable["text_feature_proj"], anchors.transpose(-1, -2), mm)
    out = ln(trainable["iqm_layer_norm"], iqm(trainable["iqm"], cfg, queries, visual, text, mm))
    return seg, det, lin(trainable["query_proj"], out, mm)


def gaussian(k, sigma, device):
    x = torch.arange(k, dtype=torch.float64, device=device) - k // 2
    g = torch.exp(-x ** 2 / (2 * sigma ** 2))
    return (g / g.sum()).float()


def _grid(t):
    """(B, L) -> (B, H, H), L = H * H, row-major."""
    n = math.isqrt(t.shape[1])
    return t.reshape(t.shape[0], n, n)


def _grid_channels(t):
    """(B, L, C) -> (B, C, H, H)."""
    n = math.isqrt(t.shape[1])
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], n, n)


def predict(frozen, trainable, cfg, images_u8, anchors, pos_embed, head_chunk=16):
    """Anomaly maps (B, S, S) and image scores (B,) for uint8 images (B, 3,
    S, S) and per-image anchors (B, embed_dim, 2): the text maps
    ((abnormal + 1 - normal) / 2 of 100x the similarities, Gaussian blur with
    reflect padding, bilinear upsampling with aligned corners), the IQM maps
    (sigmoid of the cosine difference, bilinear upsampling), 0.6 and 0.4 of
    their sums, and (det . abnormal anchor + 1) / 2."""
    pr = prompts()
    size = cfg["img_size"]
    x = normalize(images_u8, pr)
    taps, x_final = vision(frozen["visual"], cfg, x, trainable["image_adapter"]["layer_adapters"],
                           pos_embed, head_chunk)
    seg, det, q = heads(trainable, cfg, taps, x_final, anchors)
    k, sigma = pr["blur"]
    g = gaussian(k, sigma, images_u8.device)
    g2 = (g[:, None] * g[None, :])[None, None]
    text_sum = iqm_sum = 0
    for s in seg:
        logits = 100.0 * s @ anchors
        score = _grid((logits[..., 1] + 1.0 - logits[..., 0]) * 0.5)[:, None]
        blurred = F.conv2d(F.pad(score, (k // 2,) * 4, mode="reflect"), g2)
        text_sum = text_sum + F.interpolate(blurred, size=(size, size), mode="bilinear",
                                            align_corners=True)[:, 0]
        sims = l2n(s) @ l2n(q).transpose(1, 2)
        pred = _grid(torch.sigmoid(sims[..., 1] - sims[..., 0]))[:, None]
        iqm_sum = iqm_sum + F.interpolate(pred, size=(size, size), mode="bilinear",
                                          align_corners=False)[:, 0]
    fw = cfg["fusion"]
    maps = fw["text_weight"] * text_sum + fw["iqm_weight"] * iqm_sum
    scores = ((det[:, None, :] @ anchors)[:, 0, 1] + 1.0) * 0.5
    return maps, scores
