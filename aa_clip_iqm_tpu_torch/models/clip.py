"""CLIP towers (ViT vision + text transformer) as functions on tensors.

Counterpart of ``aa_clip_iqm_tpu/models/clip.py``. Parameters are dicts with
the JAX package's names, except that each tower's blocks are a Python list
of per-layer dicts instead of leaves stacked on a layer axis:

  params = {
    "visual": {patch_embed, class_embedding, positional_embedding, ln_pre,
               blocks: [...], ln_post, proj},
    "text":   {token_embedding, positional_embedding, blocks: [...],
               ln_final, text_projection},
  }
  block = {ln_1, attn: {qkv: {w,b}, out: {w,b}}, ln_2,
           mlp: {c_fc: {w,b}, c_proj: {w,b}}}

A block with float MLP weights, vision or text, runs its MLP half through
:func:`..ops.fused_mlp.ln_mlp_residual`; one with int8 MLP weights
(``ops.quant``) through :func:`..ops.fused_mlp.ln_mlp_residual_int8` where
that kernel's gate allows (bf16, width a multiple of 128), else through the
unfused ``x + mlp_block(...)`` on ``int8_linear``. Each fused function is the
Hopper kernel on the card and its plain twin on the CPU. Unmasked attention
goes through the packed-qkv kernel. The tower is not padded: the attention
kernel masks the ragged key tile itself.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..configs import TextConfig, VisionConfig
from ..ops import attention as attn_ops
from ..ops.fused_mlp import (
    ln_mlp_residual,
    ln_mlp_residual_int8,
    ln_mlp_residual_int8_ok,
)
from ..ops.layers import (
    ACTIVATIONS,
    layer_norm,
    linear,
    mlp_block,
    norm_preserving_blend,
    simple_adapter,
)


def patchify(params, images, patch_size: int):
    """(B, 3, H, W) -> (B, L, width) via reshape + matmul (== strided conv)."""
    b, c, h, w = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, c, gh, patch_size, gw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * patch_size * patch_size)
    return linear(params["patch_embed"], x)


def _run_block(block, x, num_heads, act, attn_mask=None, vv=False,
               valid_len=None):
    """Pre-norm residual attention block. ``vv`` selects the CLIP-Surgery
    value-value attention."""
    h = layer_norm(block["ln_1"], x)
    if vv:
        a = attn_ops.vv_attention(block["attn"], h, num_heads,
                                  valid_len=valid_len)
    else:
        a = attn_ops.mha(block["attn"], h, num_heads, attn_mask=attn_mask,
                         valid_len=valid_len)
    x = x + a
    mlp = block["mlp"]
    if "w_q" not in mlp["c_fc"] and "w_q" not in mlp["c_proj"]:
        return ln_mlp_residual(block["ln_2"], mlp, x, act)
    if ln_mlp_residual_int8_ok(x, mlp, act):
        return ln_mlp_residual_int8(block["ln_2"], mlp, x, act)
    return x + mlp_block(mlp, layer_norm(block["ln_2"], x), act)


def embed_patches(params, cfg: VisionConfig, images, compute_dtype):
    """Patch embedding, class token, positional embedding and ln_pre:
    (B, 3, H, W) -> (B, L+1, width), the input of the first block."""
    x = patchify(params, images.to(compute_dtype), cfg.patch_size)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["positional_embedding"].to(compute_dtype)
    return layer_norm(params["ln_pre"], x)


def run_blocks(blocks, x, num_heads: int, act, attn_mask=None, vv_from=None,
               adapters=None, adapter_weight: float = 0.0, adapt_until: int = 0,
               out_layers: Sequence[int] = ()):
    """Run every block in order. Blocks [0, adapt_until) are each followed by
    their SimpleAdapter and the norm-preserving blend; blocks at index >=
    ``vv_from`` use value-value attention; the outputs of the 1-based layers
    in ``out_layers`` are collected. Returns (x, taps)."""
    taps = []
    for i, block in enumerate(blocks):
        vv = vv_from is not None and i >= vv_from
        x = _run_block(block, x, num_heads, act, attn_mask=attn_mask, vv=vv)
        if i < adapt_until:
            x = norm_preserving_blend(x, simple_adapter(adapters[i], x),
                                      adapter_weight)
        if i + 1 in out_layers:
            taps.append(x)
    return x, taps


def vision_forward(
    params,
    cfg: VisionConfig,
    images,
    out_layers: Sequence[int] = (),
    act_name: str = "gelu",
    vv_from: Optional[int] = None,
    adapters=None,
    adapter_weight: float = 0.0,
    adapt_until: int = 0,
    compute_dtype=torch.float32,
):
    """ViT forward with multi-depth taps.

    out_layers: 1-based layer indices whose full token outputs (incl. CLS)
    are collected. vv_from: 0-based first value-value block. adapters: list
    of SimpleAdapter params applied after blocks [0, adapt_until).

    Returns: (pooled (B, output_dim), taps list of (B, L+1, width), final x).
    """
    x = embed_patches(params, cfg, images, compute_dtype)
    x, taps = run_blocks(params["blocks"], x, cfg.heads, ACTIVATIONS[act_name],
                         vv_from=vv_from, adapters=adapters,
                         adapter_weight=adapter_weight, adapt_until=adapt_until,
                         out_layers=out_layers)
    pooled = layer_norm(params["ln_post"], x[:, 0])
    pooled = linear({"w": params["proj"]}, pooled)
    return pooled, taps, x


def text_forward(
    params,
    cfg: TextConfig,
    tokens,
    act_name: str = "gelu",
    adapters=None,
    adapter_weight: float = 0.0,
    adapt_until: int = 0,
    final_proj="clip",
    compute_dtype=torch.float32,
):
    """Text transformer, parity with CLIP.encode_text.

    tokens: (B, ctx) integer ids (0-padded, EOT = max id in row).
    final_proj: "clip" -> pooled @ text_projection; a callable is applied to
    the pooled ln_final output instead. Returns pooled (B, out_dim).
    """
    x = params["token_embedding"][tokens].to(compute_dtype)
    x = x + params["positional_embedding"].to(compute_dtype)
    mask = attn_ops.causal_mask(cfg.context_length, device=x.device)
    x, _ = run_blocks(params["blocks"], x, cfg.heads, ACTIVATIONS[act_name],
                      attn_mask=mask, adapters=adapters,
                      adapter_weight=adapter_weight, adapt_until=adapt_until)
    x = layer_norm(params["ln_final"], x)
    eot = torch.argmax(tokens, dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot]
    if final_proj == "clip":
        return linear({"w": params["text_projection"]}, pooled)
    return final_proj(pooled)
