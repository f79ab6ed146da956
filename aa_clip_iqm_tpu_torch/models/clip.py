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
:func:`..ops.fused_mlp.ln_mlp_residual`, or with ``fused_mlp="frozen"``
through :func:`..ops.fused_mlp.ln_mlp_residual_frozen`, whose backward is the
dx-only kernel (the stage-2 frozen backbone); one with int8 MLP weights
(``ops.quant``) through :func:`..ops.fused_mlp.ln_mlp_residual_int8` where
that kernel's gate allows (bf16, width a multiple of 128), else through the
unfused ``x + mlp_block(...)`` on ``int8_linear``. Each fused function is the
Hopper kernel on the card and its plain twin on the CPU. Attention routes as
in the JAX package (``ops/attention.py``): the packed-qkv kernel where its
gate holds, else the unpacked flash kernel on split heads. With
``FUSED_ATTN`` (``AACLIP_FUSED_ATTN=1``) an unmasked block whose weights pass
:func:`..ops.attn_block.ln_attn_residual_ok` runs its whole attention half
(LayerNorm, qkv, attention, out-projection, residual) through the fused
kernel instead. The tower is not padded: the attention kernels mask the
ragged key tile themselves.
"""
from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs import CLIPConfig, TextConfig, VisionConfig
from ..ops import attention as attn_ops
from ..ops.attn_block import ln_attn_residual, ln_attn_residual_ok
from ..ops.fused_mlp import (
    ln_mlp_residual,
    ln_mlp_residual_frozen,
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

# Route the whole attention residual branch (LN -> qkv -> attention ->
# out-proj -> residual) through the fused kernel (ops/attn_block.py) instead
# of the LN / projections / attention chain. Opt-in, as in the JAX package:
# env AACLIP_FUSED_ATTN=1, read at import.
FUSED_ATTN = os.environ.get("AACLIP_FUSED_ATTN", "0") == "1"


def patchify(params, images, patch_size: int):
    """(B, 3, H, W) -> (B, L, width) via reshape + matmul (== strided conv)."""
    b, c, h, w = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, c, gh, patch_size, gw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * patch_size * patch_size)
    return linear(params["patch_embed"], x)


def _run_block(block, x, num_heads, act, attn_mask=None, vv=False,
               valid_len=None, fused_mlp=True):
    """Pre-norm residual attention block. ``vv`` selects the CLIP-Surgery
    value-value attention. With ``FUSED_ATTN``, no mask and a block that
    passes ``ln_attn_residual_ok`` the attention half is one fused kernel
    (int8 attention weights fail the gate and keep the chain).
    ``fused_mlp="frozen"`` takes the fused MLP whose backward is the dx-only
    kernel: valid only while the block's parameters carry no gradient (it
    raises otherwise)."""
    if (FUSED_ATTN and attn_mask is None
            and ln_attn_residual_ok(x, block["attn"], num_heads)):
        x = ln_attn_residual(block["ln_1"], block["attn"], x, num_heads, vv,
                             valid_len)
    else:
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
        fn = ln_mlp_residual_frozen if fused_mlp == "frozen" else ln_mlp_residual
        return fn(block["ln_2"], mlp, x, act)
    if ln_mlp_residual_int8_ok(x, mlp, act):
        return ln_mlp_residual_int8(block["ln_2"], mlp, x, act)
    return x + mlp_block(mlp, layer_norm(block["ln_2"], x), act)


def embed_patches(params, cfg: VisionConfig, images, compute_dtype,
                  keep_idx=None):
    """Patch embedding, class token, positional embedding and ln_pre:
    (B, 3, H, W) -> (B, L+1, width), the input of the first block.
    ``keep_idx`` (B, K): patch-dropout kept-token indices
    (``ops.layers.patch_dropout_indices``), applied after the positional
    embedding and before ln_pre; the class token is always kept."""
    x = patchify(params, images.to(compute_dtype), cfg.patch_size)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["positional_embedding"].to(compute_dtype)
    if keep_idx is not None:
        idx = keep_idx[..., None].expand(-1, -1, x.shape[-1])
        x = torch.cat([x[:, :1], torch.gather(x[:, 1:], 1, idx)], dim=1)
    return layer_norm(params["ln_pre"], x)


def run_blocks(blocks, x, num_heads: int, act, attn_mask=None, vv_from=None,
               adapters=None, adapter_weight: float = 0.0, adapt_until: int = 0,
               out_layers: Sequence[int] = (), start: int = 0, stop=None,
               remat: bool = False, fused_mlp=True):
    """Run blocks [start, stop) in order (all by default). Blocks
    [0, adapt_until) are each followed by their SimpleAdapter and the
    norm-preserving blend; blocks at index >= ``vv_from`` use value-value
    attention; the outputs of the 1-based layers in ``out_layers`` are
    collected. With ``remat`` each block (and its adapter) is checkpointed:
    its activations are recomputed in the backward instead of kept.
    Returns (x, taps)."""
    taps = []
    stop = len(blocks) if stop is None else stop
    for i in range(start, stop):
        def body(x, i=i):
            y = _run_block(blocks[i], x, num_heads, act, attn_mask=attn_mask,
                           vv=vv_from is not None and i >= vv_from,
                           fused_mlp=fused_mlp)
            if i < adapt_until:
                y = norm_preserving_blend(y, simple_adapter(adapters[i], y),
                                          adapter_weight)
            return y

        if remat and torch.is_grad_enabled():
            x = checkpoint(body, x, use_reentrant=False)
        else:
            x = body(x)
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
    remat: bool = False,
    keep_idx=None,
    fused_mlp=True,
):
    """ViT forward with multi-depth taps.

    out_layers: 1-based layer indices whose full token outputs (incl. CLS)
    are collected. vv_from: 0-based first value-value block. adapters: list
    of SimpleAdapter params applied after blocks [0, adapt_until). remat:
    checkpoint each block in the backward. keep_idx: (B, K) patch-dropout
    kept-token indices; the taps then carry K+1 tokens. fused_mlp: True, or
    "frozen" for the dx-only backward (see :func:`_run_block`).

    Returns: (pooled (B, output_dim), taps list of (B, L+1, width), final x).
    """
    x = embed_patches(params, cfg, images, compute_dtype, keep_idx=keep_idx)
    x, taps = run_blocks(params["blocks"], x, cfg.heads, ACTIVATIONS[act_name],
                         vv_from=vv_from, adapters=adapters,
                         adapter_weight=adapter_weight, adapt_until=adapt_until,
                         out_layers=out_layers, remat=remat, fused_mlp=fused_mlp)
    pooled = layer_norm(params["ln_post"], x[:, 0])
    pooled = linear({"w": params["proj"]}, pooled)
    return pooled, taps, x


def encode_image(params, cfg: CLIPConfig, images, compute_dtype=torch.float32):
    """CLIP.encode_image: the pooled image embedding of the ViT tower.
    ModifiedResNet towers are not ported (ROADMAP A13)."""
    if not isinstance(cfg.vision, VisionConfig):
        raise NotImplementedError(
            "encode_image runs the ViT tower only; ModifiedResNet towers "
            "are not ported (ROADMAP A13)")
    pooled, _, _ = vision_forward(params["visual"], cfg.vision, images,
                                  act_name=cfg.act, compute_dtype=compute_dtype)
    return pooled


def dual_vision_features(params, cfg: VisionConfig, images,
                         out_layers: Sequence[int], vv_from: int,
                         act_name: str = "gelu", compute_dtype=torch.float32):
    """Stage-1 visual features: surgery taps + plain CLS, shared prefix.

    The reference runs two complete CLIP copies per stage-1 batch, a
    surgeried one for the patch taps and a plain one for the CLS token. Both
    share weights and computation up to the first value-value block, so one
    forward forks at ``vv_from``: blocks [0, vv_from) run once, then the v-v
    branch and the plain branch continue separately.

    Returns (cls_pooled (B, output_dim), surgery_taps [(B, L+1, width)]).
    """
    act = ACTIVATIONS[act_name]
    blocks = params["blocks"]
    x = embed_patches(params, cfg, images, compute_dtype)
    x, taps = run_blocks(blocks, x, cfg.heads, act, out_layers=out_layers,
                         stop=vv_from)
    _, vv_taps = run_blocks(blocks, x, cfg.heads, act, vv_from=vv_from,
                            out_layers=out_layers, start=vv_from)
    xp, _ = run_blocks(blocks, x, cfg.heads, act, start=vv_from)
    pooled = layer_norm(params["ln_post"], xp[:, 0])
    pooled = linear({"w": params["proj"]}, pooled)
    return pooled, taps + vv_taps


def surgery_vv_from(num_layers: int, dpam_layer: int) -> int:
    """0-based first v-v block index for a surgery depth of ``dpam_layer``
    (the last dpam_layer - 1 blocks are replaced)."""
    return num_layers - (dpam_layer - 1)


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


def resize_pos_embed_np(pos_embed: np.ndarray, new_grid: int) -> np.ndarray:
    """Bicubic-resize the (L+1, width) positional embedding to a new square
    grid (bicubic, antialias=True, align_corners=False); the CLS row passes
    through. Host-side numpy, at load time."""
    from ..ops.interp import resize_grid_bicubic

    tok, img = pos_embed[:1], pos_embed[1:]
    old_grid = int(round(math.sqrt(img.shape[0])))
    if old_grid * old_grid != img.shape[0]:
        raise ValueError(f"pos embed length {img.shape[0]} not square")
    if old_grid == new_grid:
        return pos_embed
    grid = img.reshape(old_grid, old_grid, -1)
    resized = resize_grid_bicubic(grid, (new_grid, new_grid), antialias=True)
    return np.concatenate([tok, resized.reshape(new_grid * new_grid, -1)], axis=0)
