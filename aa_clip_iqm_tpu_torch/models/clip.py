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

An EVA-02 vision tower (``configs.Eva02VisionConfig``, EVA02-CLIP) has no
ln_pre, a bias on its patch embedding, and a projection with a bias,
``head: {w, b}``, in ``proj``'s place (its final norm is ``ln_post``); its
blocks are

  block = {ln_1, attn: {qkv: {w}, q: {b}, v: {b}, ln, out: {w,b}}, ln_2,
           mlp: {w12: {w,b}, ln, w3: {w,b}}}

run by :func:`_run_eva02_block`: q/k/v packed in one (d, 3d) weight, the
bias ``[q | 0 | v]`` (k has none), the rotary embedding of the patch rows'
q and k (``ops/rope.py``), the sub-LN ``attn.ln`` before the out-projection,
and the SwiGLU MLP with its sub-LN ``mlp.ln`` (``ops/swiglu.py``).

A block with float MLP weights, vision or text, runs its MLP half through
:func:`..ops.fused_mlp.ln_mlp_residual`, or with ``fused_mlp="frozen"``
through :func:`..ops.fused_mlp.ln_mlp_residual_frozen`, whose backward is the
dx-only kernel (the stage-2 frozen backbone); one with int8 MLP weights
(``ops.quant``) through :func:`..ops.fused_mlp.ln_mlp_residual_int8` where
that kernel's gate allows (bf16, width a multiple of 128), else through the
unfused ``x + mlp_block(...)`` on ``int8_linear``. Each fused function is the
Hopper kernel on the card and its plain twin on the CPU. Attention routes as
in the JAX package (``ops/attention.py``): the packed-qkv kernel where its
gate holds, else the unpacked flash kernel on split heads. An unmasked block
whose call passes :func:`..ops.attn_block.ln_attn_halves_ok` and which
autograd does not record runs the LayerNorm and the qkv projection on B8's
front kernel and the out-projection with the residual on its back kernel,
around that attention route (:func:`_run_block`, and EVA-02's block
likewise). The tower is not padded: the attention kernels mask the ragged
key tile themselves.

``use_pallas=False`` (every function here takes it) is the JAX package's XLA
chain on stock PyTorch calls and launches no hand-written kernel: the
attention through ``ops.attention.library_sdpa`` after the cuBLAS
projections, the MLP as ``x + mlp_block(layer_norm(x))`` (JAX's
``_xla_chain``; int8 weights keep ``int8_linear``, without B3), the
``fused_mlp`` switch ignored. It is reached only when a caller passes it.
The port's default is ``True``, where JAX's is ``False``: the port's main
path runs its kernels.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs import CLIPConfig, Eva02VisionConfig, ResNetVisionConfig, TextConfig, VisionConfig
from ..ops import attention as attn_ops
from ..ops import custom_ops
from ..ops.attn_block import ln_attn_back, ln_attn_front, ln_attn_halves_ok
from ..ops.fused_mlp import (
    ln_mlp_residual,
    ln_mlp_residual_frozen,
    ln_mlp_residual_int8,
    ln_mlp_residual_int8_ok,
)
from ..ops.layers import (
    ACTIVATIONS,
    frozen_layout,
    layer_norm,
    linear,
    linear_partial,
    mlp_block,
    norm_preserving_blend,
    simple_adapter,
)
from ..ops.rope import rope_qk, rope_qk_reference, rope_table
from ..ops.swiglu import layer_norm_rows, ln_swiglu_residual, swiglu_mlp
from ..parallel.collectives import copy_to_model, sum_from_model
from ..parallel.mesh import TensorParallelBlock
from ..utils.profiling import count

def patchify(params, images, patch_size: int):
    """(B, 3, H, W) -> (B, L, width) via reshape + matmul (== strided conv)."""
    b, c, h, w = images.shape
    gh, gw = h // patch_size, w // patch_size
    x = images.reshape(b, c, gh, patch_size, gw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, gh * gw, c * patch_size * patch_size)
    return linear(params["patch_embed"], x)


def _run_block(block, x, num_heads, act, attn_mask=None, vv=False,
               valid_len=None, fused_mlp=True, use_pallas=True):
    """Pre-norm residual attention block. ``vv`` selects the CLIP-Surgery
    value-value attention. An unmasked block where ``ln_attn_halves_ok``
    holds (int8 attention weights fail it), autograd records nothing and
    ``vv`` is off runs its attention half as B8's front (the LayerNorm pass
    and the qkv product), the routed attention kernel and B8's back (the
    out-projection with the residual, rounded once), counted
    ``attn.proj_fused``. Every other unmasked block runs the chain
    (LayerNorm, cuBLAS projections, attention, residual add), counted
    ``attn.proj_chain``; a masked one (the text tower) too, and the stock
    route, uncounted.
    ``fused_mlp="frozen"`` takes the fused MLP whose backward is the dx-only
    kernel: valid only while the block's parameters carry no gradient (it
    raises otherwise). ``use_pallas=False``: the stock PyTorch chain (module
    docstring). A :class:`..parallel.mesh.TensorParallelBlock` runs
    :func:`_run_tp_block`."""
    if isinstance(block, TensorParallelBlock):
        return _run_tp_block(block, x, num_heads, act, attn_mask=attn_mask, vv=vv,
                             valid_len=valid_len, use_pallas=use_pallas)
    if not use_pallas:
        h = layer_norm(block["ln_1"], x)
        if vv:
            x = x + attn_ops.vv_attention(block["attn"], h, num_heads, use_pallas=False)
        else:
            x = x + attn_ops.mha(block["attn"], h, num_heads, attn_mask=attn_mask,
                                 use_pallas=False)
        return x + mlp_block(block["mlp"], layer_norm(block["ln_2"], x), act)
    attn = block["attn"]
    if (attn_mask is None and not vv and ln_attn_halves_ok(x, attn)
            and not _records_grad(block, x)):
        count("attn.proj_fused")
        qkv = ln_attn_front(block["ln_1"], _f32_bias(attn["qkv"]), x)
        x = ln_attn_back(_f32_bias(attn["out"]),
                         attn_ops.attend_qkv(qkv, num_heads, valid_len=valid_len), x)
    else:
        if attn_mask is None:
            count("attn.proj_chain")
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


def _float32(t):
    return t.float()


def _f32_bias(params):
    """A projection's ``{w, b}`` with its bias in float32, as the kernels read
    it: made once per frozen bias (``layers.frozen_layout``), so that a
    graph's replay runs no cast; in a trace the cast is an op of the trace."""
    b = params["b"]
    if b.dtype != torch.float32:
        b = b.float() if custom_ops.is_traced(b) else frozen_layout(_float32, b)
    return {"w": params["w"], "b": b}


def _qkv_bias(q_b, v_b):
    """EVA-02's packed projection bias ``[q | 0 | v]`` in float32."""
    return torch.cat((q_b.float(), torch.zeros_like(q_b, dtype=torch.float32), v_b.float()))


def _records_grad(block, x) -> bool:
    """Whether autograd records a block's call on x: x or one of the block's
    tensors needs a gradient while gradients are enabled."""
    if not torch.is_grad_enabled():
        return False
    stack = [x, block]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


def _run_eva02_block(block, x, num_heads, act=None, attn_mask=None, vv=False, valid_len=None,
                     fused_mlp=True, use_pallas=True, *, rope, eps):
    """EVA-02's block (the module docstring): ``rope`` is the rotary table of
    the rows' patches (``ops.rope``), ``eps`` the LayerNorms'.
    ``use_pallas`` runs LN1 and the qkv projection on B8's front kernel,
    the rotation kernel (in place on the projection), the attention kernels
    as CLIP's block runs them (B1, or B7 above 8,192 tokens), the sub-LN on
    ``ln_swiglu_residual``'s LayerNorm pass, the out-projection with the
    residual on B8's back kernel and ``ln_swiglu_residual`` for the MLP
    half, each the plain version on the CPU. A call that fails
    ``ln_attn_halves_ok`` (on the card every published width passes it;
    the tests' float32 tower of width 64 does not) runs LN1 and the sub-LN
    on the LayerNorm pass and both projections on cuBLAS instead, around
    the same rotation and attention, so that the tiny tower holds those
    plain versions to the reference. The attention half is counted
    ``attn.proj_fused`` or ``attn.proj_chain`` as CLIP's, under
    ``use_pallas`` only. ``use_pallas=False``, and a call whose x or block
    weights autograd records (training: the adapters below need x's
    gradient), run the stock chain (SDPA on the card), as these kernels
    have no backward. ``act`` and ``fused_mlp`` are CLIP's and unused:
    SwiGLU is the block's own. Value-value attention and masks are CLIP's
    text and surgery paths, not this tower's."""
    if vv or attn_mask is not None:
        raise NotImplementedError("EVA-02 blocks run plain self-attention only")
    count("blocks.eva02")
    kernels = use_pallas and not _records_grad(block, x)
    attn = block["attn"]
    fused = kernels and ln_attn_halves_ok(x, attn)
    if use_pallas:
        count("attn.proj_fused" if fused else "attn.proj_chain")
    norm = layer_norm_rows if kernels else layer_norm
    if kernels:
        qkv_p = {"w": attn["qkv"]["w"],
                 "b": frozen_layout(_qkv_bias, attn["q"]["b"], attn["v"]["b"])}
        if fused:
            qkv = ln_attn_front(block["ln_1"], qkv_p, x, eps=eps)
        else:
            qkv = linear(qkv_p, norm(block["ln_1"], x, eps=eps))
        qkv = rope_qk(qkv, rope, num_heads)
    else:
        qkv = linear({"w": attn["qkv"]["w"], "b": _qkv_bias(attn["q"]["b"], attn["v"]["b"])},
                     layer_norm(block["ln_1"], x, eps=eps))
        qkv = rope_qk_reference(qkv, rope, num_heads)
    a = norm(attn["ln"], attn_ops.attend_qkv(qkv, num_heads, valid_len=valid_len,
                                             use_pallas=kernels), eps=eps)
    x = ln_attn_back(_f32_bias(attn["out"]), a, x) if fused else x + linear(attn["out"], a)
    if kernels:
        count("mlp.swiglu_fused")
        return ln_swiglu_residual(block["ln_2"], block["mlp"], x, eps=eps, ffn_eps=eps)
    count("mlp.swiglu_chain")
    return x + swiglu_mlp(block["mlp"], layer_norm(block["ln_2"], x, eps=eps), eps)


def _row_parallel(params, x, group):
    """A row-split projection: this rank's float32 partial product, summed
    over ``group``, then the replicated float32 bias and one rounding to
    x's dtype, as :func:`..ops.layers.linear` rounds the whole product."""
    y = sum_from_model(linear_partial(params, x), group)
    return (y + params["b"].float()).to(x.dtype)


def _run_tp_block(block, x, num_heads, act, attn_mask=None, vv=False,
                  valid_len=None, use_pallas=True):
    """One rank's share of a Megatron tensor-parallel block
    (``parallel.mesh.shard_backbone``): ``num_heads / n_model`` heads and a
    ``1 / n_model`` share of the MLP's hidden units.

    Attention: LayerNorm, the column-split qkv projection (``[q_r | k_r |
    v_r]``), attention over the rank's heads through the same route as the
    whole block (the packed kernel, B1, where its gate holds; its backward
    B4), the row-split out-projection's float32 partial sums summed over the
    'model' ranks before the bias and the one rounding. MLP: LayerNorm, the
    two cuBLAS products on the hidden share, the sum, the bias and the
    residual. The fused MLP kernels (B2, its dx backward B5, and the int8
    B3) add the residual inside GEMM 2, so they cannot stand in for a
    partial sum, and the fused attention half (B8) holds whole heads: none
    of them runs under tensor parallelism, as the JAX package shards only
    its XLA route. The collectives are autograd functions: the copy into
    each column-split layer sums the input's gradient over the ranks
    backward, and the row-split sum passes its gradient through, so a frozen
    block backpropagates to the adapters below it."""
    group = block.group
    heads = num_heads // block.n_model
    h = copy_to_model(layer_norm(block["ln_1"], x), group)
    if vv:
        a = attn_ops.vv_heads(block["attn"], h, heads, valid_len=valid_len,
                              use_pallas=use_pallas)
    else:
        a = attn_ops.mha_heads(block["attn"], h, heads, attn_mask=attn_mask,
                               valid_len=valid_len, use_pallas=use_pallas)
    x = x + _row_parallel(block["attn"]["out"], a, group)
    mlp = block["mlp"]
    h = copy_to_model(layer_norm(block["ln_2"], x), group)
    return x + _row_parallel(mlp["c_proj"], act(linear(mlp["c_fc"], h)), group)


def embed_patches(params, cfg: VisionConfig, images, compute_dtype,
                  keep_idx=None):
    """Patch embedding, class token, positional embedding and ln_pre (none
    in an EVA-02 tower): (B, 3, H, W) -> (B, L+1, width), the input of the
    first block. ``keep_idx`` (B, K): patch-dropout kept-token indices
    (``ops.layers.patch_dropout_indices``), applied after the positional
    embedding and before ln_pre; the class token is always kept."""
    x = patchify(params, images.to(compute_dtype), cfg.patch_size)
    cls = params["class_embedding"].to(compute_dtype).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    x = x + params["positional_embedding"].to(compute_dtype)
    if keep_idx is not None:
        idx = keep_idx[..., None].expand(-1, -1, x.shape[-1])
        x = torch.cat([x[:, :1], torch.gather(x[:, 1:], 1, idx)], dim=1)
    if isinstance(cfg, Eva02VisionConfig):
        return x
    return layer_norm(params["ln_pre"], x)


def ln_eps(cfg: VisionConfig) -> float:
    """The vision tower's LayerNorm eps: EVA-02's, or CLIP's 1e-5."""
    return cfg.ln_eps if isinstance(cfg, Eva02VisionConfig) else 1e-5


def pool(params, cfg: VisionConfig, x):
    """The pooled embedding of the class token of the last block's output
    ``x``: ln_post, then ``proj`` (an EVA-02 tower: ``head``, with a
    bias)."""
    pooled = layer_norm(params["ln_post"], x[:, 0], eps=ln_eps(cfg))
    if isinstance(cfg, Eva02VisionConfig):
        return linear(params["head"], pooled)
    return linear({"w": params["proj"]}, pooled)


def block_runner(cfg: VisionConfig, device, keep_idx=None):
    """The function that runs one of the tower's blocks, as
    :func:`run_blocks` calls it: :func:`_run_block`, or for an EVA-02 tower
    :func:`_run_eva02_block` with its rotary table for the grid (made once,
    ``ops.rope.rope_table``; the kept patches' rows under patch dropout)."""
    if not isinstance(cfg, Eva02VisionConfig):
        return _run_block
    rope = rope_table(cfg.grid, cfg.rope_ref_grid, cfg.head_width, device)
    if keep_idx is not None:
        rope = rope[:, keep_idx]           # (2, B, K, hd): each sample's kept patches
    return functools.partial(_run_eva02_block, rope=rope, eps=cfg.ln_eps)


def run_blocks(blocks, x, num_heads: int, act, attn_mask=None, vv_from=None,
               adapters=None, adapter_weight: float = 0.0, adapt_until: int = 0,
               out_layers: Sequence[int] = (), start: int = 0, stop=None,
               remat: bool = False, fused_mlp=True, use_pallas=True, run_block=_run_block):
    """Run blocks [start, stop) in order (all by default), each through
    ``run_block`` (:func:`block_runner`'s for a vision tower). Blocks
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
            y = run_block(blocks[i], x, num_heads, act, attn_mask=attn_mask,
                          vv=vv_from is not None and i >= vv_from,
                          fused_mlp=fused_mlp, use_pallas=use_pallas)
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
    use_pallas=True,
):
    """ViT forward with multi-depth taps.

    out_layers: 1-based layer indices whose full token outputs (incl. CLS)
    are collected. vv_from: 0-based first value-value block. adapters: list
    of SimpleAdapter params applied after blocks [0, adapt_until). remat:
    checkpoint each block in the backward. keep_idx: (B, K) patch-dropout
    kept-token indices; the taps then carry K+1 tokens. fused_mlp: True, or
    "frozen" for the dx-only backward (see :func:`_run_block`). use_pallas:
    False for the stock PyTorch route (module docstring).

    Returns: (pooled (B, output_dim), taps list of (B, L+1, width), final x).
    """
    x = embed_patches(params, cfg, images, compute_dtype, keep_idx=keep_idx)
    x, taps = run_blocks(params["blocks"], x, cfg.heads, ACTIVATIONS[act_name],
                         vv_from=vv_from, adapters=adapters,
                         adapter_weight=adapter_weight, adapt_until=adapt_until,
                         out_layers=out_layers, remat=remat, fused_mlp=fused_mlp,
                         use_pallas=use_pallas,
                         run_block=block_runner(cfg, x.device, keep_idx))
    return pool(params, cfg, x), taps, x


def encode_image(params, cfg: CLIPConfig, images, compute_dtype=torch.float32,
                 use_pallas: bool = True):
    """CLIP.encode_image: the pooled image embedding of either tower, the
    ViT (``use_pallas`` as in :func:`vision_forward`) or, for a
    ``ResNetVisionConfig``, the ModifiedResNet (stock PyTorch calls either
    way, ``models/modified_resnet.py``)."""
    if isinstance(cfg.vision, ResNetVisionConfig):
        from .modified_resnet import resnet_forward

        pooled, _ = resnet_forward(params["visual"], cfg.vision, images,
                                   compute_dtype=compute_dtype)
        return pooled
    pooled, _, _ = vision_forward(params["visual"], cfg.vision, images,
                                  act_name=cfg.act, compute_dtype=compute_dtype,
                                  use_pallas=use_pallas)
    return pooled


def dual_vision_features(params, cfg: VisionConfig, images,
                         out_layers: Sequence[int], vv_from: int,
                         act_name: str = "gelu", compute_dtype=torch.float32,
                         use_pallas=True):
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
    run_block = block_runner(cfg, x.device)
    x, taps = run_blocks(blocks, x, cfg.heads, act, out_layers=out_layers,
                         stop=vv_from, use_pallas=use_pallas, run_block=run_block)
    _, vv_taps = run_blocks(blocks, x, cfg.heads, act, vv_from=vv_from,
                            out_layers=out_layers, start=vv_from, use_pallas=use_pallas,
                            run_block=run_block)
    xp, _ = run_blocks(blocks, x, cfg.heads, act, start=vv_from, use_pallas=use_pallas,
                       run_block=run_block)
    return pool(params, cfg, xp), taps + vv_taps


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
    use_pallas=True,
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
                      adapter_weight=adapter_weight, adapt_until=adapt_until,
                      use_pallas=use_pallas)
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
