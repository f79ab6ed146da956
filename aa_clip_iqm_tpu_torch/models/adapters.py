"""AdaptedCLIP — frozen CLIP + trainable adapters, on tensors.

Counterpart of ``aa_clip_iqm_tpu/models/adapters.py``. Trainable layout (as
the JAX pytree, with stacked layer axes as lists):
  {
    "image_adapter": {"layer_adapters": [{w}], "seg_proj": [{w}], "det_proj": {w}},
    "text_adapter":  {"layers": [{w}], "proj": {w}},
    "iqm": {...},                       # models/iqm.py
    "class_query_mlp": {"fc1", "fc2"},
    "query_adapters": [{w}],
    "pos_embedding": (1, 2, hidden),
    "visual_feature_proj": {w, b},
    "text_feature_proj": {w, b},
    "query_proj": {w, b},
    "iqm_layer_norm": {scale, bias},
  }
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import torch

from ..configs import ModelConfig
from ..ops.layers import (
    l2_normalize,
    layer_norm,
    leaky_relu,
    linear,
    patch_dropout_indices,
    simple_proj,
)
from . import clip as clip_model
from . import iqm as iqm_model


@dataclass
class AdaptedOutputs:
    seg_tokens: List[Any]        # per level: (B, L, embed_dim), L2-normalized
    det_token: Any               # (B, embed_dim), L2-normalized + mean-pooled
    iqm_queries: Optional[Any]   # (B, 2, iqm_hidden) or None
    cls_raw: Any                 # (B, width) final-block CLS (pre ln_post)
    keep_idx: Optional[Any] = None  # (B, K) patch-dropout kept indices


def encode_image_adapted(frozen, trainable, cfg: ModelConfig, images,
                         text_anchors=None, compute_dtype=torch.float32,
                         remat: bool = False, patch_drop_rng=None,
                         fused_mlp=True, use_pallas=True) -> AdaptedOutputs:
    """AdaptedCLIP.forward. text_anchors: (B, embed_dim, 2) per-sample
    anchors, or None to skip IQM. remat: checkpoint the tower's blocks in
    the backward. patch_drop_rng: a ``torch.Generator`` that switches patch
    dropout on at the configured rate (``cfg.clip.vision.patch_dropout``),
    or a ready (B, K) index tensor; seg_tokens then carry K < L tokens and
    ``keep_idx`` maps them back to grid cells. fused_mlp: True, or "frozen"
    for the dx-only backward through the frozen backbone's MLPs.
    use_pallas: False for the stock PyTorch route with no hand-written
    kernel (``models.clip``; the port's default is True, JAX's False)."""
    a = cfg.adapter
    vis = frozen["visual"]
    ia = trainable["image_adapter"]

    keep_idx = None
    rate = cfg.clip.vision.patch_dropout
    if patch_drop_rng is not None and rate > 0.0:
        if isinstance(patch_drop_rng, torch.Tensor):
            keep_idx = patch_drop_rng
        else:
            keep_idx = patch_dropout_indices(
                patch_drop_rng, images.shape[0], cfg.clip.vision.num_patches,
                rate, device=images.device)

    _, taps, x_final = clip_model.vision_forward(
        vis, cfg.clip.vision, images, out_layers=tuple(a.levels),
        act_name=cfg.clip.act, adapters=ia["layer_adapters"],
        adapter_weight=a.image_adapt_weight, adapt_until=a.image_adapt_until,
        compute_dtype=compute_dtype, remat=remat, keep_idx=keep_idx,
        fused_mlp=fused_mlp, use_pallas=use_pallas,
    )

    # Patch tokens (CLS dropped) -> frozen ln_post.
    eps = clip_model.ln_eps(cfg.clip.vision)
    tokens = [layer_norm(vis["ln_post"], t[:, 1:, :], eps=eps) for t in taps]

    seg_tokens = [
        l2_normalize(simple_proj(ia["seg_proj"][i], t, a.relu))
        for i, t in enumerate(tokens)
    ]
    det = simple_proj(ia["det_proj"], tokens[-1], a.relu)
    det_token = l2_normalize(det).mean(dim=1)

    iqm_queries = None
    if text_anchors is not None:
        iqm_queries = _iqm_branch(trainable, cfg, tokens, x_final, text_anchors)

    return AdaptedOutputs(seg_tokens=seg_tokens, det_token=det_token,
                          iqm_queries=iqm_queries, cls_raw=x_final[:, 0],
                          keep_idx=keep_idx)


def _iqm_branch(trainable, cfg: ModelConfig, tokens, x_final, text_anchors):
    """IQM query pipeline with trained projections."""
    mlp = trainable["class_query_mlp"]
    cls_feature = x_final[:, 0]                                 # (B, width)
    q = linear(mlp["fc2"], torch.relu(linear(mlp["fc1"], cls_feature)))
    class_query = q[:, None, :].repeat(1, 2, 1)                  # (B, 2, hidden)
    query_embeds = class_query + trainable["pos_embedding"][:, :2, :].to(q.dtype)

    projected = [
        simple_proj(trainable["query_adapters"][i], t, cfg.adapter.relu)
        for i, t in enumerate(tokens)
    ]
    visual = torch.cat(projected, dim=1)                         # (B, 4L, hidden)
    visual = linear(trainable["visual_feature_proj"], visual)

    # (B, embed_dim, 2) -> (B, 2, embed_dim): the normal / abnormal anchors
    # as two text tokens, through the trained projection.
    text = text_anchors.transpose(-1, -2)
    text = linear(trainable["text_feature_proj"], text.to(visual.dtype))

    out = iqm_model.iqm_forward(trainable["iqm"], cfg.iqm, query_embeds,
                                visual, text)
    # Adapter-level LN: torch-default eps 1e-5, not IQM's 1e-12.
    return layer_norm(trainable["iqm_layer_norm"], out, eps=1e-5)


def project_queries(trainable, queries):
    """IQM queries (B, 2, hidden) -> (B, 2, embed_dim), trained projection."""
    return linear(trainable["query_proj"], queries)


def encode_text_adapted(frozen, trainable, cfg: ModelConfig, tokens,
                        compute_dtype=torch.float32, use_pallas=True):
    """AdaptedCLIP.encode_text: adapters with the norm-preserving blend on the
    first text_adapt_until layers; SimpleProj(relu=True) replaces CLIP's
    text_projection."""
    a = cfg.adapter
    ta = trainable["text_adapter"]

    def final_proj(pooled):
        return leaky_relu(linear(ta["proj"], pooled))

    return clip_model.text_forward(
        frozen["text"], cfg.clip.text, tokens, act_name=cfg.clip.act,
        adapters=ta["layers"], adapter_weight=a.text_adapt_weight,
        adapt_until=a.text_adapt_until, final_proj=final_proj,
        compute_dtype=compute_dtype, use_pallas=use_pallas,
    )


def encode_text_frozen(frozen, cfg: ModelConfig, tokens,
                       compute_dtype=torch.float32, use_pallas=True):
    """Raw CLIP text encoding."""
    return clip_model.text_forward(
        frozen["text"], cfg.clip.text, tokens, act_name=cfg.clip.act,
        compute_dtype=compute_dtype, use_pallas=use_pallas,
    )
