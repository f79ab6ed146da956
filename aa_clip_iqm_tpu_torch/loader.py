"""Model assembly: config + backbone weights + adapter init.

Counterpart of ``aa_clip_iqm_tpu/loader.py``: :func:`build_model_config`,
:func:`load_frozen_backbone` (an OpenAI ``.pt`` checkpoint, converted on
the CPU and cached beside it as ``<stem>.<image_size>.npz``; a converted
``.npz`` weight cache, whose positional embedding is resized bicubically if
it was saved at another grid; or with ``allow_random`` a seeded random
backbone, the ``--random_backbone`` of the CLIs) and :func:`init_trainable`.
"""
from __future__ import annotations

import os
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .configs import (
    AdapterConfig,
    Eva02VisionConfig,
    IQMConfig,
    ModelConfig,
    ResNetVisionConfig,
    SiglipVisionConfig,
    get_model_config,
    is_port_model,
    tiny_eva02_config,
    tiny_eva_postnorm_config,
    tiny_siglip_config,
    tiny_test_config,
)
from .models.clip import resize_pos_embed_np
from .models.convert import (
    find_backbone,
    init_adapter_params_np,
    init_clip_params_np,
    load_openai_checkpoint,
    load_params_npz,
    params_from_jax,
    save_params_npz,
    tree_leaves,
)


def build_model_config(model_name: str = "ViT-L-14-336", img_size: int = 518,
                       relu: bool = False, text_adapt_weight: float = 0.1,
                       image_adapt_weight: float = 0.1,
                       text_adapt_until: int = 3, image_adapt_until: int = 6,
                       levels=(6, 12, 18, 24), iqm_hidden_size: int = 512,
                       iqm_num_layers: int = 2, iqm_num_heads: int = 8,
                       surgery_until_layer: int = 20,
                       patch_dropout: float = 0.0) -> ModelConfig:
    tiny = {"tiny-test": tiny_test_config, "tiny-eva02-test": tiny_eva02_config,
            "tiny-eva-postnorm-test": tiny_eva_postnorm_config,
            "tiny-siglip-test": tiny_siglip_config}
    if model_name in tiny:
        cfg = tiny[model_name](img_size)
        if patch_dropout:
            vision = replace(cfg.clip.vision, patch_dropout=patch_dropout)
            cfg = replace(cfg, clip=replace(cfg.clip, vision=vision))
        return cfg
    clip_cfg = get_model_config(model_name, img_size=img_size)
    if isinstance(clip_cfg.vision, ResNetVisionConfig):
        # A ModifiedResNet backbone serves encode_image and the text tower
        # only: AdaptedCLIP taps ViT blocks.
        red = clip_cfg.vision.reduction
        if img_size % red:
            raise ValueError(
                f"img_size {img_size} must be a multiple of the ResNet "
                f"reduction {red} (e.g. {img_size // red * red})")
        return ModelConfig(clip=clip_cfg)
    if patch_dropout:
        clip_cfg = replace(clip_cfg, vision=replace(clip_cfg.vision,
                                                    patch_dropout=patch_dropout))
    patch = clip_cfg.vision.patch_size
    if img_size % patch:
        raise ValueError(
            f"img_size {img_size} must be a multiple of the patch size "
            f"{patch} (e.g. {img_size // patch * patch} or "
            f"{(img_size // patch + 1) * patch})")
    return ModelConfig(
        clip=clip_cfg,
        adapter=AdapterConfig(
            text_adapt_weight=text_adapt_weight,
            image_adapt_weight=image_adapt_weight,
            text_adapt_until=text_adapt_until,
            image_adapt_until=image_adapt_until,
            levels=tuple(levels),
            relu=relu,
        ),
        iqm=IQMConfig(
            hidden_size=iqm_hidden_size,
            num_hidden_layers=iqm_num_layers,
            num_attention_heads=iqm_num_heads,
            encoder_hidden_size=iqm_hidden_size,
            # IQM's text cross-attention reads the anchors, embed_dim wide;
            # the JAX package's models keep its 768.
            **({"text_encoder_hidden_size": clip_cfg.embed_dim}
               if is_port_model(model_name) else {}),
        ),
        surgery_until_layer=surgery_until_layer,
    )


def random_backbone(cfg: ModelConfig, seed: int = 0, device="cuda",
                    dtype=torch.bfloat16):
    """Seeded random frozen CLIP params at the config's full width. On the
    meta device only their shapes are made, and no memory is taken."""
    meta = torch.device(device).type == "meta"
    frozen, _ = params_from_jax(init_clip_params_np(cfg, seed, shapes_only=meta), None, cfg,
                                device=device, dtype=dtype)
    return frozen


def _openai_params(cfg: ModelConfig, path: str, cache_npz: bool):
    """An OpenAI ``.pt`` -> numpy params, through the per-resolution cache
    ``<stem>.<image_size>.npz`` beside it. The cache holds the converted
    params with the positional embedding already resized, in the JAX key
    layout (blocks stacked), so either package reads the other's. It is
    trusted only when it is at least as new as the ``.pt``;
    ``cache_npz=False`` neither reads nor writes it, and a cache that cannot
    be written is skipped."""
    cache = f"{os.path.splitext(path)[0]}.{cfg.clip.vision.image_size}.npz"
    if (cache_npz and os.path.isfile(cache)
            and os.path.getmtime(cache) >= os.path.getmtime(path)):
        return load_params_npz(cache)
    params = load_openai_checkpoint(path, cfg.clip)
    if cache_npz:
        try:
            save_params_npz(params, cache)
        except OSError:
            pass
    return params


def load_frozen_backbone(cfg: ModelConfig, backbone_path: Optional[str] = None,
                         allow_random: bool = False, seed: int = 0,
                         device="cuda", dtype=torch.bfloat16,
                         cache_npz: bool = True):
    """Load (or randomly init) the frozen CLIP params for cfg.clip, onto
    ``device`` with the matmul weights in ``dtype``: from an ``.npz`` weight
    cache, or from an OpenAI ``.pt`` through its per-resolution cache (see
    :func:`_openai_params`)."""
    path = backbone_path or find_backbone()
    if path is None:
        if not allow_random:
            raise FileNotFoundError(
                "No CLIP backbone checkpoint found. Provide --backbone "
                "pointing to the OpenAI ViT-L-14-336px.pt (or a converted "
                ".npz), or pass allow_random for an untrained backbone.")
        return random_backbone(cfg, seed=seed, device=device, dtype=dtype)
    kind = {Eva02VisionConfig: "EVA-CLIP", SiglipVisionConfig: "SigLIP"}.get(type(cfg.clip.vision))
    if kind and not path.endswith(".npz"):
        raise NotImplementedError(f"{path}: the port reads no {kind} checkpoint yet; give it "
                                  "an .npz of its own layout, or a random backbone")
    if path.endswith(".npz"):
        params = load_params_npz(path)
        # An .npz cache may hold another grid's positional embedding (the
        # checkpoint's native one): resize it bicubically to the config's
        # (the ViT's, or the ModifiedResNet's attention pool's).
        vis = params["visual"]
        holder = vis if "positional_embedding" in vis else vis["attnpool"]
        pos = np.asarray(holder["positional_embedding"])
        v = cfg.clip.vision
        class_token = getattr(v, "class_token", True)      # a ModifiedResNet's pool has one
        if pos.shape[0] != v.grid ** 2 + class_token:
            holder["positional_embedding"] = resize_pos_embed_np(pos, v.grid, class_token)
    else:
        params = _openai_params(cfg, path, cache_npz)
    frozen, _ = params_from_jax(params, None, cfg, device=device, dtype=dtype)
    return frozen


def init_trainable(cfg: ModelConfig, seed: int = 111, device="cuda",
                   dtype=torch.bfloat16, requires_grad: bool = False):
    """Seeded random (untrained) adapter / IQM params. ``dtype`` is that of
    the matrices: bf16 suits serving; a trainer passes ``torch.float32`` and
    ``requires_grad=True`` for float32 master weights (``ops.layers.linear``
    casts them to the compute dtype at each call, which autograd
    differentiates), while the frozen backbone stays bf16 and never requires
    grad."""
    meta = torch.device(device).type == "meta"
    _, trainable = params_from_jax(None, init_adapter_params_np(cfg, seed, shapes_only=meta),
                                   cfg, device=device, dtype=dtype)
    if requires_grad:
        for t in tree_leaves(trainable):
            t.requires_grad_(True)
    return trainable
