"""Model assembly: config + backbone weights + adapter init.

Counterpart of ``aa_clip_iqm_tpu/loader.py``: :func:`build_model_config`,
:func:`load_frozen_backbone` (a converted ``.npz`` weight cache, or with
``allow_random`` a seeded random backbone, the ``--random_backbone`` of the
CLIs) and :func:`init_trainable`. Converting OpenAI ``.pt`` weights is not
ported yet: convert them to ``.npz`` with the JAX package.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .configs import (
    AdapterConfig,
    IQMConfig,
    ModelConfig,
    get_model_config,
    tiny_test_config,
)
from .models.convert import (
    find_backbone,
    init_adapter_params_np,
    init_clip_params_np,
    load_params_npz,
    params_from_jax,
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
    if model_name == "tiny-test":
        cfg = tiny_test_config(img_size)
        if patch_dropout:
            vision = replace(cfg.clip.vision, patch_dropout=patch_dropout)
            cfg = replace(cfg, clip=replace(cfg.clip, vision=vision))
        return cfg
    clip_cfg = get_model_config(model_name, img_size=img_size)
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
        ),
        surgery_until_layer=surgery_until_layer,
    )


def random_backbone(cfg: ModelConfig, seed: int = 0, device="cuda",
                    dtype=torch.bfloat16):
    """Seeded random frozen CLIP params at the config's full width."""
    frozen, _ = params_from_jax(init_clip_params_np(cfg, seed), None, cfg,
                                device=device, dtype=dtype)
    return frozen


def load_frozen_backbone(cfg: ModelConfig, backbone_path: Optional[str] = None,
                         allow_random: bool = False, seed: int = 0,
                         device="cuda", dtype=torch.bfloat16):
    """Load (or randomly init) the frozen CLIP params for cfg.clip, onto
    ``device`` with the matmul weights in ``dtype``."""
    path = backbone_path or find_backbone()
    if path is None:
        if not allow_random:
            raise FileNotFoundError(
                "No CLIP backbone checkpoint found. Provide --backbone "
                "pointing to a converted .npz of the OpenAI "
                "ViT-L-14-336px weights, or pass allow_random for an "
                "untrained backbone.")
        return random_backbone(cfg, seed=seed, device=device, dtype=dtype)
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz weight caches are read so far; converting "
            "an OpenAI .pt checkpoint is not ported yet (convert it with "
            "aa_clip_iqm_tpu.models.convert and save_params_npz)")
    params = load_params_npz(path)
    pos = np.asarray(params["visual"]["positional_embedding"])
    want = cfg.clip.vision.grid ** 2 + 1
    if pos.shape[0] != want:
        raise NotImplementedError(
            f"{path} holds a {pos.shape[0]}-row positional embedding, the "
            f"config wants {want}: resizing it is not ported yet; cache the "
            "weights at this image size")
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
    _, trainable = params_from_jax(None, init_adapter_params_np(cfg, seed), cfg,
                                   device=device, dtype=dtype)
    if requires_grad:
        for t in tree_leaves(trainable):
            t.requires_grad_(True)
    return trainable
