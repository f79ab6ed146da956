"""Configuration dataclasses + JSON model-config registry.

Counterpart of ``aa_clip_iqm_tpu/configs.py``: the same dataclasses, field
names and defaults, and the same JSON schema (``embed_dim`` / ``vision_cfg``
/ ``text_cfg``) read from this package's own ``registry/model_configs``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "registry", "model_configs")


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    head_width: int = 64
    mlp_ratio: float = 4.0
    output_dim: int = 768
    patch_dropout: float = 0.0

    @property
    def heads(self) -> int:
        return self.width // self.head_width

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


@dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    output_dim: int = 768


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 768
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    # Exact (erf) GELU, as the live reference model runs; "quick_gelu" stays
    # available.
    act: str = "gelu"


@dataclass(frozen=True)
class AdapterConfig:
    text_adapt_weight: float = 0.1
    image_adapt_weight: float = 0.1
    text_adapt_until: int = 3
    image_adapt_until: int = 6
    levels: Sequence[int] = (6, 12, 18, 24)
    relu: bool = False


@dataclass(frozen=True)
class IQMConfig:
    hidden_size: int = 512
    num_hidden_layers: int = 2
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12
    cross_attention_frequency: int = 1
    encoder_hidden_size: int = 512
    text_encoder_hidden_size: int = 768
    fuse_self: float = 0.4
    fuse_visual: float = 0.3
    fuse_text: float = 0.3

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


@dataclass(frozen=True)
class ModelConfig:
    clip: CLIPConfig = field(default_factory=CLIPConfig)
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    iqm: IQMConfig = field(default_factory=IQMConfig)
    surgery_until_layer: int = 20


@dataclass
class TrainConfig:
    """Two-stage training schedule (reference train.py:240-286, 335-353)."""

    dataset: str = "VisA"
    img_size: int = 518
    training_mode: str = "few_shot"  # or full_shot
    shot: int = 32
    text_batch_size: int = 16
    image_batch_size: int = 2
    text_epoch: int = 5
    image_epoch: int = 20
    text_lr: float = 1e-5
    image_lr: float = 5e-4
    iqm_lr_scale: float = 0.1
    image_weight_decay: float = 1e-4
    iqm_weight_decay: float = 1e-3
    text_norm_weight: float = 0.1  # orthogonality regularizer
    iqm_loss_weight: float = 0.4
    text_loss_weight: float = 0.6
    det_loss_weight: float = 0.5
    seed: int = 111
    save_path: str = "ckpt/baseline"
    # The reference's stage-1 loop reassigns the loss so that only the deepest
    # tapped level backprops. True reproduces that; False sums all levels.
    stage1_last_level_only: bool = True
    # Global-norm gradient clipping for stage 2. None matches the executed
    # reference, whose clip runs before backward and so never clips.
    clip_grad_norm: Optional[float] = None
    # The reference's schedule quirk: CosineAnnealingLR(T_max=image_epoch)
    # stepped per batch. False runs one cosine over the true step count.
    torch_lr_quirk: bool = False
    compute_dtype: str = "bfloat16"
    # Checkpoint the transformer blocks in the stage-2 backward (memory for
    # recomputation; useful for large image batches).
    remat: bool = False
    # Keep only the last N numbered stage-2 checkpoints (0 = keep all).
    keep_checkpoints: int = 0
    # Mid-epoch checkpoint interval in steps for both stages (0 = off). An
    # interrupted run resumes at (epoch, step) with bit-identical results:
    # an epoch's batch stream is a pure function of (seed, epoch).
    checkpoint_every_steps: int = 0
    # Write step checkpoints on a background thread from device-side
    # snapshots (default); False writes them in the step loop.
    async_step_checkpoint: bool = True
    # Stage-2 gradient accumulation (1 = off): the step runs this many
    # microbatches, so peak activation memory is one microbatch's; exact
    # against the unaccumulated step (train/steps.py).
    grad_accum_steps: int = 1


@dataclass(frozen=True)
class EvalConfig:
    dataset: str = "MVTec"
    img_size: int = 518
    batch_size: int = 32
    seed: int = 111
    save_path: str = "ckpt/baseline"
    visualize: bool = False
    iqm_weight: float = 0.4  # fusion weights (test_last.py:66-68)
    text_weight: float = 0.6
    compute_dtype: str = "bfloat16"
    # Image-level score semantics. "fixed" (default) = per-sample
    # abnormal-channel logit. "reference_eval" = exact transcription of the
    # reference's executed eval path (the whole batch pinned to sample 1's
    # normal channel; needs batch >= 2), for parity studies only.
    image_score_mode: str = "fixed"


def list_models() -> list:
    if not os.path.isdir(_CONFIG_DIR):
        return []
    return sorted(fn[: -len(".json")] for fn in os.listdir(_CONFIG_DIR)
                  if fn.endswith(".json"))


def get_model_config(model_name: str, img_size: Optional[int] = None) -> CLIPConfig:
    """Load a ViT CLIPConfig from the JSON registry, optionally overriding the
    image size."""
    model_name = model_name.replace("/", "-")
    path = os.path.join(_CONFIG_DIR, model_name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"Model config for {model_name!r} not found; available: {list_models()}"
        )
    with open(path) as f:
        raw = json.load(f)
    v, t = raw["vision_cfg"], raw["text_cfg"]
    if isinstance(v["layers"], (list, tuple)):
        raise ValueError(f"{model_name}: ModifiedResNet towers are not ported")
    vision = VisionConfig(
        image_size=img_size or v["image_size"],
        patch_size=v["patch_size"],
        width=v["width"],
        layers=v["layers"],
        head_width=v.get("head_width", 64),
        mlp_ratio=v.get("mlp_ratio", 4.0),
        output_dim=raw["embed_dim"],
        patch_dropout=v.get("patch_dropout", 0.0),
    )
    text = TextConfig(
        context_length=t["context_length"],
        vocab_size=t["vocab_size"],
        width=t["width"],
        heads=t["heads"],
        layers=t["layers"],
        output_dim=raw["embed_dim"],
    )
    return CLIPConfig(
        embed_dim=raw["embed_dim"],
        vision=vision,
        text=text,
        act="quick_gelu" if raw.get("quick_gelu") else "gelu",
    )


def tiny_test_config(img_size: int = 56) -> ModelConfig:
    """A miniature model for unit tests (same dims as the JAX package's)."""
    clip = CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(
            image_size=img_size, patch_size=14, width=64, layers=4, head_width=16,
            output_dim=32,
        ),
        text=TextConfig(
            context_length=77, vocab_size=49408, width=32, heads=4, layers=3,
            output_dim=32,
        ),
    )
    adapter = AdapterConfig(text_adapt_until=1, image_adapt_until=2, levels=(2, 4))
    iqm = IQMConfig(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=32, encoder_hidden_size=16, text_encoder_hidden_size=32,
    )
    return ModelConfig(clip=clip, adapter=adapter, iqm=iqm, surgery_until_layer=4)
