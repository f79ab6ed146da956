"""Configuration dataclasses + JSON model-config registry.

Counterpart of ``aa_clip_iqm_tpu/configs.py``: the same dataclasses, field
names and defaults, and the same JSON schema (``embed_dim`` / ``vision_cfg``
/ ``text_cfg``) read from this package's own ``registry/model_configs``.
The models that the port runs and the JAX package does not (EVA02-CLIP's
vision towers, :class:`Eva02VisionConfig`; SigLIP's towers,
:class:`SiglipVisionConfig` and :class:`SiglipTextConfig`) live apart, in
``registry/port_models``, read after it: ``list_models`` stays the JAX
package's list.

Every vision config states its token layout and its norms, and every text
config its mask, pooling and head: ``class_token``, ``pool``, ``ln_pre`` and
``ln_eps`` (vision), ``causal``, ``pool``, ``head_bias``, ``ln_eps`` and
``mlp_hidden`` (text). CLIP's configs give them as fixed properties, so that
their fields stay the JAX package's; SigLIP's as class constants, beside
the LayerNorm eps and MLP ratio that the registry file gives as fields.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import ClassVar, Optional, Sequence

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "registry", "model_configs")
_PORT_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "registry", "port_models")


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

    # CLIP's token layout and norms (SigLIP's tower sets them as fields).
    @property
    def class_token(self) -> bool:
        """Whether row 0 of the tower's tokens is a class token."""
        return True

    @property
    def pool(self) -> str:
        """The pooled embedding: ``"token"``, the class row through ln_post
        and the projection; ``"map"``, the attention-pool head on every
        row after ln_post."""
        return "token"

    @property
    def ln_pre(self) -> bool:
        return True

    @property
    def ln_eps(self) -> float:
        return 1e-5


@dataclass(frozen=True)
class Eva02VisionConfig(VisionConfig):
    """An EVA-CLIP ViT (EVA-CLIP, arXiv 2303.15389), selected when a
    config's ``vision_cfg`` names an ``eva_model_name``. Either block has,
    beside CLIP's, LayerNorms of eps ``ln_eps`` and q and v projections with
    a bias, k without; the tower has no ln_pre, a bias on its patch
    embedding, and its pooled output goes through a projection with a bias
    (``head``).

    EVA-02's block (the block of arXiv 2303.11331; ``rope``, ``intp_freq``,
    ``naiveswiglu``, ``subln``): 2-D rotary embedding of the patch rows' q
    and k (not the class row's), each head's first half by the patch's row
    and second half by its column, at positions rescaled to a
    ``rope_ref_grid`` x ``rope_ref_grid`` grid (``pt_hw_seq_len``); a
    LayerNorm on the attention's output before the out-projection (sub-LN);
    a SwiGLU MLP of hidden ``mlp_hidden`` with a LayerNorm before its last
    product.

    ``postnorm`` (EVA02-CLIP-E/14+'s ``postnorm`` with none of the above):
    ``x = x + LN1(attn(x))`` then ``x = x + LN2(W2 GELU(W1 x + b1) + b2)``,
    the exact GELU MLP of hidden ``mlp_hidden``, no rotation and no
    sub-LN."""

    rope_ref_grid: int = 16
    postnorm: bool = False
    #: Every LayerNorm's eps (EVA-CLIP's ``partial(LayerNorm, eps=1e-6)``).
    ln_eps: ClassVar[float] = 1e-6
    ln_pre: ClassVar[bool] = False

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclass(frozen=True)
class SiglipVisionConfig(VisionConfig):
    """A SigLIP ViT (Zhai et al., arXiv 2303.15343; timm's
    ``vit_so400m_patch14_siglip_384``): CLIP's pre-norm block with biases on
    every product, at LayerNorm eps ``ln_eps``, the tanh GELU (``CLIPConfig.act``
    ``"gelu_tanh"``) and an MLP of hidden ``int(width * mlp_ratio)``; a
    patch embedding with a bias and no class row (``class_token``), no
    ln_pre, and the attention-pool head (``pool`` ``"map"``: one learned
    probe attends over every row after ln_post, then an MLP with its
    LayerNorm) as the pooled embedding, with no projection after it."""

    class_token: ClassVar[bool] = False
    pool: ClassVar[str] = "map"
    ln_pre: ClassVar[bool] = False
    ln_eps: float = 1e-6

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclass(frozen=True)
class ResNetVisionConfig:
    """ModifiedResNet vision tower (RN50's), selected when a config's
    ``vision_cfg.layers`` is a list."""

    image_size: int = 224
    layers: Sequence[int] = (3, 4, 6, 3)
    width: int = 64
    output_dim: int = 1024
    heads: Optional[int] = None  # None -> width * 32 // 64 (CLIP convention)

    @property
    def num_heads(self) -> int:
        return self.heads if self.heads is not None else self.width * 32 // 64

    @property
    def reduction(self) -> int:
        # stem /4 then a stride-2 entry into each stage after the first
        return 4 * 2 ** (len(self.layers) - 1)

    @property
    def grid(self) -> int:
        return self.image_size // self.reduction

    @property
    def final_channels(self) -> int:
        # last stage planes = width * 2^(stages-1), bottleneck expansion 4
        return self.width * (2 ** (len(self.layers) - 1)) * 4


@dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 768
    heads: int = 12
    layers: int = 12
    output_dim: int = 768

    # CLIP's text tower (SigLIP's sets them as fields).
    @property
    def causal(self) -> bool:
        """Whether each token attends to those before it only."""
        return True

    @property
    def pool(self) -> str:
        """The pooled row: ``"eot"``, the end token's (the row's largest
        id); ``"last"``, the last position's."""
        return "eot"

    @property
    def head_bias(self) -> bool:
        """Whether the pooled row's projection has a bias (``head: {w, b}``
        in ``text_projection``'s place)."""
        return False

    @property
    def ln_eps(self) -> float:
        return 1e-5

    @property
    def mlp_hidden(self) -> int:
        return 4 * self.width


@dataclass(frozen=True)
class SiglipTextConfig(TextConfig):
    """SigLIP's text tower (OpenCLIP's ``text_cfg`` with ``no_causal_mask``,
    ``pool_type`` ``"last"`` and ``proj_bias``): CLIP's pre-norm blocks at
    LayerNorm eps ``ln_eps`` and MLP hidden ``int(width * mlp_ratio)``, no
    mask, the last position pooled after ln_final and projected with a
    bias. Prompts are padded to ``context_length``
    (``tokenizer.tokenize_padded``)."""

    mlp_ratio: float = 4.0
    causal: ClassVar[bool] = False
    pool: ClassVar[str] = "last"
    head_bias: ClassVar[bool] = True
    ln_eps: float = 1e-6

    @property
    def mlp_hidden(self) -> int:
        return int(self.width * self.mlp_ratio)


@dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 768
    vision: VisionConfig = field(default_factory=VisionConfig)
    text: TextConfig = field(default_factory=TextConfig)
    # Exact (erf) GELU, as the live reference model runs; "quick_gelu" stays
    # available; "gelu_tanh" is SigLIP's.
    act: str = "gelu"

    def with_image_size(self, img_size: int) -> "CLIPConfig":
        return dataclasses.replace(
            self, vision=dataclasses.replace(self.vision, image_size=img_size)
        )


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


# The EVA02-CLIP vision settings that select one of the blocks
# Eva02VisionConfig describes: EVA-02's (all four of these set) or the
# post-norm block (``postnorm`` with none of them). Any other combination
# asks for a block the port does not have.
_EVA02_BLOCK = {"rope": True, "intp_freq": True, "naiveswiglu": True, "subln": True}
_EVA_KEYS = (*_EVA02_BLOCK, "postnorm")


def _eva_postnorm(model_name: str, v: dict) -> bool:
    """Which EVA block ``vision_cfg`` ``v`` asks for: False for EVA-02's,
    True for the post-norm block; raises ``NotImplementedError`` naming the
    keys for any other combination."""
    given = {k: bool(v.get(k, False)) for k in _EVA_KEYS}
    if given == {**_EVA02_BLOCK, "postnorm": False}:
        return False
    if given == {**{k: False for k in _EVA02_BLOCK}, "postnorm": True}:
        return True
    raise NotImplementedError(
        f"{model_name}: EVA vision settings {given}; the port has EVA-02's block "
        f"({_EVA02_BLOCK}, no postnorm) and the post-norm block (postnorm alone)")


# What a SigLIP configuration must say: timm's attention pool and no
# projection after it, a tower without a class row or ln_pre, the tanh
# GELU; a bidirectional text tower pooled at its last position, with a
# biased head and the tanh GELU. The port has no other combination of
# these settings.
_SIGLIP_VISION = {"timm_pool": "map", "timm_proj": "none", "class_token": False,
                  "ln_pre": False, "act": "gelu_tanh"}
_SIGLIP_TEXT = {"no_causal_mask": True, "pool_type": "last", "proj_bias": True,
                "act_kwargs": {"approximate": "tanh"}}


def _siglip(model_name: str, raw: dict, img_size: Optional[int]) -> CLIPConfig:
    """A SigLIP configuration (``vision_cfg`` naming a ``timm_model_name``)
    as a CLIPConfig; raises ``NotImplementedError`` naming the keys where
    the settings are another combination than :data:`_SIGLIP_VISION` and
    :data:`_SIGLIP_TEXT`."""
    v, t = raw["vision_cfg"], raw["text_cfg"]
    given = {**{f"vision_cfg.{k}": v.get(k) for k in _SIGLIP_VISION},
             **{f"text_cfg.{k}": t.get(k) for k in _SIGLIP_TEXT}}
    want = {**{f"vision_cfg.{k}": w for k, w in _SIGLIP_VISION.items()},
            **{f"text_cfg.{k}": w for k, w in _SIGLIP_TEXT.items()}}
    if given != want:
        wrong = {k: g for k, g in given.items() if g != want[k]}
        raise NotImplementedError(
            f"{model_name}: SigLIP settings {wrong}; the port has SigLIP's tower as "
            f"{want} only")
    vision = SiglipVisionConfig(
        image_size=img_size or v["image_size"], patch_size=v["patch_size"], width=v["width"],
        layers=v["layers"], head_width=v["head_width"], mlp_ratio=v["mlp_ratio"],
        output_dim=raw["embed_dim"], ln_eps=v["ln_eps"])
    text = SiglipTextConfig(
        context_length=t["context_length"], vocab_size=t["vocab_size"], width=t["width"],
        heads=t["heads"], layers=t["layers"], output_dim=raw["embed_dim"],
        mlp_ratio=t["mlp_ratio"], ln_eps=t["norm_kwargs"]["eps"])
    return CLIPConfig(embed_dim=raw["embed_dim"], vision=vision, text=text, act="gelu_tanh")


def is_port_model(model_name: str) -> bool:
    """Whether ``model_name`` is one of the port's own models
    (``registry/port_models``), not the JAX package's."""
    model_name = model_name.replace("/", "-")
    return (not os.path.isfile(os.path.join(_CONFIG_DIR, model_name + ".json"))
            and os.path.isfile(os.path.join(_PORT_CONFIG_DIR, model_name + ".json")))


def get_model_config(model_name: str, img_size: Optional[int] = None) -> CLIPConfig:
    """Load a CLIPConfig from the JSON registry (the JAX package's models,
    then the port's own), optionally overriding the image size. List-typed
    vision layers select the ModifiedResNet tower; an ``eva_model_name``
    (or any of the EVA block settings) an EVA-CLIP tower, whose block the
    settings select (:func:`_eva_postnorm`); a ``timm_model_name`` SigLIP's
    towers (:func:`_siglip`)."""
    model_name = model_name.replace("/", "-")
    path = next((p for p in (os.path.join(d, model_name + ".json")
                             for d in (_CONFIG_DIR, _PORT_CONFIG_DIR)) if os.path.isfile(p)),
                None)
    if path is None:
        raise FileNotFoundError(
            f"Model config for {model_name!r} not found; available: {list_models()}"
        )
    with open(path) as f:
        raw = json.load(f)
    v, t = raw["vision_cfg"], raw["text_cfg"]
    if "timm_model_name" in v:
        return _siglip(model_name, raw, img_size)
    if "eva_model_name" in v or any(k in v for k in _EVA_KEYS):
        postnorm = _eva_postnorm(model_name, v)
        vision = Eva02VisionConfig(
            image_size=img_size or v["image_size"],
            patch_size=v["patch_size"],
            width=v["width"],
            layers=v["layers"],
            head_width=v["head_width"],
            mlp_ratio=v["mlp_ratio"],
            output_dim=raw["embed_dim"],
            rope_ref_grid=16 if postnorm else v["pt_hw_seq_len"],
            postnorm=postnorm,
        )
    elif isinstance(v["layers"], (list, tuple)):
        vision = ResNetVisionConfig(
            image_size=img_size or v["image_size"],
            layers=tuple(v["layers"]),
            width=v["width"],
            output_dim=raw["embed_dim"],
        )
    else:
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


def tiny_eva02_config(img_size: int = 56) -> ModelConfig:
    """:func:`tiny_test_config` with an EVA-02 vision tower of the same
    width: 4 heads of 16, a hidden width of 170 (no multiple of 128, as
    EVA02-CLIP-L's 2730 is not) and a rotary reference grid of 3 against
    the 4 x 4 grid of 56 px."""
    cfg = tiny_test_config(img_size)
    v = cfg.clip.vision
    vision = Eva02VisionConfig(image_size=v.image_size, patch_size=v.patch_size,
                               width=v.width, layers=v.layers, head_width=v.head_width,
                               mlp_ratio=2.6667, output_dim=v.output_dim, rope_ref_grid=3)
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vision=vision))


def tiny_eva_postnorm_config(img_size: int = 56) -> ModelConfig:
    """:func:`tiny_test_config` with a post-norm EVA tower
    (``Eva02VisionConfig.postnorm``, EVA02-CLIP-E/14+'s block): width 112,
    4 heads of 28, EVA02-CLIP-E/14+'s ``mlp_ratio`` (hidden 960), 4 blocks,
    taps (2, 4)."""
    cfg = tiny_test_config(img_size)
    v = cfg.clip.vision
    vision = Eva02VisionConfig(image_size=v.image_size, patch_size=v.patch_size, width=112,
                               layers=v.layers, head_width=28, mlp_ratio=8.571428571428571,
                               output_dim=v.output_dim, postnorm=True)
    return dataclasses.replace(cfg, clip=dataclasses.replace(cfg.clip, vision=vision))


def tiny_siglip_config(img_size: int = 56) -> ModelConfig:
    """:func:`tiny_test_config` with SigLIP's towers at width 144: 3 vision
    blocks of 2 heads of 72 and SigLIP's ``mlp_ratio`` (hidden 538, no
    multiple of 128, so the kernels' padding of the hidden width runs), no
    class row (16 rows at 56 px), the attention pool; a text tower of 3
    such blocks on 16 tokens of a 32,000-id vocabulary; taps (2, 3), one
    adapter on each tower."""
    cfg = tiny_test_config(img_size)
    ratio = 3.7362
    clip = CLIPConfig(
        embed_dim=32,
        vision=SiglipVisionConfig(image_size=img_size, patch_size=14, width=144, layers=3,
                                  head_width=72, mlp_ratio=ratio, output_dim=32),
        text=SiglipTextConfig(context_length=16, vocab_size=32000, width=144, heads=2, layers=3,
                              output_dim=32, mlp_ratio=ratio),
        act="gelu_tanh")
    adapter = AdapterConfig(text_adapt_until=1, image_adapt_until=1, levels=(2, 3))
    iqm = dataclasses.replace(cfg.iqm, text_encoder_hidden_size=32)
    return ModelConfig(clip=clip, adapter=adapter, iqm=iqm, surgery_until_layer=3)
