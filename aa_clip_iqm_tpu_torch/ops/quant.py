"""Int8 quantized inference tier for the frozen CLIP backbone.

Counterpart of ``aa_clip_iqm_tpu/ops/quant.py``. The backbone is frozen, so
its block matmuls are quantized once at load time (per-output-channel
symmetric int8, on the host with numpy, bit for bit as the JAX package does
it) and activations are quantized dynamically per token at run time. Both
operands of the product are then int8 and the accumulation is int32; the
per-token x per-channel rescale is a float32 epilogue.

Scope: the visual tower's block matmuls (qkv, out, c_fc, c_proj). LayerNorm,
the attention core, embeddings, the final projection, the whole text tower
and every adapter/IQM matmul stay in the compute dtype.

The parameter layout is the port's: ``frozen["visual"]["blocks"]`` is a list
of per-layer dicts, and a quantized linear is ``{"w_q": int8 (in, out),
"scale": float32 (1, out), "b": float32 (out,)}``. ``ops.layers.linear``
dispatches on the ``"w_q"`` key, and ``models.clip`` sends a quantized MLP
through the fused int8 kernel where its gate allows.

:func:`int8_linear` carries a straight-through backward (the quantizers are
treated as identity, the weights dequantized), so a gradient through a
quantized frozen block is not silently zero.
"""
from __future__ import annotations

import numpy as np
import torch

_SCOPES = {"int8": "all", "int8_attn": "attn", "int8_mlp": "mlp"}


def quantize_linear_params(p):
    """{"w": (..., in, out) [, "b"]} -> {"w_q": int8, "scale": (..., 1, out)
    float32 [, "b"]}. Per-output-channel symmetric: scale = max|w_col| / 127.
    Host-side numpy on the float32 values of the weights, whatever dtype
    they are held in; the result lives on the weights' device."""
    device = p["w"].device
    w = p["w"].detach().float().cpu().numpy()
    scale = np.max(np.abs(w), axis=-2, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    w_q = np.clip(np.rint(w / scale), -127, 127).astype(np.int8)
    out = {"w_q": torch.from_numpy(w_q).to(device),
           "scale": torch.from_numpy(scale).to(device)}
    if p.get("b") is not None:
        out["b"] = p["b"]
    return out


def int8_matmul(x_q, w_q):
    """Exact int8 (m, k) x int8 (k, n) -> int32 (m, n). On the card, cuBLAS's
    int8 product where its shape rules allow (more than 16 rows, k and n
    multiples of 8); otherwise, and on the CPU, a float64 product, which is
    exact here (|sum| <= 127 * 127 * k, far below 2^53; a float32 product
    would not be at k = 4096)."""
    m, k = x_q.shape
    n = w_q.shape[-1]
    if x_q.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(x_q, w_q)
    return torch.matmul(x_q.double(), w_q.double()).to(torch.int32)


def _int8_linear_forward(w_q, scale, b, x):
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s_x = amax.clamp_min(1e-6) * (1.0 / 127.0)
    x_q = torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8)
    y = int8_matmul(x_q.reshape(-1, x.shape[-1]), w_q)
    y = y.reshape(*x.shape[:-1], w_q.shape[-1])
    y = y.float() * s_x * scale.reshape(scale.shape[-1]).float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


class _Int8LinearSTE(torch.autograd.Function):
    """Straight-through estimator: the backward is that of a linear layer
    with the dequantized weights at x's dtype, dx = dy @ (w_q * scale)^T.
    The int8 weights and their scales take no gradient."""

    @staticmethod
    def forward(ctx, w_q, scale, b, x):
        ctx.save_for_backward(w_q, scale)
        ctx.has_b = b is not None
        return _int8_linear_forward(w_q, scale, b, x)

    @staticmethod
    def backward(ctx, dy):
        w_q, scale = ctx.saved_tensors
        w_deq = (w_q.float() * scale.float()).to(dy.dtype)
        dx = torch.matmul(dy.float(), w_deq.float().t()).to(dy.dtype)
        db = (dy.float().sum(dim=tuple(range(dy.dim() - 1)))
              if ctx.has_b else None)
        return None, None, db, dx


def int8_linear(qp, x):
    """y = dequant(quant(x) @ w_q) + b with dynamic per-token activation
    scales. x: (..., in) any float dtype; returns x.dtype. Differentiable
    (straight-through)."""
    return _Int8LinearSTE.apply(qp["w_q"], qp["scale"], qp.get("b"), x)


def _quantize_block(block, scope: str = "all"):
    quant_mlp = scope in ("all", "mlp")
    quant_attn = scope in ("all", "attn")

    def q(p, on):
        return quantize_linear_params(p) if on else p

    return {
        "ln_1": block["ln_1"],
        "attn": {"qkv": q(block["attn"]["qkv"], quant_attn),
                 "out": q(block["attn"]["out"], quant_attn)},
        "ln_2": block["ln_2"],
        "mlp": {"c_fc": q(block["mlp"]["c_fc"], quant_mlp),
                "c_proj": q(block["mlp"]["c_proj"], quant_mlp)},
    }


def _quantize_block_tree(blocks, scope: str = "all"):
    """List of per-layer block dicts -> the same with the block matmuls
    quantized (ln_1/ln_2 untouched).

    scope: "all" quantizes qkv/out/c_fc/c_proj; "attn" only the attention
    projections, so the MLP stays float and keeps the fused float kernel;
    "mlp" only c_fc/c_proj (served by the fused int8 kernel), the attention
    projections staying in the compute dtype."""
    return [_quantize_block(b, scope) for b in blocks]


def calibrate_ln_amax(visual, vision_cfg, images, act_name: str = "gelu",
                      adapters=None, adapter_weight: float = 0.0,
                      adapt_until: int = 0, compute_dtype=torch.float32,
                      use_pallas: bool = True):
    """Per-layer, per-channel amax of the post-LN activations (the inputs of
    qkv after ln_1 and of c_fc after ln_2) over a calibration batch, on the
    plain tower the predict pipeline runs (no surgery; residual adapters
    included when given). ``use_pallas=False`` runs its attention on the
    stock PyTorch call (``ops.attention.library_sdpa``).

    Returns {"qkv": (layers, width), "c_fc": (layers, width)} float32 numpy.
    """
    from ..models import clip as clip_mod
    from . import attention as attn_ops
    from .layers import (
        ACTIVATIONS,
        layer_norm,
        mlp_block,
        norm_preserving_blend,
        simple_adapter,
    )

    act = ACTIVATIONS[act_name]
    device = visual["class_embedding"].device
    images = torch.as_tensor(images).to(device)
    s1s, s2s = [], []
    with torch.no_grad():
        x = clip_mod.embed_patches(visual, vision_cfg, images, compute_dtype)
        for i, block in enumerate(visual["blocks"]):
            h1 = layer_norm(block["ln_1"], x)
            s1s.append(h1.float().abs().amax(dim=(0, 1)))
            x = x + attn_ops.mha(block["attn"], h1, vision_cfg.heads,
                                 use_pallas=use_pallas)
            h2 = layer_norm(block["ln_2"], x)
            s2s.append(h2.float().abs().amax(dim=(0, 1)))
            x = x + mlp_block(block["mlp"], h2, act)
            if adapters is not None and i < adapt_until:
                x = norm_preserving_blend(x, simple_adapter(adapters[i], x),
                                          adapter_weight)
    return {"qkv": torch.stack(s1s).cpu().numpy(),
            "c_fc": torch.stack(s2s).cpu().numpy()}


def activation_outlier_ratio(stats):
    """Per-site outlier diagnostic from calibration stats: max/median of the
    per-channel activation amax across all layers, for each quantized-matmul
    input site."""
    return {k: float(np.max(v) / max(float(np.median(v)), 1e-9))
            for k, v in stats.items()}


def smooth_backbone(frozen, stats, alpha: float = 0.5, scope: str = "all"):
    """SmoothQuant-style outlier migration for the LN-fed block matmuls.

    Both quantized-matmul inputs of a block are LayerNorm outputs, so the
    per-channel balancing factor s folds into existing parameters at load
    time: ``ln.scale /= s``, ``ln.bias /= s``, ``w[j, :] *= s_j`` — an exact
    identity in float. s_j = amax_act_j^alpha / amax_w_row_j^(1-alpha).

    Scope matches the quantization scope: "all" folds qkv + c_fc, "attn"
    only qkv, "mlp" only c_fc. stats: :func:`calibrate_ln_amax` output.
    Returns a new frozen dict; apply before :func:`quantize_backbone_int8`.
    """
    def fold(ln, lin, a_amax):
        w_t = lin["w"]
        w = w_t.detach().float().cpu().numpy()               # (d_in, d_out)
        w_amax = np.maximum(np.max(np.abs(w), axis=-1), 1e-6)
        a = np.maximum(np.asarray(a_amax, np.float32), 1e-6)
        s = np.clip(a ** alpha / w_amax ** (1.0 - alpha), 1e-4, 1e4)

        def ln_param(t):
            return torch.from_numpy(t.detach().float().cpu().numpy() / s).to(t.device)

        new_lin = dict(lin)
        new_lin["w"] = torch.from_numpy(w * s[..., None]).to(w_t.device, w_t.dtype)
        return {"scale": ln_param(ln["scale"]), "bias": ln_param(ln["bias"])}, new_lin

    blocks = []
    for i, block in enumerate(frozen["visual"]["blocks"]):
        block = dict(block)
        if scope in ("all", "attn"):
            block["ln_1"], qkv = fold(block["ln_1"], block["attn"]["qkv"],
                                      stats["qkv"][i])
            block["attn"] = dict(block["attn"], qkv=qkv)
        if scope in ("all", "mlp"):
            block["ln_2"], c_fc = fold(block["ln_2"], block["mlp"]["c_fc"],
                                       stats["c_fc"][i])
            block["mlp"] = dict(block["mlp"], c_fc=c_fc)
        blocks.append(block)
    return dict(frozen, visual=dict(frozen["visual"], blocks=blocks))


def quantize_backbone_tier(frozen, tier, smooth_stats=None,
                           smooth_alpha: float = 0.5):
    """Tier-string front end shared by every entry point.

    tier: None / "" (no-op), "int8" (all block matmuls), "int8_attn"
    (qkv/out only; the MLP keeps the fused float kernel) or "int8_mlp"
    (c_fc/c_proj only, through the fused int8 kernel). Any tier takes a
    "+smooth" suffix, which needs ``smooth_stats`` from
    :func:`calibrate_ln_amax`. Anything else raises instead of silently
    running the float tier under a quantized label.
    """
    if tier in (None, ""):
        return frozen
    base, _, suffix = tier.partition("+")
    if base not in _SCOPES or suffix not in ("", "smooth"):
        raise ValueError(
            f"unknown quantization tier {tier!r}; expected 'int8',"
            " 'int8_attn' or 'int8_mlp', optionally with a '+smooth'"
            " suffix")
    if suffix == "smooth":
        if smooth_stats is None:
            raise ValueError(
                f"tier {tier!r} needs calibration statistics: pass "
                "smooth_stats=calibrate_ln_amax(...) (a calibration batch "
                "of real images through the fp backbone)")
        frozen = smooth_backbone(frozen, smooth_stats, alpha=smooth_alpha,
                                 scope=_SCOPES[base])
    return quantize_backbone_int8(frozen, scope=_SCOPES[base])


def quantize_backbone_auto(frozen, tier, cfg=None, calib_images=None,
                           trainable=None, smooth_alpha: float = 0.5,
                           use_pallas: bool = True):
    """Tier wrapper that resolves '+smooth' calibration: runs
    :func:`calibrate_ln_amax` on ``calib_images`` ((B, 3, H, W),
    CLIP-normalized), or on a seeded random batch when none are given.
    ``cfg`` (ModelConfig) is required for '+smooth' tiers; ``trainable``
    threads the residual adapters into the calibration forward, and
    ``use_pallas`` picks its attention route (:func:`calibrate_ln_amax`)."""
    if not (tier and tier.endswith("+smooth")):
        return quantize_backbone_tier(frozen, tier)
    if cfg is None:
        raise ValueError(
            f"tier {tier!r} needs the model config for calibration")
    v = cfg.clip.vision
    if calib_images is None:
        rng = np.random.default_rng(0)
        calib_images = rng.standard_normal(
            (4, 3, v.image_size, v.image_size)).astype(np.float32)
    kwargs = {}
    if trainable is not None:
        kwargs = dict(adapters=trainable["image_adapter"]["layer_adapters"],
                      adapter_weight=cfg.adapter.image_adapt_weight,
                      adapt_until=cfg.adapter.image_adapt_until)
    stats = calibrate_ln_amax(frozen["visual"], v, calib_images,
                              act_name=cfg.clip.act, use_pallas=use_pallas, **kwargs)
    return quantize_backbone_tier(frozen, tier, smooth_stats=stats,
                                  smooth_alpha=smooth_alpha)


def quantize_backbone_int8(frozen, scope: str = "all"):
    """Frozen CLIP dict -> copy with the visual tower's block matmuls in
    int8. Everything else (visual embeddings/LNs/proj, the whole text tower)
    is shared by reference with the input."""
    if scope not in ("all", "attn", "mlp"):
        raise ValueError(
            f"scope must be 'all', 'attn' or 'mlp', got {scope!r}")
    visual = dict(frozen["visual"])
    if "blocks" not in visual:
        raise ValueError("int8 tier supports the ViT tower only")
    visual["blocks"] = _quantize_block_tree(visual["blocks"], scope)
    out = dict(frozen)
    out["visual"] = visual
    return out
