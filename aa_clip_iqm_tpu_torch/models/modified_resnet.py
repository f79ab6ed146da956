"""ModifiedResNet vision tower (CLIP's anti-aliased ResNet) as functions on
tensors.

Counterpart of ``aa_clip_iqm_tpu/models/modified_resnet.py``, with its
parameter layout: NCHW activations, conv kernels stored HWIO (``kernel``),
BatchNorm in inference mode with frozen statistics (``scale``, ``bias``,
``mean``, ``var``), the attention pool's projections as ``linear`` dicts.
The JAX package computes this tower in XLA, outside any Pallas kernel, so
the port runs it on stock PyTorch calls: the convolutions on
``torch.nn.functional.conv2d`` (cuDNN on the card) and the pool's one
attention on the plain :func:`..ops.attention.sdpa`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs import ResNetVisionConfig
from ..ops.attention import sdpa
from ..ops.layers import linear


def _conv(params, x, stride: int = 1, padding: int = 0):
    """NCHW convolution with an HWIO kernel, cast to x's dtype (fp32
    accumulation, one rounding to x's dtype)."""
    w = params["kernel"].to(x.dtype).permute(3, 2, 0, 1)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(params, x, eps: float = 1e-5):
    """Inference-mode BatchNorm (frozen running statistics), fp32 math."""
    inv = torch.rsqrt(params["var"].float() + eps)
    scale = params["scale"].float() * inv
    shift = params["bias"].float() - params["mean"].float() * scale
    y = x.float() * scale.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)
    return y.to(x.dtype)


def _avg_pool(x, k: int):
    return F.avg_pool2d(x, k, k)


def bottleneck_forward(params, x, stride: int = 1):
    """Bottleneck: 1x1 -> 3x3 -> (average pool where stride > 1) -> 1x1
    (expansion 4); the downsample branch is an average pool and a 1x1
    conv."""
    out = torch.relu(_bn(params["bn1"], _conv(params["conv1"], x)))
    out = torch.relu(_bn(params["bn2"], _conv(params["conv2"], out, padding=1)))
    if stride > 1:
        out = _avg_pool(out, stride)
    out = _bn(params["bn3"], _conv(params["conv3"], out))
    identity = x
    if "downsample" in params:
        if stride > 1:
            identity = _avg_pool(identity, stride)
        identity = _bn(params["downsample"]["bn"],
                       _conv(params["downsample"]["conv"], identity))
    return torch.relu(out + identity)


def attention_pool_forward(params, x, num_heads: int):
    """AttentionPool2d: the grid flattened, its mean token prepended, the
    positional embedding added, one multi-head attention with the mean token
    as the only query. Returns (B, output_dim)."""
    b, c, h, w = x.shape
    tokens = x.reshape(b, c, h * w).transpose(1, 2)              # (B, HW, C)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + params["positional_embedding"].to(tokens.dtype)
    q = linear(params["q"], tokens[:, :1])
    k = linear(params["k"], tokens)
    v = linear(params["v"], tokens)
    hd = q.shape[-1] // num_heads

    def split(t):
        return t.reshape(t.shape[0], t.shape[1], num_heads, hd).transpose(1, 2)

    out = sdpa(split(q), split(k), split(v), hd ** -0.5)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    return linear(params["c_proj"], out)[:, 0]


def resnet_forward(params, cfg: ResNetVisionConfig, images,
                   compute_dtype=torch.float32):
    """The whole tower: a 3-conv stem (the first at stride 2) and an average
    pool, the stages of bottlenecks, the attention pool. Returns (pooled (B,
    output_dim), each stage's feature map (B, C, H, W))."""
    x = images.to(compute_dtype)
    for i in (1, 2, 3):
        x = torch.relu(_bn(params[f"bn{i}"], _conv(params[f"conv{i}"], x,
                                                   stride=2 if i == 1 else 1, padding=1)))
    x = _avg_pool(x, 2)
    features = []
    for stage_idx, blocks in enumerate(params["layers"]):
        for block_idx, block in enumerate(blocks):
            x = bottleneck_forward(block, x, stride=2 if stage_idx > 0 and block_idx == 0 else 1)
        features.append(x)
    return attention_pool_forward(params["attnpool"], x, cfg.num_heads), features
