"""Similarity-map scoring: the anomaly-map pipeline.

Counterpart of ``aa_clip_iqm_tpu/evaluation/scoring.py``:
  - text maps: 100 * patches @ anchors; at test time score (pos+1-neg)/2,
    Gaussian blur (Industrial k=7 s=1, Medical k=9 s=1.5) then upsample, as
    two fp32 matmuls (ops/interp.blur_and_upsample); in training a bilinear
    align_corners=True upsample of the logits and a softmax over the two
    channels;
  - IQM maps: sigmoid of the cosine-similarity difference,
    align_corners=False upsample;
  - fusion 0.6 * sum(text maps) + 0.4 * sum(IQM maps), and the per-sample
    image logit (or the reference's executed eval score, for parity studies).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from ..ops.interp import blur_and_upsample, resize_bilinear
from ..ops.layers import l2_normalize

BLUR_SETTINGS = {"Industrial": (7, 1.0), "Medical": (9, 1.5)}


def _to_grid(patch_scores):
    """(B, L, ...) -> (B, ..., H, H) with L = H*H."""
    b, l = patch_scores.shape[0], patch_scores.shape[1]
    h = math.isqrt(l)
    if h * h != l:
        raise ValueError(f"patch count {l} is not a perfect square")
    if patch_scores.dim() == 2:
        return patch_scores.reshape(b, h, h)
    return patch_scores.transpose(1, 2).reshape(b, patch_scores.shape[2], h, h)


def similarity_logits(patch_features, anchors):
    """100 * (B, L, D) @ (B, D, 2) -> (B, L, 2), float32."""
    return 100.0 * torch.matmul(patch_features.float(), anchors.float())


def similarity_map_train(patch_features, anchors, img_size: int):
    """Training-path map: upsampled logits, softmax over the 2 channels.
    Returns (B, 2, img, img) probabilities."""
    grid = _to_grid(similarity_logits(patch_features, anchors))  # (B, 2, H, H)
    up = resize_bilinear(grid, img_size, img_size, align_corners=True)
    return torch.softmax(up, dim=1)


def similarity_map_test(patch_features, anchors, img_size: int, domain: str):
    """Test-path map: (pos+1-neg)/2, blur, upsample. Returns (B, img, img)."""
    logits = similarity_logits(patch_features, anchors)
    score = (logits[..., 1] + 1.0 - logits[..., 0]) * 0.5   # (B, L)
    ks, sigma = BLUR_SETTINGS[domain]
    return blur_and_upsample(_to_grid(score), img_size, ks, sigma)


def iqm_score_map(patch_features, queries_projected, img_size: int,
                  align_corners: bool = False):
    """sigmoid(cos(f, q_abnormal) - cos(f, q_normal)) per patch, upsampled.

    patch_features: (B, L, D); queries_projected: (B, 2, D). Returns
    (B, img, img).
    """
    f = l2_normalize(patch_features.float())
    q = l2_normalize(queries_projected.float())
    sims = torch.matmul(f, q.transpose(1, 2))                # (B, L, 2)
    pred = torch.sigmoid(sims[..., 1] - sims[..., 0])
    return resize_bilinear(_to_grid(pred), img_size, img_size,
                           align_corners=align_corners)


def iqm_patch_pred(patch_features, queries_projected):
    """Per-patch IQM anomaly probability sigmoid(cos(f, q_abn) - cos(f, q_nrm)).
    Returns (B, L)."""
    f = l2_normalize(patch_features.float())
    q = l2_normalize(queries_projected.float())
    sims = torch.matmul(f, q.transpose(1, 2))                # (B, L, 2)
    return torch.sigmoid(sims[..., 1] - sims[..., 0])


def iqm_train_map(patch_features, queries_projected, img_size: int):
    """Two-channel (1-p, p) IQM map for the stage-2 segmentation loss;
    align_corners=False upsample. Returns (B, 2, img, img)."""
    grid = _to_grid(iqm_patch_pred(patch_features, queries_projected))[:, None]
    two_ch = torch.cat([1.0 - grid, grid], dim=1)            # (B, 2, H, H)
    return resize_bilinear(two_ch, img_size, img_size, align_corners=False)


def mask_to_patch_cells(mask, patch_size: int):
    """(B, 1, H, W) mask -> (B, L) per-patch-cell defect fraction, in the
    row-major cell order of models.clip.patchify. Used by the patch-dropout
    training path, where the seg loss runs at token resolution on kept cells
    instead of upsampling to img_size."""
    b = mask.shape[0]
    m = mask.reshape(b, mask.shape[-2], mask.shape[-1]).float()
    gh, gw = m.shape[1] // patch_size, m.shape[2] // patch_size
    cells = m.reshape(b, gh, patch_size, gw, patch_size).mean(dim=(2, 4))
    return cells.reshape(b, gh * gw)


def fuse_maps(text_maps: Sequence, iqm_maps: Sequence,
              text_weight: float = 0.6, iqm_weight: float = 0.4):
    """final = w_t * sum(text levels) + w_i * sum(IQM levels)."""
    text_sum = sum(text_maps)
    if iqm_maps:
        return text_weight * text_sum + iqm_weight * sum(iqm_maps)
    return text_sum


def image_logit(det_token, anchors):
    """Per-sample abnormal-channel image score ((det_i @ anchors_i)[1]+1)/2."""
    pred = torch.matmul(det_token.float()[:, None, :], anchors.float())[:, 0]
    return (pred[:, 1] + 1.0) * 0.5


def image_logit_reference_eval(det_token, anchors):
    """Exact transcription of the reference's executed eval image score
    (test_last.py:90-92 + forward_utils.py:269-271), for parity studies: the
    whole batch scores as sample index 1's normal-anchor cosine. Requires
    B >= 2 like the reference (B == 1 raises there)."""
    if det_token.shape[0] < 2:
        raise ValueError(
            "image_logit_reference_eval requires batch >= 2: the reference's"
            " pred[:, 1] crashes at B == 1 (test_last.py:90-92)")
    pred = torch.einsum("d,bdc->bc", det_token.float()[1], anchors.float())
    return (pred[:, 0] + 1.0) * 0.5
