"""Training losses: focal, binary dice, segmentation composite, image CE.

Counterpart of ``aa_clip_iqm_tpu/ops/losses.py``, same semantics:
  - focal loss on per-pixel class probabilities (softmax applied upstream);
    labels smoothed by clamping the one-hot to [smooth/(C-1), 1-smooth]; pt
    gets +smooth; loss = mean(-(1-pt)^gamma * log(pt)) with alpha == 1;
  - binary dice with smooth=1, per-sample on flattened maps, averaged;
  - the segmentation composite focal(probs_2ch, mask) + dice(ch0, 1-mask) +
    dice(ch1, mask).
Every loss takes an optional ``sample_weight`` (B,) (a validity mask for
batch padding) and then is ``const + sum(per_sample * w) / max(sum(w), 1)``,
which is what makes gradient accumulation over microbatches exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _weighted_mean(per_sample, sample_weight):
    w = sample_weight.float()
    return (per_sample * w).sum() / w.sum().clamp_min(1.0)


def focal_loss(probs, target, gamma: float = 2.0, smooth: float = 1e-5,
               sample_weight=None):
    """probs: (B, C, ...) class probabilities; target: (B, 1, ...) or (B, ...)
    integer/binary labels."""
    num_class = probs.shape[1]
    b = probs.shape[0]
    p = probs.movedim(1, -1).reshape(b, -1, num_class).float()
    t = target.reshape(b, -1).long()
    one_hot = F.one_hot(t, num_class).float()
    one_hot = one_hot.clamp(smooth / (num_class - 1), 1.0 - smooth)
    pt = (one_hot * p).sum(dim=-1) + smooth
    loss = -torch.pow(1.0 - pt, gamma) * torch.log(pt)        # (B, pixels)
    if sample_weight is None:
        return loss.mean()
    return _weighted_mean(loss.mean(dim=1), sample_weight)


def binary_dice_loss(pred, target, smooth: float = 1.0, sample_weight=None):
    """pred/target: (B, ...) in [0, 1]."""
    n = pred.shape[0]
    p = pred.reshape(n, -1).float()
    t = target.reshape(n, -1).float()
    inter = (p * t).sum(dim=1)
    dice = (2.0 * inter + smooth) / (p.sum(dim=1) + t.sum(dim=1) + smooth)
    if sample_weight is None:
        return 1.0 - dice.sum() / n
    return 1.0 - _weighted_mean(dice, sample_weight)


def seg_loss(probs_2ch, mask, sample_weight=None):
    """Composite segmentation loss on 2-channel probability maps.

    probs_2ch: (B, 2, H, W) softmaxed (normal, abnormal); mask: (B, 1, H, W).
    """
    m = mask.reshape(mask.shape[0], *mask.shape[-2:]).float()
    loss = focal_loss(probs_2ch, mask, sample_weight=sample_weight)
    loss = loss + binary_dice_loss(probs_2ch[:, 0], 1.0 - m, sample_weight=sample_weight)
    return loss + binary_dice_loss(probs_2ch[:, 1], m, sample_weight=sample_weight)


def seg_loss_tokens(probs_2ch, cell_frac, sample_weight=None):
    """Token-resolution composite for the patch-dropout path: the same
    focal + dice combination on the kept cells against the per-cell defect
    fraction (``evaluation.scoring.mask_to_patch_cells``).

    probs_2ch: (B, 2, K) softmaxed; cell_frac: (B, K) in [0, 1], binarized at
    0.5 for the focal target, used as it is for the dice terms.
    """
    hard = (cell_frac >= 0.5).long()
    loss = focal_loss(probs_2ch, hard, sample_weight=sample_weight)
    loss = loss + binary_dice_loss(probs_2ch[:, 0], 1.0 - cell_frac,
                                   sample_weight=sample_weight)
    return loss + binary_dice_loss(probs_2ch[:, 1], cell_frac,
                                   sample_weight=sample_weight)


def cross_entropy_logits(logits, labels, sample_weight=None):
    """F.cross_entropy parity: mean over the batch of -log_softmax[label]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = -logp.gather(-1, labels[:, None].long())[:, 0]
    if sample_weight is None:
        return picked.mean()
    return _weighted_mean(picked, sample_weight)
