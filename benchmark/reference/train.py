"""The plain reference of AA-CLIP's stage-2 training step, in float32.

Loss (AA-CLIP, arXiv 2503.06661, stage 2, with this framework's IQM term):
0.5 x the cross-entropy of the detection token against the two anchors,
plus for each tapped level 0.3 x the segmentation loss of the text map and
0.2 x that of the IQM map. The segmentation loss is the focal loss (gamma
2, labels smoothed to [1e-5, 1 - 1e-5], alpha 1) on the two-channel
probability map plus the Dice loss (smooth 1) of each channel against the
mask and its complement. The text map is the softmax over the two channels
of 100x the similarities upsampled bilinearly with aligned corners; the
IQM map is (1 - p, p) of the sigmoid of the cosine difference, upsampled
bilinearly. The loss of a batch is the mean of its images' losses, so the
reference runs one image at a time and adds the gradients.

The optimizer is AdamW (betas 0.9 and 0.999, eps 1e-8, decoupled decay)
over two groups, the image adapter and the IQM family, each on a cosine
schedule to 1e-6; the text adapter, the IQM's position table and its last
LayerNorm are not trained in stage 2.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import model as ref

IMAGE_GROUP = ("image_adapter",)
IQM_GROUP = ("iqm", "class_query_mlp", "query_adapters", "visual_feature_proj",
             "text_feature_proj", "query_proj")


def leaves(tree, prefix=""):
    """[(path, tensor)] of a nested dict / list, in order."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in leaves(v, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def trained(path: str) -> bool:
    return path.split("/")[0] in IMAGE_GROUP + IQM_GROUP


def focal(probs, mask, smooth=1e-5):
    p = probs.movedim(1, -1).reshape(probs.shape[0], -1, 2)
    t = F.one_hot(mask.reshape(mask.shape[0], -1).long(), 2).float().clamp(smooth, 1 - smooth)
    pt = (t * p).sum(-1) + smooth
    return (-(1 - pt) ** 2 * torch.log(pt)).mean(dim=1).mean()


def dice(pred, target):
    p, t = pred.flatten(1), target.flatten(1)
    return 1 - ((2 * (p * t).sum(1) + 1) / (p.sum(1) + t.sum(1) + 1)).mean()


def seg_loss(probs, mask):
    m = mask[:, 0]
    return focal(probs, mask) + dice(probs[:, 0], 1 - m) + dice(probs[:, 1], m)


def loss(frozen, trainable, cfg, images, masks, labels, anchors, pos_embed, mm=ref.matmul):
    """The stage-2 loss of a batch of normalized float32 images; ``mm`` the
    projections' product."""
    size = cfg["img_size"]
    w = cfg["train"]
    taps, x_final = ref.vision(frozen["visual"], cfg, images,
                               trainable["image_adapter"]["layer_adapters"], pos_embed, mm=mm)
    seg, det, q = ref.heads(trainable, cfg, taps, x_final, anchors, mm)
    total = F.cross_entropy((det[:, None, :] @ anchors)[:, 0], labels) * w["det_loss_weight"]
    for s in seg:
        logits = ref._grid_channels(100.0 * s @ anchors)
        up = F.interpolate(logits, size=(size, size), mode="bilinear", align_corners=True)
        total = total + seg_loss(torch.softmax(up, dim=1), masks) * w["text_loss_weight"] * 0.5
    for s in seg:
        sims = ref.l2n(s) @ ref.l2n(q).transpose(1, 2)
        p = ref._grid(torch.sigmoid(sims[..., 1] - sims[..., 0]))[:, None]
        up = F.interpolate(torch.cat([1 - p, p], 1), size=(size, size), mode="bilinear",
                           align_corners=False)
        total = total + seg_loss(up, masks) * w["iqm_loss_weight"] * 0.5
    return total


def lr_at(base, step, total, eta_min=1e-6):
    alpha = eta_min / base
    cos = 0.5 * (1 + math.cos(math.pi * min(step, total) / total))
    return base * ((1 - alpha) * cos + alpha)


def steps(frozen, trainable, cfg, batches, pos_embed, n_steps=3, mm=ref.matmul):
    """Run ``n_steps`` AdamW steps from ``trainable`` (copied, float32) on
    ``batches`` (a list of (images, masks, labels, anchors)), the
    projections' products by ``mm``. Returns
    (the losses, {path: the first step's gradient}, {path: the change of
    each trained leaf after the last step})."""
    w = cfg["train"]
    tree = _copy(trainable)
    named = [(p, t) for p, t in leaves(tree) if trained(p)]
    m = {p: torch.zeros_like(t) for p, t in named}
    v = {p: torch.zeros_like(t) for p, t in named}
    start = {p: t.detach().clone() for p, t in named}
    losses, first = [], None
    for k in range(n_steps):
        images, masks, labels, anchors = batches[k]
        for _, t in named:
            t.grad = None
        total = 0.0
        n = images.shape[0]
        for i in range(n):
            sl = slice(i, i + 1)
            li = loss(frozen, tree, cfg, images[sl], masks[sl], labels[sl], anchors[sl],
                      pos_embed, mm)
            (li / n).backward()
            total += float(li.detach()) / n
        losses.append(total)
        grads = {p: t.grad.detach().clone() for p, t in named}
        if first is None:
            first = grads
        with torch.no_grad():
            for p, t in named:
                image = p.split("/")[0] in IMAGE_GROUP
                base = w["image_lr"] if image else w["image_lr"] * w["iqm_lr_scale"]
                wd = w["image_weight_decay"] if image else w["iqm_weight_decay"]
                lr = lr_at(base, k, w["total_steps"])
                g = grads[p]
                t.mul_(1 - lr * wd)
                m[p].mul_(0.9).add_(g, alpha=0.1)
                v[p].mul_(0.999).addcmul_(g, g, value=0.001)
                bias1, bias2 = 1 - 0.9 ** (k + 1), 1 - 0.999 ** (k + 1)
                denom = v[p].sqrt() / math.sqrt(bias2) + 1e-8
                t.addcdiv_(m[p], denom, value=-lr / bias1)
    change = {p: (t.detach() - start[p]) for p, t in named}
    return losses, first, change


def _copy(tree):
    """A float32 copy of a trainable tree with gradients on."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    return tree.detach().float().clone().requires_grad_(True)
