"""Training steps for the two adaptation stages.

Counterpart of ``aa_clip_iqm_tpu/train/steps.py``.

Stage 1, text-anchor adaptation: the gradient path is the adapted text
encoder through the full prompt ensemble; the visual features come from the
frozen surgery / plain towers without a graph. The anchors of all the
dataset's classes come from one batched text-encoder call per step (per-
sample anchors are a gather), and the visual extraction is a separate
no-grad function with the shared-prefix dual forward
(``models.clip.dual_vision_features``), so the backward never walks the ViT.

Stage 2, patch alignment + IQM: the anchors are frozen inputs;
loss = 0.5 * CE(det) + sum_levels 0.3 * seg(text map) + sum_levels 0.2 *
seg(IQM map) with the trained query projection. The backbone's MLP halves
run with ``fused_mlp="frozen"``: forward through the fused kernel, backward
through the dx-only kernel, valid because only the adapters train.

A step updates the trainable tensors in place and returns
``(trainable, opt_state, loss)`` with the loss left on the device. Each step
function carries its ``update``: the same step without the schedule's
advance (gradients, clipping, the optimizer's update; returns the loss),
which is what ``train/graphs.py`` captures. Nothing in an update reads a
value on the host or has a shape that depends on the data.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs import ModelConfig, TrainConfig
from ..evaluation import scoring
from ..models import adapters as adapters_mod
from ..models import clip as clip_mod
from ..models.convert import tree_leaves
from ..ops.layers import l2_normalize, layer_norm, linear, patch_dropout_indices
from ..ops.losses import cross_entropy_logits, seg_loss, seg_loss_tokens
from ..prompts import anchors_from_flat_embeddings
from .optim import OptState, clip_stage2_grads


def _zero_grads(params):
    for t in tree_leaves(params):
        t.grad = None


# ----------------------------------------------------------------------
# Stage 1
# ----------------------------------------------------------------------

def make_stage1_visual_fn(cfg: ModelConfig, compute_dtype=torch.float32):
    """Visual features for stage 1, without a graph.

    Returns fn(frozen, images) -> patch_feats, a list of (B, L, D) per level,
    each ln_post'ed, projected, L2-normalized and CLS-added."""
    levels = tuple(cfg.adapter.levels)
    vv_from = clip_mod.surgery_vv_from(cfg.clip.vision.layers,
                                       cfg.surgery_until_layer)

    def features(frozen, images):
        vis = frozen["visual"]
        with torch.no_grad():
            cls_pooled, taps = clip_mod.dual_vision_features(
                vis, cfg.clip.vision, images, levels, vv_from,
                act_name=cfg.clip.act, compute_dtype=compute_dtype)
            cls_n = l2_normalize(cls_pooled)
            feats = []
            for t in taps:
                tok = layer_norm(vis["ln_post"], t[:, 1:, :])
                proj = linear({"w": vis["proj"]}, tok)
                feats.append(l2_normalize(proj) + cls_n[:, None, :])
        return feats

    return features


def make_stage1_step(cfg: ModelConfig, train_cfg: TrainConfig, prompt_tokens,
                     n_classes: int, n_normal: int, n_abnormal: int,
                     compute_dtype=torch.float32):
    """Build step(text_params, opt_state, frozen, patch_feats, masks,
    class_idx, weights) -> (text_params, opt_state, loss).

    prompt_tokens: (C * S, 77) integer tensor on the model's device.
    class_idx: (B,) index of each sample's class into the anchor stack.
    """
    img_size = train_cfg.img_size
    last_only = train_cfg.stage1_last_level_only
    norm_w = train_cfg.text_norm_weight

    def loss_fn(text_params, frozen, patch_feats, masks, class_idx, weights):
        emb = adapters_mod.encode_text_adapted(
            frozen, {"text_adapter": text_params}, cfg, prompt_tokens,
            compute_dtype=compute_dtype)
        anchors_all = anchors_from_flat_embeddings(
            emb, n_classes, n_normal, n_abnormal)            # (C, D, 2)
        anchors = anchors_all[class_idx]                     # (B, D, 2)

        # Orthogonality regularizer: a weighted mean, so that batch-padding
        # rows (weight 0) do not dilute it.
        w = weights.float()
        dots = (anchors[:, :, 0] * anchors[:, :, 1]).sum(dim=1)
        ortho = ((dots * w).sum() / w.sum().clamp_min(1.0)) ** 2

        losses = [seg_loss(scoring.similarity_map_train(f, anchors, img_size),
                           masks, sample_weight=weights) for f in patch_feats]
        # last_only: only the deepest level contributes gradient, as the
        # reference's loss reassignment has it.
        total = losses[-1] if last_only else sum(losses)
        return total + ortho * norm_w

    def update(text_params, opt_state: OptState, frozen, patch_feats, masks,
               class_idx, weights):
        _zero_grads(text_params)
        loss = loss_fn(text_params, frozen, patch_feats, masks, class_idx, weights)
        loss.backward()
        opt_state.optimizer.step()
        return loss.detach()

    def step(text_params, opt_state: OptState, frozen, patch_feats, masks,
             class_idx, weights):
        loss = update(text_params, opt_state, frozen, patch_feats, masks,
                      class_idx, weights)
        opt_state.advance()
        return text_params, opt_state, loss

    step.loss_fn = loss_fn
    step.update = update
    return step


# ----------------------------------------------------------------------
# Stage 2
# ----------------------------------------------------------------------

def make_stage2_step(cfg: ModelConfig, train_cfg: TrainConfig,
                     compute_dtype=torch.float32,
                     clip_grad_norm: Optional[float] = None):
    """Build step(trainable, opt_state, frozen, images, masks, labels,
    anchors, weights[, rng]) -> (trainable, opt_state, loss).

    When ``cfg.clip.vision.patch_dropout`` > 0 the step takes a trailing
    ``rng`` (a ``torch.Generator``, or a ready (B, K) tensor of kept-token
    indices) and trains on the kept tokens only: the seg losses then run at
    token resolution against per-cell mask fractions (``seg_loss_tokens``).
    From a generator the step draws ``step.keep_indices(rng, B, device)``
    first: one draw per microbatch, in order.

    Gradient accumulation (``train_cfg.grad_accum_steps`` > 1): the batch is
    split into that many microbatches run one after another, so peak
    activation memory is one microbatch's. The result is exact: every loss
    term is ``const + weighted mean`` over per-sample values, so summing the
    per-microbatch numerators ``loss_k * sum(w_k)`` (and their gradients)
    and dividing by ``max(sum(w), 1)`` gives the full-batch loss and
    gradients up to fp32 summation order.
    """
    img_size = train_cfg.img_size
    text_w = train_cfg.text_loss_weight
    iqm_w = train_cfg.iqm_loss_weight
    det_w = train_cfg.det_loss_weight
    grad_accum = max(1, int(train_cfg.grad_accum_steps))
    remat = train_cfg.remat
    patch_size = cfg.clip.vision.patch_size
    drop_rate = cfg.clip.vision.patch_dropout

    def keep_indices(generator, batch: int, device):
        """The (batch, K) kept-token indices drawn from ``generator``, one
        draw of each microbatch's rows after another; None without patch
        dropout."""
        if drop_rate <= 0.0:
            return None
        micro = batch // grad_accum
        return torch.cat([patch_dropout_indices(generator, micro,
                                                cfg.clip.vision.num_patches,
                                                drop_rate, device=device)
                          for _ in range(grad_accum)])

    def loss_fn(trainable, frozen, images, masks, labels, anchors, weights, rng):
        out = adapters_mod.encode_image_adapted(
            frozen, trainable, cfg, images, text_anchors=anchors,
            compute_dtype=compute_dtype, remat=remat, patch_drop_rng=rng,
            fused_mlp="frozen")
        cls_logits = torch.einsum("bd,bdc->bc", out.det_token.float(),
                                  anchors.float())
        total = cross_entropy_logits(cls_logits, labels,
                                     sample_weight=weights) * det_w

        q = adapters_mod.project_queries(trainable, out.iqm_queries)
        if out.keep_idx is not None:
            cells = scoring.mask_to_patch_cells(masks, patch_size)    # (B, L)
            cells = torch.gather(cells, 1, out.keep_idx)
            for f in out.seg_tokens:
                logits = scoring.similarity_logits(f, anchors)        # (B, K, 2)
                probs = torch.softmax(logits, dim=-1).transpose(1, 2)
                total = total + seg_loss_tokens(
                    probs, cells, sample_weight=weights) * text_w * 0.5
            for f in out.seg_tokens:
                pred = scoring.iqm_patch_pred(f, q)                   # (B, K)
                probs = torch.stack([1.0 - pred, pred], dim=1)
                total = total + seg_loss_tokens(
                    probs, cells, sample_weight=weights) * iqm_w * 0.5
            return total

        for f in out.seg_tokens:
            probs = scoring.similarity_map_train(f, anchors, img_size)
            total = total + seg_loss(probs, masks, sample_weight=weights) * text_w * 0.5
        for f in out.seg_tokens:
            iqm_map = scoring.iqm_train_map(f, q, img_size)
            total = total + seg_loss(iqm_map, masks, sample_weight=weights) * iqm_w * 0.5
        return total

    def accumulate(trainable, frozen, images, masks, labels, anchors, weights, rng):
        """Loss and gradients (left in ``.grad``) over the microbatches."""
        batch = images.shape[0]
        if batch % grad_accum:
            raise ValueError(
                f"batch size {batch} is not divisible by grad_accum_steps="
                f"{grad_accum}; run_stage2 pads its batches to a multiple of it")
        micro = batch // grad_accum
        num = w_tot = 0.0
        for k in range(grad_accum):
            sl = slice(k * micro, (k + 1) * micro)
            rng_k = None if rng is None else rng[sl]
            w_sum = weights[sl].float().sum()
            num_k = loss_fn(trainable, frozen, images[sl], masks[sl], labels[sl],
                            anchors[sl], weights[sl], rng_k) * w_sum
            num_k.backward()
            num = num + num_k.detach()
            w_tot = w_tot + w_sum
        denom = w_tot.clamp_min(1.0)
        for t in tree_leaves(trainable):
            if t.grad is not None:
                t.grad.div_(denom)
        return num / denom

    def update(trainable, opt_state: OptState, frozen, images, masks, labels,
               anchors, weights, rng=None):
        if isinstance(rng, torch.Generator):
            rng = keep_indices(rng, images.shape[0], images.device)
        _zero_grads(trainable)
        if grad_accum > 1:
            loss = accumulate(trainable, frozen, images, masks, labels, anchors,
                              weights, rng)
        else:
            loss = loss_fn(trainable, frozen, images, masks, labels, anchors,
                           weights, rng)
            loss.backward()
            loss = loss.detach()
        if clip_grad_norm is not None:
            clip_stage2_grads(trainable, clip_grad_norm)
        opt_state.optimizer.step()
        return loss

    def step(trainable, opt_state: OptState, frozen, images, masks, labels,
             anchors, weights, rng=None):
        loss = update(trainable, opt_state, frozen, images, masks, labels,
                      anchors, weights, rng)
        opt_state.advance()
        return trainable, opt_state, loss

    step.loss_fn = loss_fn
    step.update = update
    step.keep_indices = keep_indices
    return step
