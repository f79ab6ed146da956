"""Optimizers and schedules (torch.optim), mirroring the reference's settings.

Counterpart of ``aa_clip_iqm_tpu/train/optim.py`` (optax there).

Stage 1: Adam over the text adapter, lr 1e-5, betas (0.5, 0.999).

Stage 2: AdamW with two parameter groups,
  image_adapter:  lr = image_lr,       weight_decay 1e-4
  IQM family:     lr = image_lr * 0.1, weight_decay 1e-3
on a cosine schedule to eta_min = 1e-6 over the true total step count (the
reference steps a T_max = epochs scheduler per batch; ``torch_quirk_period_
steps`` reproduces that curve). The "frozen" label group (the stage-1 text
adapter, ``pos_embedding`` and ``iqm_layer_norm``, which sit in no optimizer
group of the reference either) is simply not handed to the optimizer.

optax's ``adamw`` applies ``lr * (adam_update + wd * p)`` with the schedule
evaluated at the 0-based step count; torch's ``AdamW`` (``p *= 1 - lr * wd``,
then ``p -= lr * adam_update``) with a ``LambdaLR`` stepped after the
optimizer gives the same numbers.

For a captured step (``train/graphs.py``) the optimizers are built
``graphable``, the default where the parameters lie on a CUDA device: every
group's learning rate is a 0-dim tensor on that device, which the scheduler
fills in place outside the graph (a float would be frozen into the capture),
and Adam / AdamW are ``capturable``, so that the step counters stay on the
device too. PyTorch refuses ``capturable`` on the CPU, where a graphable
optimizer keeps the tensor learning rate alone (in float64: the step reads it
as a Python float, so the updates are bit for bit the float rate's).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.convert import tree_leaves, tree_map


def cosine_annealing(base_lr: float, total_steps: int, eta_min: float = 1e-6,
                     torch_quirk_period_steps: Optional[int] = None):
    """CosineAnnealingLR-equivalent schedule: step -> learning rate.

    With ``torch_quirk_period_steps`` = T it is torch's periodic cosine
    eta_min + (base - eta_min) * (1 + cos(pi * t / T)) / 2 evaluated per step
    (the reference's per-batch stepping of a T_max = epochs scheduler).
    Otherwise one cosine over ``total_steps``, then constant eta_min."""
    if torch_quirk_period_steps is not None:
        period = torch_quirk_period_steps

        def schedule(step):
            return eta_min + (base_lr - eta_min) * (
                1 + math.cos(math.pi * step / period)) / 2

        return schedule
    decay_steps = max(total_steps, 1)
    alpha = eta_min / base_lr

    def schedule(step):
        cosine = 0.5 * (1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))
        return base_lr * ((1 - alpha) * cosine + alpha)

    return schedule


def _graphable(params, graphable: Optional[bool]) -> bool:
    if graphable is None:
        return any(p.device.type == "cuda" for p in params)
    return graphable


def _lr(value, params, graphable: bool):
    """A group's learning rate: the float, or for a graphable optimizer a
    0-dim tensor on the parameters' device (float32 beside the capturable
    step's float32 counters on the card, float64 on the CPU)."""
    if not graphable:
        return value
    device = params[0].device
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    return torch.tensor(float(value), dtype=dtype, device=device)


class OptState:
    """An optimizer with its (optional) scheduler: what the steps update and
    the checkpoints save. ``step()`` applies the gradients that the
    parameters hold and advances the schedule; a captured step runs
    ``optimizer.step()`` in its graph and ``advance()`` after the replay.
    ``version`` counts the loads: a load replaces the optimizer's state
    tensors, so a step captured before it is stale."""

    def __init__(self, optimizer, scheduler=None, graphable: bool = False):
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.graphable = graphable
        self.version = 0

    def step(self):
        self.optimizer.step()
        self.advance()

    def advance(self):
        """Advance the schedule: on a graphable optimizer it fills the
        learning-rate tensors in place."""
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": (self.scheduler.state_dict()
                              if self.scheduler is not None else None)}

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state["optimizer"])
        if self.scheduler is not None and state["scheduler"] is not None:
            self.scheduler.load_state_dict(state["scheduler"])
        self._settle_groups()
        self.version += 1

    def _settle_groups(self):
        """After a load, which takes the groups' settings and learning rates
        from the saved state (a float rate and ``capturable=False`` from a
        CPU run, CPU tensors from any checkpoint of a graphable one): each
        group's rate in this optimizer's form (:func:`_lr`), ``capturable``
        on the card when graphable, and the step counters where the step
        reads them (on the device when capturable, else on the CPU)."""
        for group in self.optimizer.param_groups:
            params = group["params"]
            lr = group["lr"]
            group["lr"] = _lr(lr.item() if isinstance(lr, torch.Tensor) else lr,
                              params, self.graphable)
            capturable = self.graphable and params[0].device.type == "cuda"
            group["capturable"] = capturable
            for p in params:
                state = self.optimizer.state.get(p, {})
                step = state.get("step")
                if isinstance(step, torch.Tensor):
                    where = p.device if capturable else torch.device("cpu")
                    state["step"] = step.to(device=where, dtype=torch.float32)


def stage1_optimizer(text_params, text_lr: float = 1e-5,
                     graphable: Optional[bool] = None) -> OptState:
    """Adam over the text adapter. ``graphable``: None decides by the
    parameters' device (the module docstring)."""
    params = list(tree_leaves(text_params))
    graphable = _graphable(params, graphable)
    capturable = graphable and params[0].device.type == "cuda"
    return OptState(torch.optim.Adam(params, lr=_lr(text_lr, params, graphable),
                                     betas=(0.5, 0.999), eps=1e-8,
                                     capturable=capturable),
                    graphable=graphable)


IQM_FAMILY_KEYS = (
    # The reference's iqm_params group is iqm + class_query_mlp +
    # query_adapters; the three projections are its lazily created, never
    # optimized nn.Linears, trained here on purpose.
    "iqm", "class_query_mlp", "query_adapters",
    "visual_feature_proj", "text_feature_proj", "query_proj",
)

# Reference modules that sit in no optimizer group and so stay at their
# initial values: the sinusoidal pos_embedding and the identity-affine
# iqm_layer_norm. Kept frozen (and in the checkpoint, unchanged).
UNTRAINED_IQM_KEYS = ("pos_embedding", "iqm_layer_norm")


def stage2_param_labels(trainable):
    """Label tree: 'image' / 'iqm' / 'frozen' per top-level group."""
    labels = {}
    for key, sub in trainable.items():
        if key == "image_adapter":
            label = "image"
        elif key in IQM_FAMILY_KEYS:
            label = "iqm"
        else:  # text_adapter (stage 1 only) + UNTRAINED_IQM_KEYS
            label = "frozen"
        labels[key] = tree_map(lambda _, label=label: label, sub)
    return labels


def _labelled(trainable, label):
    labels = stage2_param_labels(trainable)
    return [t for t, lab in zip(tree_leaves(trainable), tree_leaves(labels))
            if lab == label]


def stage2_optimizer(trainable, image_lr: float, total_steps: int,
                     iqm_lr_scale: float = 0.1, image_wd: float = 1e-4,
                     iqm_wd: float = 1e-3, eta_min: float = 1e-6,
                     torch_quirk_period_steps: Optional[int] = None,
                     graphable: Optional[bool] = None) -> OptState:
    """AdamW over the image and IQM groups on their cosine schedules.
    ``graphable``: None decides by the parameters' device (the module
    docstring)."""
    image = _labelled(trainable, "image")
    iqm = _labelled(trainable, "iqm")
    graphable = _graphable(image + iqm, graphable)
    capturable = graphable and image[0].device.type == "cuda"
    image_sched = cosine_annealing(image_lr, total_steps, eta_min,
                                   torch_quirk_period_steps)
    iqm_sched = cosine_annealing(image_lr * iqm_lr_scale, total_steps, eta_min,
                                 torch_quirk_period_steps)
    optimizer = torch.optim.AdamW(
        [{"params": image, "lr": _lr(image_lr, image, graphable),
          "weight_decay": image_wd},
         {"params": iqm, "lr": _lr(image_lr * iqm_lr_scale, iqm, graphable),
          "weight_decay": iqm_wd}],
        betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, [lambda step: image_sched(step) / image_lr,
                    lambda step: iqm_sched(step) / (image_lr * iqm_lr_scale)])
    return OptState(optimizer, scheduler, graphable=graphable)


def clip_stage2_grads(trainable, max_norm: float):
    """Global-norm clip, in place, over the gradients whose stage-2 updates
    apply. The 'frozen' label group gets real gradients in the backward (its
    tensors take part in the forward) but is never updated: counting it in
    the norm would over-clip the trained groups. No host synchronisation."""
    grads = [t.grad for label in ("image", "iqm")
             for t in _labelled(trainable, label) if t.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor.to(g.dtype))
