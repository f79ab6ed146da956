"""Two-stage training orchestration (reference train.py:240-436).

Counterpart of ``aa_clip_iqm_tpu/train/driver.py``.
``run_training(frozen, trainable, model_cfg, train_cfg, logger)`` runs:
  stage 1: text-anchor adaptation, with checkpoint resume;
  anchor freeze: adapted (or raw, if text_epoch == 0) per-class anchors;
  stage 2: image adapter + IQM training with per-epoch checkpoints.

``frozen`` is the backbone (bf16 on the card, never requiring grad);
``trainable`` holds float32 master weights that require grad
(``loader.init_trainable(..., dtype=torch.float32, requires_grad=True)``).
Everything runs on the device that holds the backbone.

Resumability: both stages resume at epoch granularity from the rolling
checkpoint and, with ``TrainConfig.checkpoint_every_steps`` > 0, at step
granularity from the step tier. In-epoch resume is exact because each
epoch's batch stream is a pure function of (dataset seed, epoch)
(``TrainDataset.epoch_batches``) and the per-step patch-dropout generator is
seeded from (seed, epoch, step): no sequential random state survives an
interruption.

Programs: on a CUDA device the stage-1 feature program and both steps run as
CUDA graphs (``train/graphs.py``: one capture per batch shape, the tail
batch's included, after any checkpoint load), with graphable optimizers;
on the CPU, and under NaN checks, they run eagerly as before. The two routes
take the same steps on the same data.

Data parallelism (``mesh=``, a ``parallel.mesh.Mesh``, one process per
card): every rank runs the same loop on its own rows of each batch. A batch
is padded with zero-weight rows to a multiple of the data ranks (stage 2:
of lcm(data ranks, grad_accum_steps)), as JAX's driver pads to its devices,
and each rank decodes only its block of it (``process_local_rows``;
``TrainDataset.epoch_batches(rows=...)``). The trainable tensors are
replicated: rank 0's are broadcast at the start (``parallel.mesh.
replicate``), every rank computes the same anchors from them, and every
rank takes the same steps (``train/steps.py`` sums the gradients). Rank 0 alone
writes the checkpoints, the step checkpoints and ``scalars.jsonl``; a
resume loads them on every rank. The steps run as CUDA graphs on an NCCL
process group, eagerly on gloo (``graphs.enabled``).

Observability: per-step {stage, epoch, step, loss, lr, wall_ms} rows are
appended to {save_path}/scalars.jsonl at each epoch end. Losses stay on the
device during the epoch and are fetched in one transfer: the step loop never
synchronizes.
"""
from __future__ import annotations

import copy
import json
import math
import os
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..configs import ModelConfig, TrainConfig
from ..data.datasets import get_dataset, prefetch
from ..models.convert import tree_map
from ..parallel.mesh import replicate
from ..parallel.multihost import is_primary, process_local_rows
from ..prompts import batched_prompt_tokens, compute_frozen_anchors
from . import checkpoint as ckpt
from . import graphs, optim, steps

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _device_of(frozen):
    return frozen["visual"]["proj"].device


def _pad_batch(batch, multiple: int):
    """Zero-pad the batch to a multiple; the returned n_valid feeds a
    per-sample weight mask so that padded rows carry zero loss."""
    n = batch["image"].shape[0]
    if n % multiple == 0:
        return batch, n
    pad = multiple - n % multiple

    def pad_arr(x):
        return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)

    out = dict(batch)
    for key in ("image", "mask"):
        out[key] = pad_arr(batch[key])
    out["label"] = np.concatenate([batch["label"], np.zeros(pad, np.int64)])
    out["class_name"] = list(batch["class_name"]) + [batch["class_name"][-1]] * pad
    return out, n


def _rows(mesh, accum: int = 1) -> dict:
    """``epoch_batches``' keyword for a rank's rows of a batch of n samples
    padded to a multiple of lcm(data ranks, ``accum``); none without a mesh
    (the whole batch, padded by :func:`_pad_batch`)."""
    if mesh is None:
        return {}
    multiple = math.lcm(mesh.data_size, accum)
    return {"rows": lambda n: process_local_rows(mesh, -(-n // multiple) * multiple)}


def _append_scalars(save_path: str, stage: str, epoch: int, first_step: int,
                    loss_host, lrs, wall_ms):
    """Append per-step scalar rows to {save_path}/scalars.jsonl.

    Schema: {"stage", "epoch", "step", "loss", "lr", "wall_ms"}; step is the
    batch index within the epoch. wall_ms is host dispatch-to-dispatch time:
    launches do not wait, so early steps read fast, but once the queue fills
    the host is held to the device's step rate, and the epoch mean of
    wall_ms is the real step time.
    """
    os.makedirs(save_path, exist_ok=True)
    with open(os.path.join(save_path, "scalars.jsonl"), "a") as f:
        for i, loss in enumerate(np.asarray(loss_host, np.float64)):
            f.write(json.dumps({
                "stage": stage, "epoch": int(epoch),
                "step": int(first_step + i), "loss": float(loss),
                "lr": float(np.asarray(lrs)[i]),
                "wall_ms": round(float(wall_ms[i]), 3)}) + "\n")


class _StepSaver:
    """Overlapped mid-epoch checkpoint writer.

    ``save()`` snapshots the parameters and the optimizer state by
    ``clone()`` on the device (queued behind the step that produced them,
    before the next step's in-place update) and hands the copy to the host
    and the file write to a background thread, so the step loop never waits
    for the host link. The checkpoint is exactly the state at (epoch, step),
    however far training has advanced when the write lands. At most one save
    is in flight; errors surface at the next ``save()`` / ``wait()``. Callers
    ``wait()`` before the epoch-tier save and clear (a concurrent rmtree
    would race the write) and when the loop exits.
    """

    def __init__(self, use_async: bool = True):
        self.use_async = use_async
        self._thread = None
        self._err = None

    def save(self, save_path: str, stage: str, epoch: int, step: int, params,
             opt_state):
        if not self.use_async:
            ckpt.save_step(save_path, stage, epoch, step, params, opt_state)
            return
        self.wait()

        def snap(t):
            return t.detach().clone() if isinstance(t, torch.Tensor) else copy.copy(t)

        params_snap = tree_map(snap, params)
        opt_snap = tree_map(snap, opt_state.state_dict())

        def work():
            try:
                ckpt.save_step(save_path, stage, epoch, step, params_snap, opt_snap)
            except BaseException as e:  # surfaced on the main thread
                self._err = e

        self._thread = threading.Thread(target=work, name=f"step-ckpt-{stage}",
                                        daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err


def _load_step_resume(train_cfg: TrainConfig, stage: str, params, opt_state,
                      start_epoch: int, logger):
    """Mid-epoch resume point, if one exists for the epoch in progress.

    Returns (start_epoch, start_step); the parameters and the optimizer are
    restored in place. A step checkpoint from an epoch that was completed
    (possible only if the clear after the epoch was lost to a crash) is
    ignored: the epoch tier wins."""
    if train_cfg.checkpoint_every_steps <= 0:
        return start_epoch, 0
    restored = ckpt.load_step(train_cfg.save_path, stage, params, opt_state,
                              min_epoch=start_epoch)
    if restored is None:
        return start_epoch, 0
    logger.info("resumed %s mid-epoch at epoch %d step %d", stage,
                restored["epoch"], restored["step"])
    return restored["epoch"], restored["step"]


def _finish_epoch(train_cfg, stage, epoch, first, losses, lrs, wall_ms, t0, logger):
    if losses:
        loss_host = torch.stack(losses).float().cpu().numpy()   # one fetch
        mean_loss = float(loss_host.mean())
        if is_primary():
            _append_scalars(train_cfg.save_path, stage, epoch, first, loss_host, lrs,
                            wall_ms)
    else:
        mean_loss = float("nan")
    logger.info("loss: %f (%.1fs)", mean_loss, time.time() - t0)


def run_stage1(frozen, trainable, model_cfg: ModelConfig, train_cfg: TrainConfig,
               text_dataset, logger, mesh=None):
    """Train ``trainable["text_adapter"]`` in place; returns ``trainable``.
    ``mesh``: data parallelism (module docstring)."""
    dtype = _DTYPES[train_cfg.compute_dtype]
    device = _device_of(frozen)
    classes, prompt_toks, n_norm, n_abn = batched_prompt_tokens(train_cfg.dataset)
    class_to_idx = {c: i for i, c in enumerate(classes)}
    prompt_toks = torch.from_numpy(np.asarray(prompt_toks, np.int64)).to(device)

    text_params = trainable["text_adapter"]
    graphed = graphs.enabled(device, mesh)
    primary = is_primary()
    opt_state = optim.stage1_optimizer(text_params, train_cfg.text_lr,
                                       graphable=graphed)
    start_epoch = 0
    restored = ckpt.load_stage1(train_cfg.save_path, text_params, opt_state)
    if restored is not None:
        start_epoch = restored["epoch"]
        logger.info("resumed stage 1 from epoch %d", start_epoch)
    start_epoch, start_step = _load_step_resume(
        train_cfg, "stage1", text_params, opt_state, start_epoch, logger)

    visual_fn = steps.make_stage1_visual_fn(model_cfg, compute_dtype=dtype, mesh=mesh)
    step_fn = steps.make_stage1_step(model_cfg, train_cfg, prompt_toks,
                                     len(classes), n_norm, n_abn,
                                     compute_dtype=dtype, mesh=mesh)
    rows = _rows(mesh)
    if graphed:   # captured after the resume above has loaded the state
        cache = graphs.GraphCache()
        visual_fn = graphs.GraphedFn(visual_fn, cache, "stage1 features")
        step_fn = graphs.GraphedStep(step_fn, cache, "stage1 step")
    every = train_cfg.checkpoint_every_steps
    saver = _StepSaver(train_cfg.async_step_checkpoint)
    try:
        for epoch in range(start_epoch, train_cfg.text_epoch):
            first = start_step if epoch == start_epoch else 0
            logger.info("training text epoch %d:", epoch)
            losses, wall_ms = [], []
            t0 = time.time()
            t_prev = time.perf_counter()
            for i, batch in enumerate(prefetch(text_dataset.epoch_batches(
                    epoch, train_cfg.text_batch_size, start_batch=first, **rows))):
                step = first + i
                n = batch["image"].shape[0]
                n_valid = batch.get("n_valid", n)
                images = torch.from_numpy(batch["image"]).to(device)
                masks = torch.from_numpy(batch["mask"]).to(device)
                class_idx = torch.tensor(
                    [class_to_idx[c] for c in batch["class_name"]], device=device)
                weights = (torch.arange(n, device=device) < n_valid).float()
                patch_feats = visual_fn(frozen, images)
                text_params, opt_state, loss = step_fn(
                    text_params, opt_state, frozen, patch_feats, masks,
                    class_idx, weights)
                losses.append(loss)     # stays on the device
                now = time.perf_counter()
                wall_ms.append((now - t_prev) * 1e3)
                t_prev = now
                if primary and every > 0 and (step + 1) % every == 0:
                    saver.save(train_cfg.save_path, "stage1", epoch, step + 1,
                               text_params, opt_state)
                    t_prev = time.perf_counter()  # leave the snapshot out
            _finish_epoch(train_cfg, "stage1", epoch, first, losses,
                          np.full(len(losses), train_cfg.text_lr), wall_ms, t0, logger)
            saver.wait()  # the epoch-tier save/clear must not race a step write
            if primary:
                ckpt.save_stage1(train_cfg.save_path, epoch + 1, text_params, opt_state)
                if every > 0:
                    ckpt.clear_step(train_cfg.save_path, "stage1")
    finally:
        # On an interruption, let the snapshot in flight land: it is a
        # consistent (epoch, step) state. An error here must not mask the
        # original exception.
        try:
            saver.wait()
        except Exception:
            logger.exception("in-flight step checkpoint failed during unwind")
    return trainable


def run_stage2(frozen, trainable, model_cfg: ModelConfig, train_cfg: TrainConfig,
               image_dataset, anchors, logger, mesh=None):
    """Train the image adapter and the IQM family in place; returns
    ``trainable``. ``mesh``: data parallelism (module docstring)."""
    dtype = _DTYPES[train_cfg.compute_dtype]
    device = _device_of(frozen)
    accum = max(1, train_cfg.grad_accum_steps)
    if accum > 1 and train_cfg.image_batch_size % accum:
        raise ValueError(
            f"image_batch_size={train_cfg.image_batch_size} must be divisible "
            f"by grad_accum_steps={accum} (every full batch splits into equal "
            "microbatches; only tails are padded)")
    # ceil: epoch_batches yields the partial tail batch, so the schedule
    # counts it too.
    steps_per_epoch = max(1, -(-len(image_dataset) // train_cfg.image_batch_size))
    total_steps = steps_per_epoch * train_cfg.image_epoch
    quirk = train_cfg.image_epoch if train_cfg.torch_lr_quirk else None
    graphed = graphs.enabled(device, mesh)
    primary = is_primary()
    opt_state = optim.stage2_optimizer(
        trainable, train_cfg.image_lr, total_steps,
        iqm_lr_scale=train_cfg.iqm_lr_scale,
        image_wd=train_cfg.image_weight_decay, iqm_wd=train_cfg.iqm_weight_decay,
        torch_quirk_period_steps=quirk, graphable=graphed)
    start_epoch = 0
    restored = ckpt.load_stage2(train_cfg.save_path, trainable, opt_state)
    if restored is not None:
        start_epoch = restored["epoch"]
        logger.info("resumed stage 2 from epoch %d", start_epoch)
    start_epoch, start_step = _load_step_resume(
        train_cfg, "stage2", trainable, opt_state, start_epoch, logger)
    # The image group's LR curve, evaluated again on the host for the rows
    # of scalars.jsonl.
    lr_sched = optim.cosine_annealing(train_cfg.image_lr, total_steps,
                                      torch_quirk_period_steps=quirk)

    step_fn = steps.make_stage2_step(model_cfg, train_cfg, compute_dtype=dtype,
                                     clip_grad_norm=train_cfg.clip_grad_norm, mesh=mesh)
    rows = _rows(mesh, accum)
    if graphed:   # captured after the resume above has loaded the state
        step_fn = graphs.GraphedStep(step_fn, graphs.GraphCache(), "stage2 step")
    patch_drop = model_cfg.clip.vision.patch_dropout > 0.0
    every = train_cfg.checkpoint_every_steps
    saver = _StepSaver(train_cfg.async_step_checkpoint)
    try:
        for epoch in range(start_epoch, train_cfg.image_epoch):
            first = start_step if epoch == start_epoch else 0
            logger.info("training image epoch %d:", epoch)
            losses, wall_ms = [], []
            t0 = time.time()
            t_prev = time.perf_counter()
            for i, batch in enumerate(prefetch(image_dataset.epoch_batches(
                    epoch, train_cfg.image_batch_size, start_batch=first, **rows))):
                step = first + i
                if mesh is None:
                    # Tail batches must split into grad_accum microbatches too.
                    batch, n_valid = _pad_batch(batch, accum)
                else:
                    n_valid = batch["n_valid"]
                n = batch["image"].shape[0]
                anchor_stack = torch.stack([anchors[c] for c in batch["class_name"]])
                weights = (torch.arange(n, device=device) < n_valid).float()
                rng = None
                if patch_drop:
                    # One generator per (seed, epoch, step): a mid-epoch
                    # resume draws the masks the uninterrupted run drew. A
                    # captured step draws from it outside its graph.
                    rng = torch.Generator(device=device)
                    rng.manual_seed(int(np.random.SeedSequence(
                        (train_cfg.seed, epoch, step)).generate_state(1)[0]))
                trainable, opt_state, loss = step_fn(
                    trainable, opt_state, frozen,
                    torch.from_numpy(batch["image"]).to(device),
                    torch.from_numpy(batch["mask"]).to(device),
                    torch.from_numpy(batch["label"]).to(device),
                    anchor_stack, weights, rng)
                losses.append(loss)
                now = time.perf_counter()
                wall_ms.append((now - t_prev) * 1e3)
                t_prev = now
                if primary and every > 0 and (step + 1) % every == 0:
                    saver.save(train_cfg.save_path, "stage2", epoch, step + 1,
                               trainable, opt_state)
                    t_prev = time.perf_counter()  # leave the snapshot out
            g0 = epoch * steps_per_epoch + first
            _finish_epoch(train_cfg, "stage2", epoch, first, losses,
                          [lr_sched(g0 + k) for k in range(len(losses))], wall_ms,
                          t0, logger)
            saver.wait()  # the epoch-tier save/clear must not race a step write
            if primary:
                ckpt.save_stage2(train_cfg.save_path, epoch + 1, trainable, opt_state,
                                 keep_last=train_cfg.keep_checkpoints)
                if every > 0:
                    ckpt.clear_step(train_cfg.save_path, "stage2")
    finally:
        try:
            saver.wait()
        except Exception:
            logger.exception("in-flight step checkpoint failed during unwind")
    return trainable


def run_training(frozen, trainable, model_cfg: ModelConfig, train_cfg: TrainConfig,
                 logger, metadata_root: Optional[str] = None, mesh=None):
    """The full two-stage pipeline. Returns (trainable, anchors). ``mesh``:
    data parallelism (module docstring)."""
    if mesh is not None:
        replicate(mesh, trainable)      # every rank starts from rank 0's adapters
    text_ds, image_ds = get_dataset(
        train_cfg.dataset, train_cfg.img_size, train_cfg.training_mode,
        train_cfg.shot, "train", logger, metadata_root=metadata_root,
        seed=train_cfg.seed)

    if train_cfg.text_epoch > 0:
        trainable = run_stage1(frozen, trainable, model_cfg, train_cfg, text_ds,
                               logger, mesh=mesh)
    anchors = compute_frozen_anchors(
        frozen, trainable, model_cfg, train_cfg.dataset,
        adapted=train_cfg.text_epoch > 0,
        compute_dtype=_DTYPES[train_cfg.compute_dtype])
    trainable = run_stage2(frozen, trainable, model_cfg, train_cfg, image_ds,
                           anchors, logger, mesh=mesh)
    return trainable, anchors
