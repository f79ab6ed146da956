"""Checkpoints with the reference's directory-scan resume.

Counterpart of ``aa_clip_iqm_tpu/train/checkpoint.py`` (orbax there). Same
directory names under ``save_path``:

  text_adapter/                  stage 1, rolling resume point
  image_adapter/                 stage 2, rolling resume point
  image_adapter_{N}/             stage 2, per epoch (params only)
  {text,image}_adapter_step/     the opt-in mid-epoch tier

Each holds one file, ``checkpoint.pt`` (``torch.save``): the parameter tree
on the CPU, the optimizer and scheduler state, the epoch and, for the step
tier, the step. It is written under a temporary name and renamed into place,
so a checkpoint is either the old one or the new one, never half of each.
The stage-2 checkpoint holds the full trainable tree (the IQM family too).

A step checkpoint records {epoch, step, params, optimizer}; ``train.driver``
resumes at (epoch, step) by re-deriving the epoch's data order from (seed,
epoch) and skipping the consumed batches. Completing an epoch clears it, so
a surviving one always refers to the epoch in progress.

Loading copies into the tensors it is given (the optimizer holds references
to them) and returns them.
"""
from __future__ import annotations

import os
import re
import shutil
from typing import Optional

import torch

from ..models.convert import tree_map
from .optim import OptState

FILE = "checkpoint.pt"


def _to_cpu(tree):
    return tree_map(lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
                    tree)


def save_state(directory: str, state: dict):
    """One atomic file: written beside its final name, then renamed."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, FILE)
    tmp = f"{final}.{os.getpid()}.tmp"
    torch.save(_to_cpu(state), tmp)
    os.replace(tmp, final)


def _load(directory: str) -> Optional[dict]:
    path = os.path.join(directory, FILE)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location="cpu", weights_only=True)


def _restore(state, params, opt_state: Optional[OptState]):
    """Copy a loaded state into ``params`` (in place, matched by key, so
    that the two trees' key orders need not agree) and ``opt_state``."""
    with torch.no_grad():
        tree_map(lambda dst, src: dst.copy_(src), params, state["params"])
    out = {"epoch": int(state["epoch"]), "params": params, "opt_state": None}
    if opt_state is not None and state.get("opt") is not None:
        opt_state.load_state_dict(state["opt"])
        out["opt_state"] = opt_state
    return out


def _opt(opt_state):
    return None if opt_state is None else opt_state.state_dict()


def _step_dir(save_path: str, stage: str) -> str:
    return os.path.join(save_path, {"stage1": "text_adapter_step",
                                    "stage2": "image_adapter_step"}[stage])


def save_step(save_path: str, stage: str, epoch: int, step: int, params, opt):
    """Mid-epoch step checkpoint: params + optimizer state + (epoch, step).
    ``step`` counts completed steps inside ``epoch``: resume continues at
    batch index ``step`` of that epoch's deterministic order. ``opt`` is an
    :class:`OptState` or an already taken ``state_dict()``."""
    if isinstance(opt, OptState):
        opt = opt.state_dict()
    save_state(_step_dir(save_path, stage),
               {"epoch": epoch, "step": step, "params": params, "opt": opt})


def load_step(save_path: str, stage: str, params, opt_state: OptState,
              min_epoch: int = 0):
    """Returns {epoch, step, params, opt_state} or None (also for a step
    checkpoint of an epoch before ``min_epoch``, which restores nothing).
    Unlike the epoch tier, the optimizer state is mandatory: resuming
    mid-epoch with a fresh optimizer would diverge from the uninterrupted
    run without a word."""
    state = _load(_step_dir(save_path, stage))
    if state is None or state.get("opt") is None or int(state["epoch"]) < min_epoch:
        return None
    out = _restore(state, params, opt_state)
    out["step"] = int(state["step"])
    return out


def clear_step(save_path: str, stage: str):
    """Drop the step checkpoint (after each completed epoch)."""
    shutil.rmtree(_step_dir(save_path, stage), ignore_errors=True)


def save_stage1(save_path: str, epoch: int, text_adapter, opt_state):
    save_state(os.path.join(save_path, "text_adapter"),
               {"epoch": epoch, "params": text_adapter, "opt": _opt(opt_state)})


def load_stage1(save_path: str, text_adapter, opt_state=None):
    state = _load(os.path.join(save_path, "text_adapter"))
    return None if state is None else _restore(state, text_adapter, opt_state)


def save_stage2(save_path: str, epoch: int, trainable, opt_state,
                keep_last: int = 0):
    save_state(os.path.join(save_path, "image_adapter"),
               {"epoch": epoch, "params": trainable, "opt": _opt(opt_state)})
    save_state(os.path.join(save_path, f"image_adapter_{epoch}"),
               {"epoch": epoch, "params": trainable, "opt": None})
    if keep_last > 0:
        prune_numbered(save_path, keep_last)


def _numbered(save_path: str):
    found = []
    for name in os.listdir(save_path):
        m = re.fullmatch(r"image_adapter_(\d+)", name)
        if m:
            found.append((int(m.group(1)), os.path.join(save_path, name)))
    return sorted(found)


def prune_numbered(save_path: str, keep_last: int):
    """Delete all but the newest ``keep_last`` image_adapter_{N} directories."""
    for _, path in _numbered(save_path)[:-keep_last]:
        shutil.rmtree(path, ignore_errors=True)


def latest_numbered_dir(save_path: str) -> Optional[str]:
    if not os.path.isdir(save_path):
        return None
    found = _numbered(save_path)
    return found[-1][1] if found else None


def load_stage2(save_path: str, trainable, opt_state=None,
                latest_numbered: bool = False):
    """The resume point (image_adapter/) or, for evaluation, the numerically
    latest image_adapter_{N}/."""
    base = (latest_numbered_dir(save_path) if latest_numbered
            else os.path.join(save_path, "image_adapter"))
    state = None if base is None else _load(base)
    return None if state is None else _restore(state, trainable, opt_state)


def restore_adapters(save_path: str, trainable, require_stage2: bool = True):
    """Evaluation-time restore shared by the entry points: the stage-1 text
    adapter if present, then the numerically latest stage-2 checkpoint.

    Returns ``(trainable, adapted_text, epoch)``; ``epoch`` is None when no
    stage-2 checkpoint exists (only with ``require_stage2=False``, the
    zero-shot case; otherwise FileNotFoundError)."""
    adapted = load_stage1(save_path, trainable["text_adapter"]) is not None
    restored = load_stage2(save_path, trainable, latest_numbered=True)
    if restored is None:
        if require_stage2:
            raise FileNotFoundError(
                f"no stage-2 image-adapter checkpoint under {save_path}")
        return trainable, adapted, None
    return restored["params"], adapted, restored["epoch"]
