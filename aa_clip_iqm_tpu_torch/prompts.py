"""Prompt engine: anomaly-aware text-anchor construction.

Counterpart of ``aa_clip_iqm_tpu/prompts.py`` plus the anchor program of
``aa_clip_iqm_tpu/train/driver.py`` (``compute_frozen_anchors``). Per class,
normal/abnormal state sets are formatted with the class's descriptive "real
name", crossed with sentence templates, tokenized, encoded, L2-normalized,
mean-pooled per state, re-normalized and stacked into a (embed_dim, 2)
anchor pair.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from .configs import ModelConfig
from .data.registry import CLASS_NAMES, PROMPTS, REAL_NAMES
from .models import adapters as adapters_mod
from .ops.layers import l2_normalize
from .tokenizer import tokenize
from .utils.profiling import span, timed


def class_prompt_sentences(dataset_name: str, class_name: str) -> List[List[str]]:
    """[[normal sentences], [abnormal sentences]] for one class."""
    if class_name == "object":
        real_name = class_name
    else:
        if class_name not in CLASS_NAMES[dataset_name]:
            raise KeyError(
                f"class_name {class_name} not found; available: "
                f"{CLASS_NAMES[dataset_name]}"
            )
        real_name = REAL_NAMES[dataset_name][class_name]
    return [
        [template.format(state.format(real_name))
         for state in states for template in PROMPTS["templates"]]
        for states in (PROMPTS["normal"], PROMPTS["abnormal"])
    ]


def class_prompt_tokens(dataset_name: str, class_name: str, device="cuda"):
    """The tokenized prompt groups of one class: [normal, abnormal], each an
    (n_sentences, 77) int64 tensor on ``device``."""
    return [torch.from_numpy(np.asarray(tokenize(g), np.int64)).to(device)
            for g in class_prompt_sentences(dataset_name, class_name)]


def anchors_from_embeddings(normal_emb, abnormal_emb):
    """The mean of the L2-normalized embeddings of each state, normalized
    again, stacked (dim, 2) float32."""
    cols = []
    for emb in (normal_emb, abnormal_emb):
        mean = l2_normalize(emb.float()).mean(dim=0)
        cols.append(mean / torch.linalg.vector_norm(mean))
    return torch.stack(cols, dim=1)


def compute_class_anchor(encode_fn: Callable, dataset_name: str,
                         class_name: str, device="cuda"):
    """One class's (dim, 2) anchor. ``encode_fn`` maps (N, 77) int64 tokens
    on ``device`` to (N, dim) embeddings; ``class_name`` "object" takes the
    generic prompts."""
    normal, abnormal = class_prompt_tokens(dataset_name, class_name, device)
    return anchors_from_embeddings(encode_fn(normal), encode_fn(abnormal))


def compute_all_anchors(encode_fn: Callable, dataset_name: str,
                        device="cuda") -> Dict[str, torch.Tensor]:
    """Every class's (dim, 2) anchor, one :func:`compute_class_anchor` a
    class."""
    return {c: compute_class_anchor(encode_fn, dataset_name, c, device)
            for c in CLASS_NAMES[dataset_name]}


def per_sentence_embeddings(encode_fn: Callable, dataset_name: str,
                            class_name: str, device="cuda"):
    """The L2-normalized float32 embedding of every prompt sentence of one
    class, unpooled, normal then abnormal: (n_normal + n_abnormal, dim)."""
    groups = class_prompt_tokens(dataset_name, class_name, device)
    return torch.cat([l2_normalize(encode_fn(g).float()) for g in groups], dim=0)


def stack_batch_anchors(anchor_dict, class_names) -> torch.Tensor:
    """The (B, dim, 2) stack of each sample's class anchor."""
    return torch.stack([anchor_dict[c] for c in class_names], dim=0)


def batched_prompt_tokens(dataset_name: str):
    """All classes' prompt tokens stacked for one batched encoder call:
    returns (classes, tokens (C*S, 77) int32 numpy, n_normal, n_abnormal)."""
    classes = list(CLASS_NAMES[dataset_name])
    per_class = [class_prompt_sentences(dataset_name, c) for c in classes]
    n_normal = len(per_class[0][0])
    n_abnormal = len(per_class[0][1])
    sentences = []
    for normal, abnormal in per_class:
        sentences.extend(normal)
        sentences.extend(abnormal)
    return classes, tokenize(sentences), n_normal, n_abnormal


def anchors_from_flat_embeddings(emb, n_classes: int, n_normal: int,
                                 n_abnormal: int):
    """(C*(n_normal+n_abnormal), dim) -> (C, dim, 2) float32 anchors."""
    per = n_normal + n_abnormal
    e = l2_normalize(emb.float()).reshape(n_classes, per, -1)
    normal = e[:, :n_normal].mean(dim=1)
    abnormal = e[:, n_normal:].mean(dim=1)
    normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    abnormal = abnormal / torch.linalg.vector_norm(abnormal, dim=-1, keepdim=True)
    return torch.stack([normal, abnormal], dim=2)


def compute_frozen_anchors(frozen, trainable, model_cfg: ModelConfig,
                           dataset_name: str, adapted: bool,
                           compute_dtype=torch.float32,
                           use_pallas: bool = True) -> Dict[str, torch.Tensor]:
    """Per-class anchors (dim, 2) from the adapted (or raw) text encoder; all
    classes' sentences go through one batched encoder call, on the device
    that holds the text tower. Built under ``no_grad`` with inference mode
    off, so that stage 2's loss can save the anchors for its backward (an
    inference tensor cannot be saved), even when the caller is in inference
    mode itself. ``use_pallas=False``: the text tower on stock PyTorch
    calls, no hand-written kernel (``models.clip``). Its seconds, the
    device's work included (it synchronises a CUDA device), add to the
    counter ``setup.anchors_s``."""
    with span("setup/anchors"), timed("setup.anchors_s"):
        classes, tokens, n_norm, n_abn = batched_prompt_tokens(dataset_name)
        device = frozen["text"]["token_embedding"].device
        tokens = torch.from_numpy(np.asarray(tokens, np.int64)).to(device)
        with torch.inference_mode(False), torch.no_grad():
            if adapted:
                emb = adapters_mod.encode_text_adapted(
                    frozen, trainable, model_cfg, tokens, compute_dtype=compute_dtype,
                    use_pallas=use_pallas)
            else:
                emb = adapters_mod.encode_text_frozen(
                    frozen, model_cfg, tokens, compute_dtype=compute_dtype,
                    use_pallas=use_pallas)
            anchors = anchors_from_flat_embeddings(emb, len(classes), n_norm, n_abn)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return {c: anchors[i] for i, c in enumerate(classes)}
