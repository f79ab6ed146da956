"""Inference pipeline: fused anomaly-map prediction + per-class evaluation.

Counterpart of ``aa_clip_iqm_tpu/evaluation/predict.py``: the scoring path
(adapted ViT forward, seg projections, anchor similarity, IQM query maps,
blur/upsample as matmuls, fusion and the image logit) as ``make_predict_fn``,
and the per-class loop around it: ``predict_class``,
``class_metrics_device``, ``evaluate_dataset`` and ``results_table``.
PyTorch runs eagerly, so the returned predict function is the program
itself, and nothing needs shape buckets to avoid recompiles; the tail-batch
ladder and the metric bucket are kept so that both packages run the same
batches. Data-parallel evaluation over several cards is not ported yet.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import EvalConfig, ModelConfig
from ..data.registry import DOMAINS, IMAGE_MEAN, IMAGE_STD
from ..models import adapters as adapters_mod
from ..ops.interp import device_constant
from ..ops.metrics import (
    DEFAULT_CHUNK,
    _rank_metrics,
    masked_conditional_minmax,
    metrics_eval,
    pixel_metrics_device,
)
from . import scoring

METRIC_KEYS = ("pixel AUC", "pixel AP", "image AUC", "image AP")


def _device_normalize(images_u8):
    """CLIP normalization of CHW uint8 images on their device, in the op
    order of the host normalization ((u8/255 - mean)/std in fp32), so the
    result is bit-identical to host-normalized float32 input."""
    dev = images_u8.device
    # Device constants, built once outside any trace or graph capture.
    mean = device_constant("image_mean", dev,
                           lambda: np.asarray(IMAGE_MEAN, np.float32).reshape(1, 3, 1, 1))
    std = device_constant("image_std", dev,
                          lambda: np.asarray(IMAGE_STD, np.float32).reshape(1, 3, 1, 1))
    return (images_u8.float() / 255.0 - mean) / std


def make_predict_fn(cfg: ModelConfig, img_size: int, domain: str,
                    use_iqm: bool = True, compute_dtype=torch.float32,
                    text_weight: float = 0.6, iqm_weight: float = 0.4,
                    image_score_mode: str = "fixed", use_pallas: bool = True):
    """Build predict(frozen, trainable, images, anchors) ->
    (final_map (B, H, W) fp32, image_logit (B,) fp32).

    images: (B, 3, H, W) uint8 (normalized here) or float32 CLIP-normalized,
    on the parameters' device. anchors: (B, embed_dim, 2).
    image_score_mode: "fixed" (per-sample abnormal logit, default) or
    "reference_eval" (the executed reference's eval transcription; needs
    batch >= 2 and depends on the batch's composition, like the reference).
    use_pallas: True (the port's default; JAX's is False) runs the
    hand-written kernels; False the stock PyTorch route with none
    (``models.clip``), JAX's XLA chain.
    """
    if image_score_mode not in ("fixed", "reference_eval"):
        raise ValueError(f"unknown image_score_mode {image_score_mode!r}")
    logit_fn = (scoring.image_logit if image_score_mode == "fixed"
                else scoring.image_logit_reference_eval)

    def predict(frozen, trainable, images, anchors):
        with torch.inference_mode():
            if images.dtype == torch.uint8:
                images = _device_normalize(images)
            out = adapters_mod.encode_image_adapted(
                frozen, trainable, cfg, images,
                text_anchors=anchors if use_iqm else None,
                compute_dtype=compute_dtype, use_pallas=use_pallas)
            img_logit = logit_fn(out.det_token, anchors)
            text_maps = [
                scoring.similarity_map_test(s, anchors, img_size, domain)
                for s in out.seg_tokens
            ]
            iqm_maps = []
            if use_iqm:
                q = adapters_mod.project_queries(trainable, out.iqm_queries)
                iqm_maps = [scoring.iqm_score_map(s, q, img_size)
                            for s in out.seg_tokens]
            final = scoring.fuse_maps(text_maps, iqm_maps,
                                      text_weight=text_weight,
                                      iqm_weight=iqm_weight)
            return final.float(), img_logit.float()

    return predict


def _tail_buckets(batch_size: int):
    """Bucket ladder for ragged tail batches: powers of two below
    batch_size, then batch_size itself (the serving ladder's idea)."""
    ladder = [b for b in (1, 2, 4, 8, 16, 32, 64, 128) if b < batch_size]
    return tuple(ladder) + (batch_size,)


def predict_class(predict_fn, frozen, trainable, dataset, class_anchor,
                  batch_size: int, device_resident: bool = False,
                  image_score_mode: str = "fixed", buckets=None):
    """Run a per-class test dataset through the predict fn.

    Full batches run at the fixed batch size; the ragged tail batch is
    zero-padded only up to the smallest bucket of ``_tail_buckets`` that
    fits — a 33-image class at batch 32 runs 32+1 images of compute, not 64.
    With ``device_resident`` the anomaly maps, masks and image logits stay
    on the device (for on-device metrics), written into tensors allocated
    once for the whole class; otherwise they come back as numpy arrays.

    ``image_score_mode`` must echo the mode ``predict_fn`` was built with:
    "reference_eval" scores the batch from sample index 1, so a tail batch
    with a single valid sample would silently score from a zero-padded row;
    the reference's executed eval would crash there, and so does this.

    ``buckets``: override the tail ladder — ``(batch_size,)`` pads every
    tail to the full batch.
    """
    from ..data.datasets import prefetch

    device = class_anchor.device
    total = len(dataset)
    maps = masks = scores = None
    labels, file_names = [], []
    if buckets is None:
        buckets = _tail_buckets(batch_size)
    start = 0
    for batch in prefetch(dataset.batches(batch_size)):
        n = batch["n_valid"]
        if image_score_mode == "reference_eval" and n < 2:
            raise ValueError(
                "image_score_mode='reference_eval' needs >= 2 valid samples "
                f"per batch (got a batch with {n}); the reference's executed "
                "eval indexes sample 1 and would crash here too. Use "
                "--image_score_mode fixed or a batch size that avoids "
                "1-sample tail batches.")
        bucket = next(b for b in buckets if b >= n)
        images = batch["image"]
        if bucket != n:
            images = np.concatenate(
                [images, np.zeros((bucket - n,) + images.shape[1:],
                                  images.dtype)], axis=0)
        anchor_b = class_anchor[None].expand((bucket,) + tuple(class_anchor.shape))
        final_map, img_logit = predict_fn(
            frozen, trainable,
            torch.from_numpy(np.ascontiguousarray(images)).to(device), anchor_b)
        if maps is None:
            where = device if device_resident else "cpu"
            maps = torch.empty((total,) + tuple(final_map.shape[1:]),
                               dtype=torch.float32, device=where)
            scores = torch.empty((total,), dtype=torch.float32, device=where)
            masks = (torch.empty(maps.shape, dtype=torch.bool, device=device)
                     if device_resident else
                     np.empty((total, 1) + tuple(final_map.shape[1:]), np.float32))
        maps[start:start + n] = final_map[:n]
        scores[start:start + n] = img_logit[:n]
        if device_resident:
            masks[start:start + n] = torch.from_numpy(
                batch["mask"][:n, 0] != 0).to(device)
        else:
            masks[start:start + n] = batch["mask"][:n]
        labels.append(batch["label"][:n])
        file_names.extend(batch["file_name"][:n])
        start += n
    if maps is None:
        raise ValueError("predict_class: the dataset is empty")
    return {
        "masks": masks,
        "labels": np.concatenate(labels, axis=0),
        "maps": maps if device_resident else maps.numpy(),
        "image_scores": scores if device_resident else scores.numpy(),
        "file_names": file_names,
    }


def _bucket(n: int, multiple: int = 16) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def _image_metrics_device(pmax, image_scores, labels, valid, n_valid,
                          medical: bool, mixed_labels: bool):
    """Image-level AUROC/AP on the device over a (possibly padded) class.

    Mirrors the host path: conditional min-max of the raw image logits,
    0.5/0.5 blend with the per-image normalized map maxima (Medical domain:
    the maxima only), then rank metrics over the valid rows.
    ``mixed_labels`` is decided on the host from the label vector — the
    reference returns 0.0 for single-label classes rather than NaN.
    """
    if not mixed_labels:
        zero = torch.zeros((), dtype=torch.float64, device=pmax.device)
        return zero, zero
    image_preds = masked_conditional_minmax(image_scores, valid)
    combined = pmax if medical else pmax * 0.5 + image_preds * 0.5
    inf = torch.tensor(float("inf"), device=pmax.device)
    scores = torch.where(valid, combined, -inf)
    lab = torch.where(valid, labels.float(), torch.zeros_like(combined))
    return _rank_metrics(scores, lab, n_valid)


def _finalize_row(row):
    """Fetch a deferred device-metric row and apply the reference's
    round(x, 4) * 100 report formatting."""
    if "_device" not in row:
        return row
    vals = row.pop("_device").cpu().numpy()
    for key, v in zip(METRIC_KEYS, vals):
        row[key] = round(float(v), 4) * 100
    return row


def class_metrics_device(preds, class_name: str, domain: str,
                         defer: bool = False, pad_multiple: int = 1,
                         chunk: int = DEFAULT_CHUNK):
    """Per-class metric dict with all metrics computed on the device.

    preds: predict_class(..., device_resident=True) output. Pixel AUROC/AP,
    the per-image normalized maxima and the image-level metrics all run on
    the device; nothing in here waits for it. With ``defer=True`` the row
    carries the four metrics as one un-fetched device tensor under
    "_device" (finalize with :func:`_finalize_row`), so a sweep can queue
    the next class's work before it waits for this one's metrics.

    ``pad_multiple``: pad the class to a multiple of this many maps with
    invalid rows, as the JAX package does (to 16) for its compile cache. An
    eager program needs none, so the default pads nothing; the padded path
    gives the same metrics. ``chunk``: pixels ranked at a time.
    """
    maps, masks = preds["maps"], preds["masks"]
    b, h, w = maps.shape
    bb = _bucket(b, pad_multiple)
    image_label = np.asarray(preds["labels"]).reshape(-1)
    image_scores = torch.as_tensor(preds["image_scores"], device=maps.device).reshape(-1)
    labels_dev = torch.as_tensor(image_label, dtype=torch.float32, device=maps.device)
    if bb != b:
        maps = torch.nn.functional.pad(maps, (0, 0, 0, 0, 0, bb - b))
        masks = torch.nn.functional.pad(masks, (0, 0, 0, 0, 0, bb - b))
        image_scores = torch.nn.functional.pad(image_scores, (0, bb - b))
        labels_dev = torch.nn.functional.pad(labels_dev, (0, bb - b))
    valid = torch.arange(bb, device=maps.device) < b
    pix_auc, pix_ap, pmax = pixel_metrics_device(maps, masks, valid, b * h * w,
                                                 chunk=chunk)
    img_auc, img_ap = _image_metrics_device(
        pmax, image_scores, labels_dev, valid, b,
        medical=domain == "Medical",
        mixed_labels=bool(image_label.max() != image_label.min()))
    row = {
        "class name": class_name,
        "_device": torch.stack([pix_auc, pix_ap, img_auc, img_ap]),
    }
    return row if defer else _finalize_row(row)


def evaluate_dataset(frozen, trainable, model_cfg: ModelConfig,
                     eval_cfg: EvalConfig, datasets: Dict, anchors: Dict,
                     logger=None, use_iqm: bool = True,
                     compute_dtype=torch.float32, device_resident: bool = True,
                     visualize_dir: Optional[str] = None, use_pallas: bool = True):
    """Per-class sweep producing a results table (list of metric dicts plus
    an Average row), parity with test_last.py:273-327.

    The work runs on the device that holds the parameters and anchors. With
    ``device_resident`` (the default) maps and metrics stay there and each
    class's four scalars are fetched one class late; without it the maps
    come to the host and :func:`..ops.metrics.metrics_eval` ranks them.
    ``visualize_dir`` writes each class's heatmaps there
    (:func:`.visualize.dump_heatmaps`), which takes the host path.
    ``use_pallas``: as in :func:`make_predict_fn` (the port's default True,
    JAX's False).
    """
    device_resident = device_resident and not visualize_dir
    domain = DOMAINS[eval_cfg.dataset]
    predict_fn = make_predict_fn(
        model_cfg, eval_cfg.img_size, domain, use_iqm=use_iqm,
        compute_dtype=compute_dtype, text_weight=eval_cfg.text_weight,
        iqm_weight=eval_cfg.iqm_weight,
        image_score_mode=eval_cfg.image_score_mode, use_pallas=use_pallas)
    rows = []

    def _settle(row):
        """Finalize + log a row once the next class's work is queued: the
        metric fetch overlaps that class's host decode, and a failure in
        the middle of a sweep loses at most one class's row."""
        row = _finalize_row(row)
        if logger:
            logger.info("%s: %s", row["class name"], row)
        return row

    for class_name, dataset in datasets.items():
        preds = predict_class(predict_fn, frozen, trainable, dataset,
                              anchors[class_name], eval_cfg.batch_size,
                              device_resident=device_resident,
                              image_score_mode=eval_cfg.image_score_mode)
        if device_resident:
            row = class_metrics_device(preds, class_name, domain, defer=True)
        else:
            if visualize_dir:
                from .visualize import dump_heatmaps

                dump_heatmaps(preds["masks"], preds["maps"], preds["file_names"],
                              visualize_dir, eval_cfg.dataset, class_name)
            row = metrics_eval(
                preds["masks"], preds["labels"], preds["maps"],
                preds["image_scores"], class_name, domain,
                device=anchors[class_name].device)
        rows.append(row)
        if len(rows) >= 2:
            rows[-2] = _settle(rows[-2])
    if rows:
        rows[-1] = _settle(rows[-1])

    avg = {"class name": "Average"}
    for k in METRIC_KEYS:
        avg[k] = float(np.mean([r[k] for r in rows])) if rows else 0.0
    rows.append(avg)
    return rows


# --------------------------------------------------------------------------
# The results table, as pandas prints it
# --------------------------------------------------------------------------

_DECIMAL_NUMBER = re.compile(r"^\s*[\+-]?[0-9]+\.[0-9]*$")


def _format_floats(values, digits: int = 6):
    """A column of floats as pandas' DataFrame.to_string prints it: fixed
    notation with ``digits`` decimals, trailing zeros trimmed equally from
    the whole column (one is kept), "NaN" for NaN, and scientific notation
    when a value would print as 0 or the column is too wide."""
    def render(fmt):
        return ["NaN" if math.isnan(v) else fmt.format(v) for v in values]

    def trim(strs):
        def numbers():
            return [s for s in strs if _DECIMAL_NUMBER.match(s)]

        while numbers() and all(s.endswith("0") for s in numbers()):
            strs = [s[:-1] if _DECIMAL_NUMBER.match(s) else s for s in strs]
        return [s + "0" if _DECIMAL_NUMBER.match(s) and s.endswith(".") else s
                for s in strs]

    out = trim(render("{:.%df}" % digits))
    finite = [abs(v) for v in values if not math.isnan(v)]
    too_long = max(len(s) for s in out) > digits + 6
    large = any(v > 1e6 for v in finite)
    small = any(0 < v < 10 ** -digits for v in finite)
    if small or (too_long and large):
        out = trim(render("{:.%de}" % digits))
    return out


def results_table(rows) -> str:
    """Render rows as the reference's pandas table
    (``DataFrame(rows).to_string(index=False, justify="center")``), without
    pandas: values right-aligned within their column, the column then
    centered under its header, numeric headers with a leading space, one
    space between columns."""
    columns = ("class name",) + METRIC_KEYS
    if not rows:
        return ("Empty DataFrame\nColumns: [" + ", ".join(columns) + "]\nIndex: []")
    cells = []
    for i, name in enumerate(columns):
        if i == 0:
            header, values = name, [str(r[name]) for r in rows]
        else:
            header = " " + name
            values = _format_floats([float(r[name]) for r in rows])
        own = max(len(v) for v in values)
        width = max(own, len(header))
        cells.append([header.center(width)]
                     + [v.rjust(own).center(width) for v in values])
    return "\n".join(" ".join(line) for line in zip(*cells))
