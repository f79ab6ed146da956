"""Inference pipeline: fused anomaly-map prediction + per-class evaluation.

Counterpart of ``aa_clip_iqm_tpu/evaluation/predict.py``: the scoring path
(adapted ViT forward, seg projections, anchor similarity, IQM query maps,
blur/upsample as matmuls, fusion and the image logit) as ``make_predict_fn``,
and the per-class loop around it: ``predict_class``,
``class_metrics_device``, ``evaluate_dataset`` and ``results_table``.
The returned predict function is the eager program; on a CUDA device
``evaluate_dataset`` replays it as one CUDA graph per bucket of the tail
ladder (``train/graphs.py``), where the JAX package jits it, and the ladder
bounds the captures as it bounds JAX's compiles. The metric program stays
eager: each of its shapes runs once per class.

Data parallelism (``mesh=``, a ``parallel.mesh.Mesh``): every rank reads
each batch, predicts its own block of the batch's rows and gathers the
others' maps and logits (``parallel.collectives.gather_rows``), so that each
rank holds the whole class and ranks it as a single process does: the table
is the single-process table. Under a mesh every tail is padded to the full
batch, which the data ranks must divide, as JAX's ``buckets=(batch_size,)``.
A class's maps then take a rank's memory as they take a single process's
(3,714 maps of 518 px in float32, the largest shipped class, are 4 GB).
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
from ..parallel.collectives import broadcast_row, gather_rows
from ..parallel.multihost import process_local_rows
from ..ops.metrics import (
    DEFAULT_CHUNK,
    _rank_metrics,
    masked_conditional_minmax,
    metrics_eval,
    pixel_metrics_device,
)
from ..train import graphs as graphs_mod
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
                    image_score_mode: str = "fixed", use_pallas: bool = True,
                    mesh=None):
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
    mesh: data parallelism. ``images`` and ``anchors`` are the global batch,
    which the mesh's data ranks must divide; each rank runs its rows
    (``process_local_rows``) and the outputs are the global batch's,
    gathered. "reference_eval" scores every row from global row 1, whose
    det token the rank that holds it sends to the others. With a
    tensor-parallel ``frozen`` (``parallel.mesh.shard_backbone``) the blocks
    sum over the mesh's 'model' ranks.
    """
    if image_score_mode not in ("fixed", "reference_eval"):
        raise ValueError(f"unknown image_score_mode {image_score_mode!r}")

    def predict(frozen, trainable, images, anchors):
        with torch.inference_mode():
            total = images.shape[0]
            if mesh is not None:
                if total % mesh.data_size:
                    raise ValueError(f"batch {total} does not split over the "
                                     f"{mesh.data_size} data-parallel ranks")
                lo, hi = process_local_rows(mesh, total)
                images, anchors = images[lo:hi], anchors[lo:hi]
            if images.dtype == torch.uint8:
                images = _device_normalize(images)
            out = adapters_mod.encode_image_adapted(
                frozen, trainable, cfg, images,
                text_anchors=anchors if use_iqm else None,
                compute_dtype=compute_dtype, use_pallas=use_pallas)
            if image_score_mode == "fixed":
                img_logit = scoring.image_logit(out.det_token, anchors)
            elif mesh is None:
                img_logit = scoring.image_logit_reference_eval(out.det_token, anchors)
            else:
                scoring.check_reference_eval_batch(total)
                per = hi - lo
                mine = out.det_token[1 - lo] if lo <= 1 < hi else None
                det1 = broadcast_row(mine, out.det_token[0], 1, per, mesh)
                img_logit = scoring.image_logit_from_row(det1, anchors)
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
            final, img_logit = final.float(), img_logit.float()
            if mesh is not None:
                final, img_logit = gather_rows(final, mesh), gather_rows(img_logit, mesh)
            return final, img_logit

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
                     visualize_dir: Optional[str] = None, use_pallas: bool = True,
                     graphs=None, mesh=None):
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

    On a CUDA device (without NaN checks) the predict calls replay CUDA
    graphs, one per bucket, captured at its first batch; each batch's maps
    and logits are copied out before the next replay. ``graphs``: a
    ``train.graphs.GraphCache`` to capture into and replay from, so that a
    caller that sweeps again (a benchmark) replays what an earlier call
    captured on the same weights; None makes one for this call.

    ``mesh``: data parallelism (module docstring). Every rank returns the
    table; pass ``logger`` on rank 0 only, and write ``visualize_dir`` from
    one rank.
    """
    device_resident = device_resident and not visualize_dir
    domain = DOMAINS[eval_cfg.dataset]
    if mesh is not None and eval_cfg.batch_size % mesh.data_size:
        raise ValueError(f"batch size {eval_cfg.batch_size} does not split over the "
                         f"{mesh.data_size} data-parallel ranks")
    predict_fn = make_predict_fn(
        model_cfg, eval_cfg.img_size, domain, use_iqm=use_iqm,
        compute_dtype=compute_dtype, text_weight=eval_cfg.text_weight,
        iqm_weight=eval_cfg.iqm_weight,
        image_score_mode=eval_cfg.image_score_mode, use_pallas=use_pallas, mesh=mesh)
    if anchors and graphs_mod.enabled(next(iter(anchors.values())).device, mesh):
        cache = graphs if graphs is not None else graphs_mod.GraphCache()
        eager_fn = predict_fn
        predict_fn = cache.program(
            ("predict", model_cfg, eval_cfg.img_size, domain, use_iqm, compute_dtype,
             eval_cfg.text_weight, eval_cfg.iqm_weight, eval_cfg.image_score_mode,
             use_pallas, None if mesh is None else id(mesh)),
            lambda: graphs_mod.GraphedFn(eager_fn, cache, "predict"))
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
                              image_score_mode=eval_cfg.image_score_mode,
                              buckets=None if mesh is None else (eval_cfg.batch_size,))
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
