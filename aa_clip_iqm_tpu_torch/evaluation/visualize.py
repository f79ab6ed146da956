"""Heatmap visualization: JET-colormap overlays of the ground-truth mask and
the predicted map.

Counterpart of ``aa_clip_iqm_tpu/evaluation/visualize.py`` (the reference's
apply_ad_scoremap / visualize). Output file names come from the sample's
relative path, ``{parent}_{name}``, for any dataset layout. ``cv2`` is
imported inside the functions, so importing this module needs numpy alone.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.registry import DATA_PATH


def apply_ad_scoremap(image: np.ndarray, scoremap: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    import cv2

    colored = cv2.applyColorMap(scoremap, cv2.COLORMAP_JET)
    return (alpha * image + (1 - alpha) * colored).astype(np.uint8)


def render_overlay(image_bgr: np.ndarray, amap: np.ndarray,
                   alpha: float = 0.5) -> np.ndarray:
    """Min-max-normalize one float anomaly map and JET-blend it onto a BGR
    uint8 image (the serving and single-image CLIs; :func:`dump_heatmaps`
    normalizes a whole class jointly instead)."""
    norm = (amap - amap.min()) / (amap.max() - amap.min() + 1e-8)
    heat = (norm * 255).astype(np.uint8)
    return apply_ad_scoremap(np.ascontiguousarray(image_bgr), heat, alpha)


def _flat_name(rel_path: str) -> str:
    parts = rel_path.replace("\\", "/").split("/")
    return "_".join(parts[-2:]) if len(parts) >= 2 else parts[-1]


def dump_heatmaps(pixel_label: np.ndarray, pixel_preds: np.ndarray,
                  file_names, save_dir: str, dataset_name: str,
                  class_name: str, data_root: str = None):
    """Write one PNG per test image under
    ``save_dir/visualization/<dataset>/<class>/``: the image, the
    ground-truth overlay and the prediction overlay, stacked vertically."""
    import cv2

    preds = pixel_preds.astype(np.float32)
    if preds.max() != 1:
        span = preds.max() - preds.min()
        preds = (preds - preds.min()) / span if span else np.zeros_like(preds)
    preds_u8 = (preds * 255).astype(np.uint8)
    labels_u8 = ((pixel_label != 0) * 255).astype(np.uint8)
    if labels_u8.ndim == 4:
        labels_u8 = labels_u8[:, 0]

    out_dir = os.path.join(save_dir, "visualization", dataset_name, class_name)
    os.makedirs(out_dir, exist_ok=True)
    root = data_root or DATA_PATH.get(dataset_name, ".")
    size = preds_u8.shape[-1]
    for idx, rel in enumerate(file_names):
        image = cv2.imread(os.path.join(root, rel))
        if image is None:
            image = np.zeros((size, size, 3), np.uint8)
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
        image = cv2.resize(image, (size, size))
        gt = cv2.cvtColor(labels_u8[idx], cv2.COLOR_GRAY2RGB)[..., 0]
        panels = [image, apply_ad_scoremap(image, gt),
                  apply_ad_scoremap(image, preds_u8[idx])]
        cv2.imwrite(os.path.join(out_dir, _flat_name(rel)), np.vstack(panels))
