"""Synthetic micro-dataset generator for tests and smoke runs.

Counterpart of ``aa_clip_iqm_tpu/data/synthetic.py``: writes a tiny
anomaly-detection dataset to disk in the reference layout (images + masks +
full-shot.jsonl metadata): textured "normal" images and "anomalous" images
with painted defects plus ground-truth masks, from a numpy seed. PIL is
imported only inside :func:`generate`.
"""
from __future__ import annotations

import json
import os

import numpy as np


def _texture(rng, size, base_color):
    """Smooth random texture: low-frequency noise upsampled."""
    from PIL import Image

    low = rng.standard_normal((8, 8, 3)) * 0.15
    img = np.asarray(Image.fromarray(
        np.uint8((low - low.min()) / (np.ptp(low) + 1e-6) * 80)
    ).resize((size, size), Image.BICUBIC), np.float32)
    img = img + np.asarray(base_color, np.float32)
    return np.clip(img, 0, 255)


def paint_defect(rng, img, size):
    """Paint 1-3 bright elliptical blobs on an (H, W, 3) float image;
    returns (img, uint8 mask of 0 / 255)."""
    mask = np.zeros((size, size), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    for _ in range(int(rng.integers(1, 4))):
        cy, cx = rng.integers(size // 6, size - size // 6, 2)
        ry, rx = rng.integers(size // 16, size // 6, 2)
        blob = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        color = rng.uniform(120, 255, 3)
        img[blob] = 0.3 * img[blob] + 0.7 * color
        mask |= blob.astype(np.uint8)
    return img, mask * 255


def generate(root: str, n_normal: int = 8, n_anomalous: int = 8,
             size: int = 64, class_names=("widget",), seed: int = 0,
             dataset_name: str = "Synth"):
    """Write the dataset under root/<dataset_name> and metadata under
    root/metadata/<dataset_name>/full-shot.jsonl. Returns (data_path, meta_path).
    """
    from PIL import Image

    rng = np.random.default_rng(seed)
    data_path = os.path.join(root, dataset_name)
    meta_dir = os.path.join(root, "metadata", dataset_name)
    os.makedirs(meta_dir, exist_ok=True)
    rows = []
    for class_name in class_names:
        base = rng.uniform(40, 140, 3)
        for kind, count in (("good", n_normal), ("defect", n_anomalous)):
            img_dir = os.path.join(data_path, class_name, "test", kind)
            os.makedirs(img_dir, exist_ok=True)
            mask_dir = os.path.join(data_path, class_name, "ground_truth", kind)
            if kind == "defect":
                os.makedirs(mask_dir, exist_ok=True)
            for i in range(count):
                img = _texture(rng, size, base)
                row = {
                    "image_path": f"{class_name}/test/{kind}/{i:03d}.png",
                    "label": 0,
                    "class_name": class_name,
                }
                if kind == "defect":
                    img, mask = paint_defect(rng, img, size)
                    mask_rel = f"{class_name}/ground_truth/{kind}/{i:03d}_mask.png"
                    Image.fromarray(mask).save(os.path.join(data_path, mask_rel))
                    row["label"] = 1
                    row["mask_path"] = mask_rel
                Image.fromarray(np.uint8(img)).save(
                    os.path.join(data_path, row["image_path"]))
                rows.append(row)
    meta_path = os.path.join(meta_dir, "full-shot.jsonl")
    with open(meta_path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return data_path, meta_path


def register_synthetic(root: str, class_names=("widget",),
                       dataset_name: str = "Synth", domain: str = "Industrial"):
    """Register the synthetic dataset in the in-process registry so that
    get_dataset and the prompt engine work on it. Returns the metadata root."""
    from . import registry

    registry.DATASETS[dataset_name] = {
        "path": dataset_name,
        "domain": domain,
        "classes": {c: c.replace("_", " ") for c in class_names},
    }
    registry.DATA_PATH[dataset_name] = os.path.join(root, dataset_name)
    registry.DOMAINS[dataset_name] = domain
    registry.CLASS_NAMES[dataset_name] = list(class_names)
    registry.REAL_NAMES[dataset_name] = {
        c: c.replace("_", " ") for c in class_names
    }
    return os.path.join(root, "metadata")
