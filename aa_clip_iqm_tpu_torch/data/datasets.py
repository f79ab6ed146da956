"""JSONL test datasets: loading and CLIP preprocessing.

Counterpart of the evaluation half of ``aa_clip_iqm_tpu/data/datasets.py``:
metadata JSONL rows {image_path, label, class_name, mask_path}, the
class-filtered test dataset without augmentation, batch collation and a
background prefetcher. Images are decoded with PIL (bicubic resize for
images, nearest for masks), imported only inside the functions that decode a
file, so that importing this module needs numpy alone. The training dataset,
its augmentations and the native C++ transform pipeline are not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from .registry import CLASS_NAMES, DATA_PATH, IMAGE_MEAN, IMAGE_STD, metadata_path

_MEAN = np.asarray(IMAGE_MEAN, np.float32).reshape(3, 1, 1)
_STD = np.asarray(IMAGE_STD, np.float32).reshape(3, 1, 1)


def load_metadata(meta_path: str, class_name: Optional[str] = None) -> List[dict]:
    rows = []
    with open(meta_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if class_name is None or row["class_name"] == class_name:
                rows.append(row)
    return rows


def _load_image(path: str, img_size: int) -> np.ndarray:
    """RGB bicubic resize -> CHW float32 in [0, 1]."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (img_size, img_size):
        img = img.resize((img_size, img_size), Image.BICUBIC)
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def _load_mask(path: str, img_size: int) -> np.ndarray:
    """Grayscale nearest resize -> (1, H, W) binary float32."""
    from PIL import Image

    m = Image.open(path).convert("L")
    arr = (np.asarray(m.resize((img_size, img_size), Image.NEAREST)) != 0
           ).astype(np.float32)
    return arr[None]


def normalize_clip(img01: np.ndarray) -> np.ndarray:
    return (img01 - _MEAN) / _STD


def _load_image_u8(path: str, img_size: int) -> np.ndarray:
    """RGB bicubic resize -> CHW uint8 (PIL's resize output is uint8, so
    this is lossless). The transfer format for device-side normalization:
    a quarter of the host-to-device bytes of normalized float32."""
    img01 = _load_image(path, img_size)  # CHW float32, values k/255 exactly
    return np.rint(img01 * 255.0).astype(np.uint8)


class SingleClassTestDataset:
    """Reference BaseSingleClassDataset (dataset/__init__.py:124-208): one
    class's test images in metadata order, no augmentation."""

    def __init__(self, data_path: str, meta_path: str, img_size: int,
                 class_name: str, logger=None, device_normalize: bool = False):
        # device_normalize: emit CHW uint8 images for device-side CLIP
        # normalization (evaluation.predict.make_predict_fn normalizes uint8
        # inputs on the device with bit-identical fp32 math) instead of
        # host-normalized float32.
        self.data_path = data_path
        self.img_size = img_size
        self.class_name = class_name
        self.device_normalize = device_normalize
        self.meta = load_metadata(meta_path, class_name=class_name)
        if logger:
            logger.info(f"Class name: {class_name}")
            logger.info(f"Sample number: {len(self.meta)}")
            logger.info("=====================================")

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx: int) -> dict:
        meta = self.meta[idx]
        path = os.path.join(self.data_path, meta["image_path"])
        if self.device_normalize:
            img = _load_image_u8(path, self.img_size)
        else:
            img = normalize_clip(_load_image(path, self.img_size))
        if meta["label"]:
            mask = _load_mask(os.path.join(self.data_path, meta["mask_path"]),
                              self.img_size)
        else:
            mask = np.zeros((1, self.img_size, self.img_size), np.float32)
        return {
            "image": img,
            "mask": mask,
            "label": np.int64(meta["label"]),
            "file_name": meta["image_path"],
            "class_name": meta["class_name"],
        }

    def batches(self, batch_size: int):
        """Sequential batches; each carries its count as ``n_valid``."""
        for start in range(0, len(self), batch_size):
            items = [self[i] for i in range(start, min(start + batch_size, len(self)))]
            batch = collate(items)
            batch["n_valid"] = len(items)
            yield batch


def prefetch(iterator, depth: int = 2):
    """Background-thread prefetcher: overlaps host-side decode with device
    compute (one thread suffices, since kernel launches do not wait).

    Shuts the worker down cleanly if the consumer abandons the generator:
    the worker's blocking put is bounded by a stop flag, so no thread or
    decoded-batch memory leaks.
    """
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err = []

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def worker():
        try:
            for item in iterator:
                put(item)
                if stop.is_set():
                    return
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            put(sentinel)  # must land, or the consumer hangs

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def collate(items: List[dict]) -> dict:
    """Stack sample dicts into a batch. Images keep uint8 (the
    device_normalize transfer format — a float32 cast here would both
    quadruple the host-to-device bytes and make the predict program skip its
    on-device CLIP normalization, running the backbone on raw 0..255
    pixels); float images are host-normalized already and stay float32."""
    img = np.stack([it["image"] for it in items])
    if img.dtype != np.uint8:
        img = img.astype(np.float32)
    return {
        "image": img,
        "mask": np.stack([it["mask"] for it in items]).astype(np.float32),
        "label": np.asarray([it["label"] for it in items], np.int64),
        "file_name": [it["file_name"] for it in items],
        "class_name": [it["class_name"] for it in items],
    }


def get_dataset(dataset_name: str, img_size: int, stage: str = "test",
                logger=None, metadata_root: Optional[str] = None,
                device_normalize: bool = False):
    """{class: SingleClassTestDataset} for the test split, in the dataset's
    class order. Classes without samples (a partial download) are skipped.
    The training split is not ported yet."""
    if dataset_name not in DATA_PATH:
        raise KeyError(
            f"Dataset {dataset_name!r} not found; available: "
            f"{sorted(DATA_PATH)}")
    if stage != "test":
        raise ValueError(f"stage {stage!r} not ported; available: test")
    meta = metadata_path(dataset_name, -1, metadata_root)
    datasets = {}
    for c in CLASS_NAMES[dataset_name]:
        ds = SingleClassTestDataset(
            DATA_PATH[dataset_name], meta, img_size, c, logger=logger,
            device_normalize=device_normalize)
        if len(ds) == 0:
            if logger:
                logger.warning("class %s has no samples; skipping", c)
            continue
        datasets[c] = ds
    return datasets
