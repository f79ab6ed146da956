"""JSONL datasets: loading, CLIP preprocessing, joint geometric augmentation.

Counterpart of ``aa_clip_iqm_tpu/data/datasets.py``: metadata JSONL rows
{image_path, label, class_name, mask_path}; the training dataset with its
augmentations (per-channel colour jitter at the original resolution, image
stage only; then CLIP bicubic resize and normalisation; the mask nearest-
resized and binarized; then one joint rotation / translation / flip of the
stacked image and mask channels, nearest neighbour so the mask stays
binary); the class-filtered test dataset without augmentation; batch
collation and a background prefetcher. Images are decoded with PIL, imported
only inside the functions that decode a file, so that importing this module
needs numpy alone. The random draws are numpy ``default_rng`` streams seeded
as in the JAX package, so a training batch equals that package's for the
same (seed, epoch). Samples decode on a thread pool of
``AACLIP_DATA_WORKERS`` threads (default 1, serial), with the JAX package's
random-stream contract. ``get_dataset`` has the JAX package's signature.
The image resize, the mask resize and the augmentation warp go through the
C++ transform pipeline (``data/native.py``) unless ``AACLIP_NATIVE=0``, as in
the JAX package; where it cannot be built they take the PIL / numpy path
(PIL's resizes, a numpy transcription of the nearest-neighbour warp).
"""
from __future__ import annotations

import json
import os
import threading
from typing import List, Optional

import numpy as np

from . import native as native_pipeline
from .registry import CLASS_NAMES, DATA_PATH, IMAGE_MEAN, IMAGE_STD, metadata_path

_MEAN = np.asarray(IMAGE_MEAN, np.float32).reshape(3, 1, 1)
_STD = np.asarray(IMAGE_STD, np.float32).reshape(3, 1, 1)


def _use_native() -> bool:
    """The C++ pipeline is the default transform backend; ``AACLIP_NATIVE=0``
    forces the PIL / numpy path, which is also taken where the library
    cannot be built."""
    return (os.environ.get("AACLIP_NATIVE", "1") != "0"
            and native_pipeline.available())


def _data_workers() -> int:
    """Per-sample decode parallelism, ``AACLIP_DATA_WORKERS`` (default 1, the
    serial path). Threads, not processes: PIL's decode and the native
    transforms release the interpreter lock, so threads scale on a
    multi-core host with no serialisation cost."""
    try:
        n = int(os.environ.get("AACLIP_DATA_WORKERS", "1"))
    except ValueError:
        return 1
    return max(1, n)


_EXECUTOR = None
_EXECUTOR_WORKERS = 0
_EXECUTOR_LOCK = threading.Lock()


def _executor(workers: int):
    """The process-wide decode pool, made on first use and remade when the
    worker count changes."""
    global _EXECUTOR, _EXECUTOR_WORKERS
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None or _EXECUTOR_WORKERS != workers:
            if _EXECUTOR is not None:
                _EXECUTOR.shutdown(wait=False)
            from concurrent.futures import ThreadPoolExecutor

            _EXECUTOR = ThreadPoolExecutor(max_workers=workers,
                                           thread_name_prefix="aaclip-data")
            _EXECUTOR_WORKERS = workers
        return _EXECUTOR


def _map(fn, jobs):
    """``[fn(job) for job in jobs]``, on the decode pool when
    ``AACLIP_DATA_WORKERS`` > 1, in order either way."""
    workers = _data_workers()
    if workers > 1:
        return list(_executor(workers).map(fn, jobs))
    return [fn(job) for job in jobs]


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
    """RGB bicubic resize -> CHW float32 in [0, 1] (:func:`_resize_bicubic_u8`)."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return _resize_bicubic_u8(img, img_size)


def _load_mask(path: str, img_size: int) -> np.ndarray:
    """Grayscale nearest resize -> (1, H, W) binary float32."""
    from PIL import Image

    m = Image.open(path).convert("L")
    if _use_native():
        return native_pipeline.resize_nearest_mask(np.asarray(m), img_size)[None]
    arr = (np.asarray(m.resize((img_size, img_size), Image.NEAREST)) != 0
           ).astype(np.float32)
    return arr[None]


def normalize_clip(img01: np.ndarray) -> np.ndarray:
    return (img01 - _MEAN) / _STD


def _load_image_u8(path: str, img_size: int) -> np.ndarray:
    """RGB bicubic resize -> CHW uint8 (both resizes round to uint8, so
    this is lossless). The transfer format for device-side normalization:
    a quarter of the host-to-device bytes of normalized float32."""
    img01 = _load_image(path, img_size)  # CHW float32, values k/255 exactly
    return np.rint(img01 * 255.0).astype(np.uint8)


def _pil_gray(img_u8: np.ndarray) -> np.ndarray:
    """PIL Image.convert('L') exact: rounded 16.16 fixed-point ITU-R 601-2
    luma, (19595 R + 38470 G + 7471 B + 0x8000) >> 16. (H, W, 3) uint8 ->
    (H, W) uint8."""
    r = img_u8[..., 0].astype(np.uint32)
    g = img_u8[..., 1].astype(np.uint32)
    b = img_u8[..., 2].astype(np.uint32)
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


def _pil_blend(degenerate: np.ndarray, img_u8: np.ndarray, f) -> np.ndarray:
    """PIL Image.blend exact: in1 + alpha*(in2-in1) in float32, clamped to
    [0, 255], truncated back to uint8."""
    d = degenerate.astype(np.float32)
    out = d + np.float32(f) * (img_u8.astype(np.float32) - d)
    return np.clip(out, 0.0, 255.0).astype(np.uint8)


def _color_jitter(rng: np.random.Generator, img_u8: np.ndarray,
                  factors=None) -> np.ndarray:
    """Brightness/contrast/saturation jitter (strength 0.5, each applied with
    p=0.7) on (H, W, 3) uint8, byte-identical to the PIL ImageEnhance chain:
    brightness blends from black, contrast from the rounded mean of the L
    image, colour from the L image. Runs at the original resolution, before
    the bicubic resize. ``factors`` overrides the three draws."""
    img = img_u8
    fb, fc, fs = factors if factors is not None else (None, None, None)
    if factors is not None or rng.random() < 0.7:
        f = fb if fb is not None else rng.uniform(0.5, 1.5)
        img = _pil_blend(np.zeros_like(img), img, f)
    if factors is not None or rng.random() < 0.7:
        f = fc if fc is not None else rng.uniform(0.5, 1.5)
        mean = int(float(_pil_gray(img).mean()) + 0.5)
        img = _pil_blend(np.full_like(img, mean), img, f)
    if factors is not None or rng.random() < 0.7:
        f = fs if fs is not None else rng.uniform(0.5, 1.5)
        img = _pil_blend(_pil_gray(img)[..., None], img, f)
    return img


def _resize_bicubic_u8(u8_hwc: np.ndarray, img_size: int) -> np.ndarray:
    """(H, W, 3) uint8 -> [0, 1] CHW float32 through the native bicubic
    resize, or PIL's (no resize when the size is already right). The two
    agree within one level."""
    if u8_hwc.shape[:2] == (img_size, img_size):
        return u8_hwc.astype(np.float32).transpose(2, 0, 1) / 255.0
    if _use_native():
        return native_pipeline.resize_bicubic_rgb(u8_hwc, img_size)
    from PIL import Image

    arr = np.asarray(Image.fromarray(u8_hwc).resize((img_size, img_size),
                                                    Image.BICUBIC),
                     np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def _warp_nearest(chw: np.ndarray, M: np.ndarray) -> np.ndarray:
    """cv2.warpAffine semantics with nearest-neighbour sampling and zeros
    outside: dst(x, y) = src(round(Minv (x, y, 1))). M is the 2x3 forward
    matrix, float64."""
    _, h, w = chw.shape
    (a, b, tx), (d, e, ty) = np.asarray(M, np.float64)
    det = a * e - b * d
    ia, ib, id_, ie = e / det, -b / det, -d / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(id_ * tx + ie * ty)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    xx = np.floor(ia * xs + ib * ys + itx + 0.5).astype(np.int64)
    yy = np.floor(id_ * xs + ie * ys + ity + 0.5).astype(np.int64)
    inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    out = chw[:, np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
    return np.where(inside[None], out, np.zeros((), chw.dtype))


def _joint_geometric(rng: np.random.Generator, stacked: np.ndarray) -> np.ndarray:
    """Rotation +-30 deg (p=0.5), translation +-0.15 (p=0.5) and H/V flips
    (p=0.5 each), applied identically to all channels of ``stacked``
    (C, H, W): the image channels and the mask channel. Nearest-neighbour
    warps keep the mask exactly binary: the native warp, or its numpy
    transcription."""
    _, h, w = stacked.shape
    warp = (native_pipeline.warp_affine_chw if _use_native() else _warp_nearest)

    def rotation_matrix(angle_deg):
        # cv2.getRotationMatrix2D about the pixel-centre of the image.
        a = np.deg2rad(angle_deg)
        cx, cy = w / 2 - 0.5, h / 2 - 0.5
        cos, sin = np.cos(a), np.sin(a)
        return np.array([[cos, sin, (1 - cos) * cx - sin * cy],
                         [-sin, cos, sin * cx + (1 - cos) * cy]], np.float64)

    img = stacked
    if rng.random() < 0.5:
        img = warp(img, rotation_matrix(rng.uniform(-30.0, 30.0)))
    if rng.random() < 0.5:
        tx = rng.uniform(-0.15, 0.15) * w
        ty = rng.uniform(-0.15, 0.15) * h
        img = warp(img, np.array([[1, 0, tx], [0, 1, ty]], np.float64))
    if rng.random() < 0.5:
        img = img[:, :, ::-1]
    if rng.random() < 0.5:
        img = img[:, ::-1, :]
    return np.ascontiguousarray(img)


class TrainDataset:
    """Reference BaseDataset (dataset/__init__.py:13-121). ``text=True``
    (stage 1) skips the colour jitter; the geometric augmentation is joint on
    image and mask in both stages."""

    def __init__(self, data_path: str, meta_path: str, img_size: int,
                 text: bool = False, seed: int = 111):
        self.data_path = data_path
        self.img_size = img_size
        self.text = text
        self.meta = load_metadata(meta_path)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._draws = 0  # per-sample stream counter of the pooled batches()

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx: int) -> dict:
        """One augmented sample, drawn from the dataset's sequential stream."""
        return self._get(idx, self.rng)

    def _get(self, idx: int, rng: np.random.Generator) -> dict:
        from PIL import Image

        meta = self.meta[idx]
        path = os.path.join(self.data_path, meta["image_path"])
        raw = np.asarray(Image.open(path).convert("RGB"), np.uint8)
        if not self.text:
            # Jitter before the resize, at the original resolution.
            raw = _color_jitter(rng, raw)
        img = normalize_clip(_resize_bicubic_u8(raw, self.img_size))
        if meta["label"]:
            mask = _load_mask(os.path.join(self.data_path, meta["mask_path"]),
                              self.img_size)
        else:
            mask = np.zeros((1, self.img_size, self.img_size), np.float32)
        stacked = _joint_geometric(rng, np.concatenate([img, mask], axis=0))
        return {
            "image": stacked[:3],
            "mask": stacked[3:4],
            "label": np.int64(meta["label"]),
            "file_name": meta["image_path"],
            "class_name": meta["class_name"],
        }

    def epoch_batches(self, epoch: int, batch_size: int,
                      start_batch: int = 0, drop_last: bool = False):
        """Deterministic per-epoch batch stream for resumable training: the
        shuffle order derives from (seed, epoch) and every sample's
        augmentation stream from (seed, epoch, position in the epoch), so
        the stream is a pure function of (dataset seed, epoch). A run
        resumed mid-epoch skips ``start_batch`` batches, without decoding
        them, and continues with bit-identical data. The samples decode on
        the ``AACLIP_DATA_WORKERS`` pool, and the stream is the same for any
        number of workers."""
        order = np.arange(len(self.meta))
        np.random.default_rng((self.seed, epoch)).shuffle(order)
        for b, start in enumerate(range(0, len(order), batch_size)):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            if b < start_batch:
                continue
            jobs = [(int(i), np.random.default_rng((self.seed, epoch, start + j)))
                    for j, i in enumerate(idxs)]
            yield collate(_map(lambda job: self._get(*job), jobs))

    def batches(self, batch_size: int, shuffle: bool = True, drop_last: bool = False):
        """Batches in a shuffled (or metadata) order drawn from the dataset's
        own generator. With ``AACLIP_DATA_WORKERS`` = 1 every sample draws
        from that one sequential stream, as ``self[i]`` does. With more
        workers the samples decode on the pool, each from a stream of its
        own seeded by (seed, draw counter): deterministic whatever the
        threads' interleaving, but another stream than the serial one (the
        trade a PyTorch DataLoader's workers make)."""
        order = np.arange(len(self.meta))
        if shuffle:
            self.rng.shuffle(order)
        workers = _data_workers()
        for start in range(0, len(order), batch_size):
            idxs = order[start:start + batch_size]
            if drop_last and len(idxs) < batch_size:
                break
            if workers > 1:
                jobs = [(int(i), np.random.default_rng((self.seed, self._draws + j)))
                        for j, i in enumerate(idxs)]
                self._draws += len(idxs)
                items = _map(lambda job: self._get(*job), jobs)
            else:
                items = [self[int(i)] for i in idxs]
            yield collate(items)


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

    def batches(self, batch_size: int, pad_to_batch: bool = False):
        """Sequential batches; each carries its count as ``n_valid``. With
        ``pad_to_batch`` the tail batch is zero-padded to ``batch_size``
        (images, masks and labels). The decode draws nothing at random, so
        on the ``AACLIP_DATA_WORKERS`` pool it gives the serial output, in
        order."""
        for start in range(0, len(self), batch_size):
            items = _map(self.__getitem__,
                         range(start, min(start + batch_size, len(self))))
            batch = collate(items)
            n = len(items)
            if pad_to_batch and n < batch_size:
                for key in ("image", "mask", "label"):
                    pad = np.zeros((batch_size - n,) + batch[key].shape[1:],
                                   batch[key].dtype)
                    batch[key] = np.concatenate([batch[key], pad], axis=0)
            batch["n_valid"] = n
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


def get_dataset(dataset_name: str, img_size: int, training_mode: Optional[str],
                shot: int = -1, stage: str = "train", logger=None,
                metadata_root: Optional[str] = None, seed: int = 111,
                device_normalize: bool = False):
    """The JAX package's dispatcher, with its signature, argument order and
    defaults (reference dataset/__init__.py:211-270).

    ``stage="train"``: (text_dataset, image_dataset), the stage-1 and stage-2
    :class:`TrainDataset` over the ``shot``-shot metadata
    (``training_mode="few_shot"``) or the full one. ``stage="test"``:
    {class: SingleClassTestDataset} for the test split, in the dataset's
    class order; classes without samples (a partial download) are skipped.
    ``stage="visualize"``: the same split without the logger's per-class
    lines. ``device_normalize`` (test and visualize): uint8 images for the
    device-side CLIP normalisation."""
    if dataset_name not in DATA_PATH:
        raise KeyError(
            f"Dataset {dataset_name!r} not found; available: "
            f"{sorted(DATA_PATH)}")
    if stage == "train":
        if training_mode == "few_shot" and shot <= 0:
            raise ValueError("shot should be positive in few_shot mode")
        meta = metadata_path(dataset_name,
                             shot if training_mode == "few_shot" else -1,
                             metadata_root)
        data_path = DATA_PATH[dataset_name.split("-")[0]]
        return (TrainDataset(data_path, meta, img_size, text=True, seed=seed),
                TrainDataset(data_path, meta, img_size, text=False, seed=seed + 1))
    if stage not in ("test", "visualize"):
        raise ValueError(f"stage {stage} not found; available: train, test, visualize")
    meta = metadata_path(dataset_name, -1, metadata_root)
    datasets = {}
    for c in CLASS_NAMES[dataset_name]:
        ds = SingleClassTestDataset(
            DATA_PATH[dataset_name], meta, img_size, c,
            logger=logger if stage == "test" else None,
            device_normalize=device_normalize)
        if len(ds) == 0:
            if logger:
                logger.warning("class %s has no samples; skipping", c)
            continue
        datasets[c] = ds
    return datasets
