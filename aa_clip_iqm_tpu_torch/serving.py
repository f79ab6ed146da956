"""Serving API: one object from checkpoint to anomaly maps.

Counterpart of ``aa_clip_iqm_tpu/serving.py``'s ``AnomalyDetector`` and
``MicroBatchingService``:

    det = AnomalyDetector.from_checkpoint("ckpt/baseline", "MVTec",
                                          backbone="ViT-L-14-336px.pt")
    maps, scores = det.predict(images, class_name="bottle")    # numpy in/out
    maps, scores = det.predict_paths(["a.png", "b.png"], "bottle")

    svc = MicroBatchingService(det, max_batch=32, max_latency_ms=5)
    amap, score = svc.submit(image, "bottle").result(timeout=60)

Everything runs on ``cuda`` unless ``device="cpu"`` is passed. Anchors are
computed once per dataset and kept on the device. Caller batches are padded
up to the smallest fitting bucket and larger ones split into largest-bucket
chunks, as in the JAX package. ``quantize=`` selects an int8 backbone tier
(``ops/quant.py``). Not ported yet: ``export_predictor`` /
``ExportedPredictor`` (a ``torch.export`` path) and CUDA graphs for the
bucketed predict program.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import ModelConfig
from .data.datasets import _load_image_u8
from .data.registry import DOMAINS
from .evaluation.predict import make_predict_fn
from .loader import build_model_config, init_trainable, load_frozen_backbone
from .prompts import compute_frozen_anchors
from .train.checkpoint import restore_adapters

#: Default batch buckets (as the JAX package's compile-once ladder).
DEFAULT_BATCH_BUCKETS = (1, 8, 16, 32)


def _bucketed(images, buckets, split, run):
    """Bucket fit/pad/split shared by the predict entry points: empty batches
    give empty results; batches larger than the biggest bucket are split
    through ``split(start, stop)``; the rest are zero-padded to the smallest
    fitting bucket and run once through ``run(padded, bucket, n)``."""
    n = images.shape[0]
    if n == 0:
        return (np.zeros((0,) + tuple(images.shape[-2:]), np.float32),
                np.zeros((0,), np.float32))
    fitting = [b for b in buckets if b >= n]
    if not fitting:
        bucket = buckets[-1]
        maps, scores = zip(*(split(i, min(i + bucket, n))
                             for i in range(0, n, bucket)))
        return np.concatenate(maps), np.concatenate(scores)
    bucket = fitting[0]
    if bucket != n:
        images = np.concatenate(
            [images, np.zeros((bucket - n,) + tuple(images.shape[1:]),
                              images.dtype)], axis=0)
    return run(images, bucket, n)


class AnomalyDetector:
    """Batched anomaly-map inference for one dataset's class vocabulary.

    ``frozen`` and ``trainable`` are the port's parameter dicts, already on
    ``device`` (``"cuda"`` by default; pass ``"cpu"`` explicitly to run the
    plain twins on the CPU)."""

    def __init__(self, frozen, trainable, model_cfg: ModelConfig,
                 dataset: str, img_size: int = 518, adapted_text: bool = True,
                 compute_dtype=torch.bfloat16, text_weight: float = 0.6,
                 iqm_weight: float = 0.4,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 quantize: Optional[str] = None, device="cuda"):
        self.device = torch.device(device)
        if quantize is not None:
            # Serve-time int8 backbone tier: "int8" (all block matmuls),
            # "int8_attn" (qkv/out only, the MLP keeps the fused float
            # kernel) or "int8_mlp" (the MLP only, through the fused int8
            # kernel). The anchors below come from the full-precision text
            # tower either way. A "+smooth" suffix adds SmoothQuant outlier
            # migration, calibrated here on a seeded random batch through
            # the adapted tower.
            from .ops.quant import quantize_backbone_auto

            frozen = quantize_backbone_auto(frozen, quantize, cfg=model_cfg,
                                            trainable=trainable)
        self.frozen = frozen
        self.trainable = trainable
        self.cfg = model_cfg
        self.dataset = dataset
        self.img_size = img_size
        self.domain = DOMAINS.get(dataset, "Industrial")
        if not batch_buckets or any(b <= 0 for b in batch_buckets):
            raise ValueError(
                f"batch_buckets must be non-empty positive ints, "
                f"got {batch_buckets!r}")
        self._buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self._predict = make_predict_fn(
            model_cfg, img_size, self.domain, compute_dtype=compute_dtype,
            text_weight=text_weight, iqm_weight=iqm_weight)
        self.anchors: Dict[str, torch.Tensor] = compute_frozen_anchors(
            frozen, trainable, model_cfg, dataset, adapted=adapted_text,
            compute_dtype=compute_dtype)

    @classmethod
    def from_checkpoint(cls, save_path: Optional[str], dataset: str,
                        img_size: int = 518, backbone: Optional[str] = None,
                        allow_random_backbone: bool = False,
                        model_name: str = "ViT-L-14-336",
                        compute_dtype=torch.bfloat16, device="cuda",
                        **kwargs) -> "AnomalyDetector":
        """Assemble from a backbone (an OpenAI ``.pt`` or an ``.npz``) and a
        training ``save_path`` of ``cli.train`` (None for zero-shot: raw
        CLIP anchors and untrained adapters). The weights' matrices take
        ``compute_dtype``; the anchors come from the adapted text tower only
        when a stage-1 text adapter was restored."""
        cfg = build_model_config(model_name=model_name, img_size=img_size)
        frozen = load_frozen_backbone(cfg, backbone,
                                      allow_random=allow_random_backbone,
                                      device=device, dtype=compute_dtype)
        trainable = init_trainable(cfg, device=device, dtype=compute_dtype)
        adapted_text = False
        if save_path:
            trainable, adapted_text, _ = restore_adapters(
                save_path, trainable, require_stage2=False)
        return cls(frozen, trainable, cfg, dataset, img_size=img_size,
                   adapted_text=adapted_text, compute_dtype=compute_dtype,
                   device=device, **kwargs)

    def class_names(self) -> List[str]:
        return list(self.anchors.keys())

    def _run(self, padded, anchors_b, n):
        images = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
        maps, scores = self._predict(self.frozen, self.trainable, images,
                                     anchors_b)
        return maps[:n].cpu().numpy(), scores[:n].cpu().numpy()

    def predict(self, images: np.ndarray,
                class_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """images: (B, 3, H, W), H=W=img_size — float32 CLIP-normalized, or
        uint8 raw pixels (normalized on the device, bit-identically).
        Returns (anomaly maps (B, H, W) float32, image scores (B,))."""
        if class_name not in self.anchors:
            raise KeyError(
                f"unknown class {class_name!r}; available: {self.class_names()}")

        def run(padded, bucket, n):
            anchor = self.anchors[class_name]
            anchors_b = anchor[None].expand((bucket,) + tuple(anchor.shape))
            return self._run(padded, anchors_b, n)

        return _bucketed(images, self._buckets,
                         lambda i, j: self.predict(images[i:j], class_name),
                         run)

    def predict_multi(self, images: np.ndarray,
                      class_names: Sequence[str]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Mixed-class batch: images[i] scored against class_names[i]'s
        anchor, in one device batch."""
        n = images.shape[0]
        if len(class_names) != n:
            raise ValueError(
                f"{n} images but {len(class_names)} class names")
        unknown = [c for c in class_names if c not in self.anchors]
        if unknown:
            raise KeyError(
                f"unknown class {unknown[0]!r}; available: "
                f"{self.class_names()}")

        def run(padded, bucket, n):
            pad_names = list(class_names) + [class_names[-1]] * (bucket - n)
            anchors_b = torch.stack([self.anchors[c] for c in pad_names], dim=0)
            return self._run(padded, anchors_b, n)

        return _bucketed(images, self._buckets,
                         lambda i, j: self.predict_multi(images[i:j],
                                                         class_names[i:j]),
                         run)

    def predict_paths(self, paths: Sequence[str],
                      class_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """Load (RGB, bicubic resize to img_size) and predict. The images
        travel as uint8 and are normalized on the device, bit-identically
        to host normalization, for a quarter of the transfer."""
        images = np.stack([_load_image_u8(p, self.img_size) for p in paths])
        return self.predict(images, class_name)


class MicroBatchingService:
    """Request-coalescing front end for :class:`AnomalyDetector`.

    Callers submit single images from any thread; one worker thread drains
    the queue and runs each window of requests that arrive within
    ``max_latency_ms`` (at most ``max_batch``) as ONE bucketed device batch
    through ``predict_multi``, which takes per-sample anchors, so a window of
    mixed classes is not split. A detector that has only
    ``predict(images, class_name)`` gets one call per class of the window.
    All device work runs on the worker thread; submitters only wait.

        svc = MicroBatchingService(det, max_batch=32, max_latency_ms=5)
        fut = svc.submit(image, "bottle")      # non-blocking
        amap, score = fut.result(timeout=60)
        svc.close()
    """

    _STOP = object()

    def __init__(self, detector, max_batch: int = 32,
                 max_latency_ms: float = 5.0):
        import queue
        import threading

        self.detector = detector
        self.max_batch = max_batch
        self.max_latency = max_latency_ms / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        # Serializes submit()'s closed-check-then-put against close()'s
        # closed-set-then-STOP: without it a submit could pass the check and
        # enqueue behind the sentinel after the worker's shutdown drain ran,
        # leaving a future that never resolves.
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, image: np.ndarray, class_name: str):
        """image: (3, H, W), CLIP-normalized. Returns a Future of (anomaly
        map (H, W), image score). Raises RuntimeError once close() was
        called; a submit racing close() either is served or its future
        fails with RuntimeError in the shutdown drain."""
        from concurrent.futures import Future

        if image.ndim != 3:
            raise ValueError(f"expected one (3, H, W) image, got {image.shape}")
        # The full shape is checked here, so that a malformed request fails
        # its own caller and not every request coalesced into its window.
        size = getattr(self.detector, "img_size", None)
        if size is not None and image.shape != (3, size, size):
            raise ValueError(
                f"expected one (3, {size}, {size}) image for this detector, "
                f"got {image.shape}")
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatchingService is closed")
            self._queue.put((image, class_name, fut))
        return fut

    def predict(self, image: np.ndarray, class_name: str):
        """Blocking single-image wrapper around submit()."""
        return self.submit(image, class_name).result()

    def close(self):
        """Idempotent shutdown: requests in flight still resolve; anything
        queued behind the stop sentinel fails with RuntimeError."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._queue.put(self._STOP)
        self._worker.join()

    # ------------------------------------------------------------------
    def _run(self):
        import queue
        import time

        while True:
            item = self._queue.get()
            if item is self._STOP:
                self._drain()
                return
            batch = [item]
            deadline = time.monotonic() + self.max_latency
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._flush(batch)
                    self._drain()
                    return
                batch.append(nxt)
            self._flush(batch)

    @staticmethod
    def _settle(fut, result=None, exc=None):
        """Resolve a request's future unless its caller cancelled it while
        it waited (set_result on a cancelled future would raise and end the
        worker thread)."""
        if not fut.set_running_or_notify_cancel():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)

    def _drain(self):
        """Fail the requests that raced past close() behind the sentinel."""
        import queue

        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not self._STOP:
                self._settle(item[2], exc=RuntimeError(
                    "MicroBatchingService closed before this request was served"))

    def _flush(self, batch):
        multi = getattr(self.detector, "predict_multi", None)
        if multi is None:
            return self._flush_by_class(batch)
        # Unknown classes fail alone, so that one bad request does not fail
        # the window.
        try:
            known = set(self.detector.class_names())
        except Exception:
            known = None
        valid = []
        for item in batch:
            if known is not None and item[1] not in known:
                self._settle(item[2], exc=KeyError(
                    f"unknown class {item[1]!r}; available: {sorted(known)}"))
            else:
                valid.append(item)
        if valid:
            self._dispatch(valid, lambda images: multi(images, [c for _, c, _ in valid]))

    def _flush_by_class(self, batch):
        """For detectors with only a single-class predict()."""
        by_class: Dict[str, list] = {}
        for item in batch:
            by_class.setdefault(item[1], []).append(item)
        for class_name, items in by_class.items():
            self._dispatch(items, lambda images, c=class_name:
                           self.detector.predict(images, c))

    def _dispatch(self, items, run):
        """Run one device batch and settle its futures. Any exception (a
        sticky CUDA error included) settles every future of the batch with
        it, and the worker goes on."""
        try:
            images = np.stack([img for img, _, _ in items]).astype(np.float32)
            maps, scores = run(images)
        except Exception as exc:
            for _, _, fut in items:
                self._settle(fut, exc=exc)
            return
        for i, (_, _, fut) in enumerate(items):
            self._settle(fut, result=(maps[i], scores[i]))
