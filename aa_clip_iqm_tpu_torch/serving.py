"""Serving API: one object from weights to anomaly maps.

Counterpart of ``AnomalyDetector`` in ``aa_clip_iqm_tpu/serving.py``
(``__init__``, ``predict``, ``predict_multi`` and the bucket ladder):

    det = AnomalyDetector(frozen, trainable, cfg, "MVTec")     # on cuda
    maps, scores = det.predict(images, class_name="bottle")    # numpy in/out

Anchors are computed once per dataset and kept on the device. Caller batches
are padded up to the smallest fitting bucket and larger ones split into
largest-bucket chunks, as in the JAX package. ``quantize=`` selects an int8
backbone tier (``ops/quant.py``). The checkpoint, path-loading, export and
micro-batching surfaces are not ported yet.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import ModelConfig
from .data.registry import DOMAINS
from .evaluation.predict import make_predict_fn
from .prompts import compute_frozen_anchors

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
