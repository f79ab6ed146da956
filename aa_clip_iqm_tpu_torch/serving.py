"""Serving API: one object from checkpoint to anomaly maps.

Counterpart of ``aa_clip_iqm_tpu/serving.py``'s ``AnomalyDetector``,
``MicroBatchingService``, ``export_predictor`` and ``ExportedPredictor``:

    det = AnomalyDetector.from_checkpoint("ckpt/baseline", "MVTec",
                                          backbone="ViT-L-14-336px.pt")
    maps, scores = det.predict(images, class_name="bottle")    # numpy in/out
    maps, scores = det.predict_paths(["a.png", "b.png"], "bottle")

    svc = MicroBatchingService(det, max_batch=32, max_latency_ms=5)
    amap, score = svc.submit(image, "bottle").result(timeout=60)

    export_predictor(det, "exported/", batch_sizes=(1, 8, 16))
    maps, scores = ExportedPredictor("exported/").predict(images, "bottle")

Everything runs on ``cuda`` unless ``device="cpu"`` is passed, through the
hand-written kernels unless ``use_pallas=False`` is passed (the stock
PyTorch route of ``models.clip``: SDPA and the cuBLAS chain, no kernel of
the port; the JAX package's XLA route). Anchors are
computed once per dataset and kept on the device. Caller batches are padded
up to the smallest fitting bucket and larger ones split into largest-bucket
chunks, as in the JAX package. ``quantize=`` selects an int8 backbone tier
(``ops/quant.py``).

On the card a detector runs each bucket as a CUDA graph, the counterpart of
the JAX package compiling its predict program once per bucket: the first
request of a (bucket, input dtype) runs the eager program once (a warm-up
that builds the kernels' libraries, sets their launch attributes, fills the
device constants and the int8 kernel's transposed weights), then captures
it; every later request copies its batch into the graph's input buffers,
replays, and copies the outputs out into page-locked host memory, with
asynchronous device-to-host copies. So on the card the maps and scores a
detector returns are numpy views of page-locked blocks of PyTorch's caching
host allocator, rounded up to a power of two (64 MB for 32 maps at 518 px or
8 at 1274 px): a block stays page-locked while the caller holds an array of
it, or a view such as a ``MicroBatchingService`` request's map, and is
reused once they are dropped. A caller that keeps many results keeps them in
page-locked memory; ``np.array(maps)`` copies one out. A call split over
several chunks of the largest bucket returns their concatenation in ordinary
memory.
A CPU detector runs eagerly, and so does any detector while
``utils.profiling.enable_nan_checks`` is on: its checks synchronise at every
op, which a capture forbids. ``det._predict`` is the eager program itself.

A detector's call is the span ``aaclip/predict`` (``utils.profiling.span``)
with the children ``predict/stage``, ``predict/copy_in``, ``predict/replay``
(``predict/run`` when eager) and ``predict/copy_out``; each device batch
adds to the counters ``predict.calls``, ``predict.rows``,
``predict.padded_rows``, ``predict.bytes_in`` and ``predict.bytes_out``;
each one copied out into page-locked memory adds to
``predict.copy_out_pinned``, and each page-locked block that copy had to
create, rather than reuse, to ``predict.pinned_allocs``. The
micro-batcher counts ``serve.requests``, ``serve.batches`` and
``serve.queue_wait_s``.

``export_predictor`` writes one ``torch.export`` program per bucket, whose
kernels are the ``aaclip::`` custom ops (``ops/custom_ops.py``), and
``ExportedPredictor`` serves them with no model code.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import ModelConfig
from .data.datasets import _load_image_u8
from .data.registry import DOMAINS
from .evaluation.predict import make_predict_fn
from .loader import build_model_config, init_trainable, load_frozen_backbone
from .ops import custom_ops  # noqa: F401  (registers the aaclip:: ops the programs call)
from .ops import interp
from .prompts import compute_frozen_anchors
from .train import graphs
from .train.checkpoint import restore_adapters
from .utils.profiling import count, nan_checks_enabled, span

#: Default batch buckets (as the JAX package's compile-once ladder).
DEFAULT_BATCH_BUCKETS = (1, 8, 16, 32)


def _bucketed(images, buckets, run):
    """Bucket fit and split shared by the predict entry points: empty batches
    give empty results; batches larger than the biggest bucket (``buckets``
    ascending) are split into chunks of it; each chunk ``images[start:stop]``
    runs once through ``run(start, stop, bucket)`` with the smallest bucket
    that fits it, which pads it (:func:`_pad`)."""
    n = images.shape[0]
    if n == 0:
        return (np.zeros((0,) + tuple(images.shape[-2:]), np.float32),
                np.zeros((0,), np.float32))
    top, parts = buckets[-1], []
    for i in range(0, n, top):
        j = min(i + top, n)
        parts.append(run(i, j, next(b for b in buckets if b >= j - i)))
    if len(parts) == 1:
        return parts[0]
    maps, scores = zip(*parts)
    return np.concatenate(maps), np.concatenate(scores)


def _pad(images, bucket):
    """``images`` zero-padded to ``bucket`` rows."""
    n = images.shape[0]
    if bucket == n:
        return images
    return np.concatenate(
        [images, np.zeros((bucket - n,) + tuple(images.shape[1:]), images.dtype)], axis=0)


def _copy_out_pinned(*outputs):
    """Device tensors to numpy arrays in page-locked host memory: each one
    is copied asynchronously into a block of PyTorch's caching host
    allocator, the current stream is waited for, and each array is a view
    whose ``base`` is its pinned tensor. The block stays page-locked while
    the caller holds the array, and the allocator reuses it once the array
    is dropped. Counts the device batch (``predict.copy_out_pinned``) and
    the blocks the allocator had to create rather than reuse
    (``predict.pinned_allocs``)."""
    # The nested form skips the flat form's flattening and sort (9 against
    # 35 us a call on an H100 host).
    stats = torch.cuda.host_memory_stats_as_nested_dict
    allocs = stats()["num_host_alloc"]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outputs]
    for host, t in zip(hosts, outputs):
        host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(outputs[0].device).synchronize()
    count("predict.copy_out_pinned")
    count("predict.pinned_allocs", stats()["num_host_alloc"] - allocs)
    return tuple(host.numpy() for host in hosts)


class _BucketGraph:
    """One captured predict program: its static input and output buffers,
    what it must keep alive, and its replays."""

    def __init__(self, **fields):
        self.replays = 0
        self.__dict__.update(fields)


class AnomalyDetector:
    """Batched anomaly-map inference for one dataset's class vocabulary.

    ``frozen`` and ``trainable`` are the port's parameter dicts, already on
    ``device`` (``"cuda"`` by default; pass ``"cpu"`` explicitly to run the
    plain twins on the CPU). ``use_pallas`` (default True; the JAX
    package's default too) picks the hand-written kernels, False the stock
    PyTorch route, for the anchors, the predict program and a ``+smooth``
    calibration. On the card each bucket runs as a CUDA graph, except while
    ``utils.profiling.enable_nan_checks`` is on: its checks synchronise at
    every op, which a capture cannot hold, so requests then run the eager
    program (``_run_eager``)."""

    def __init__(self, frozen, trainable, model_cfg: ModelConfig,
                 dataset: str, img_size: int = 518, adapted_text: bool = True,
                 compute_dtype=torch.bfloat16, text_weight: float = 0.6,
                 iqm_weight: float = 0.4,
                 batch_buckets: Sequence[int] = DEFAULT_BATCH_BUCKETS,
                 quantize: Optional[str] = None, device="cuda",
                 use_pallas: bool = True):
        self.device = torch.device(device)
        self.use_pallas = use_pallas
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
                                            trainable=trainable,
                                            use_pallas=use_pallas)
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
        self._predict_kwargs = dict(compute_dtype=compute_dtype,
                                    text_weight=text_weight, iqm_weight=iqm_weight)
        self._predict = self.predict_fn(use_pallas)
        self.anchors: Dict[str, torch.Tensor] = compute_frozen_anchors(
            frozen, trainable, model_cfg, dataset, adapted=adapted_text,
            compute_dtype=compute_dtype, use_pallas=use_pallas)
        self._graphs: Dict[tuple, _BucketGraph] = {}
        self._graph_lock = threading.Lock()
        self._graph_pool = None

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

    def predict_fn(self, use_pallas: bool):
        """This detector's eager predict program on the kernels' route
        (``use_pallas=True``) or the stock PyTorch one."""
        return make_predict_fn(self.cfg, self.img_size, self.domain,
                               use_pallas=use_pallas, **self._predict_kwargs)

    def class_names(self) -> List[str]:
        return list(self.anchors.keys())

    def _run(self, padded, anchors_b, n):
        """One padded bucket through the program: a graph replay on the
        card, the eager program on the CPU or with NaN checks on. Counts
        the device batch, its rows and padding, and the bytes copied
        between host and device (the anchors are on the device already)."""
        count("predict.calls")
        count("predict.rows", n)
        count("predict.padded_rows", padded.shape[0] - n)
        count("predict.bytes_in", padded.nbytes)
        if self.device.type == "cuda" and not nan_checks_enabled():
            maps, scores = self._run_graph(padded, anchors_b, n)
        else:
            maps, scores = self._run_eager(padded, anchors_b, n)
        count("predict.bytes_out", maps.nbytes + scores.nbytes)
        return maps, scores

    def _run_eager(self, padded, anchors_b, n):
        with span("predict/stage"):
            images = torch.from_numpy(np.ascontiguousarray(padded))
        with span("predict/copy_in"):
            images = images.to(self.device)
        with span("predict/run"):
            maps, scores = self._predict(self.frozen, self.trainable, images,
                                         anchors_b)
        with span("predict/copy_out"):
            return maps[:n].cpu().numpy(), scores[:n].cpu().numpy()

    def _run_graph(self, padded, anchors_b, n):
        """Copy in, replay, copy out (into page-locked host memory,
        :func:`_copy_out_pinned`). The graphs' buffers are shared by every
        replay (and their intermediates by every bucket, through one memory
        pool), so one lock serialises the three steps."""
        with span("predict/stage"):
            images = torch.from_numpy(np.ascontiguousarray(padded))
        key = (images.shape[0], images.dtype)
        with self._graph_lock:
            g = self._graphs.get(key)
            if g is None or g.frozen is not self.frozen or g.trainable is not self.trainable:
                g = self._graphs[key] = self._capture(images, anchors_b)
            with span("predict/copy_in"):
                g.images.copy_(images)
                g.anchors.copy_(anchors_b)
            with span("predict/replay"):
                g.graph.replay()
            g.replays += 1
            with span("predict/copy_out"):
                return _copy_out_pinned(g.maps[:n], g.scores[:n])

    def _capture(self, images, anchors_b) -> "_BucketGraph":
        """Warm up, then capture the predict program on static buffers.

        The capture (``train.graphs.capture``) runs on the calling thread:
        under :class:`MicroBatchingService` that is its worker, while the
        HTTP threads go on with their own work. ``capture_error_mode=
        "thread_local"`` confines the capture's ban on unsafe CUDA calls to
        this thread, so another thread's synchronising call neither fails
        nor invalidates the capture (``"global"``, the default, would do
        both). The TMA tensor maps are encoded on the host at each launch and
        passed by value: the capture freezes them with the addresses of that
        launch, which holds because the input buffers, the weights (the
        graph keeps the trees, and with them the int8 kernel's transposed
        copies, which live as long as their weights), the device constants
        (the graph keeps those built so far, which include every one its
        program reads) and the pool's intermediates never move between
        replays."""
        dev = self.device
        t0 = time.perf_counter()
        with span("capture"):
            pool0 = self.graph_memory()
            static_images = images.to(dev)
            static_anchors = anchors_b.contiguous().clone()
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph, (maps, scores) = graphs.capture(
                lambda: self._predict(self.frozen, self.trainable, static_images,
                                      static_anchors),
                self._graph_pool, dev)
            torch.cuda.synchronize(dev)
            capture_s = time.perf_counter() - t0
            count("graphs.captures")
            count("graphs.capture_s", capture_s)
            return _BucketGraph(
                graph=graph, images=static_images, anchors=static_anchors, maps=maps,
                scores=scores, frozen=self.frozen, trainable=self.trainable,
                constants=interp.device_constants(), capture_s=capture_s,
                pool_bytes=self.graph_memory() - pool0)

    def graph_memory(self) -> int:
        """Bytes of device memory in the segments of the graphs' shared pool
        (what the graphs hold beyond their inputs and the weights)."""
        return graphs.pool_memory(self._graph_pool)

    def graph_stats(self) -> List[dict]:
        """One entry per captured graph: its bucket and input dtype, its
        replays (the device batches it ran), the seconds of its warm-up and
        capture, and how much its capture grew the graphs' pool."""
        with self._graph_lock:
            return [{"bucket": b, "dtype": str(dt).replace("torch.", ""),
                     "replays": g.replays, "capture_s": g.capture_s,
                     "pool_bytes": g.pool_bytes}
                    for (b, dt), g in self._graphs.items()]

    def predict(self, images: np.ndarray,
                class_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """images: (B, 3, H, W), H=W=img_size — float32 CLIP-normalized, or
        uint8 raw pixels (normalized on the device, bit-identically).
        Returns (anomaly maps (B, H, W) float32, image scores (B,)). On the
        card both are views of page-locked host memory, which stays
        page-locked while the caller holds them (the module's docstring)."""
        if class_name not in self.anchors:
            raise KeyError(
                f"unknown class {class_name!r}; available: {self.class_names()}")
        anchor = self.anchors[class_name]

        def run(i, j, bucket):
            with span("predict/stage"):
                padded = _pad(images[i:j], bucket)
                anchors_b = anchor[None].expand((bucket,) + tuple(anchor.shape))
            return self._run(padded, anchors_b, j - i)

        with span("predict"):
            return _bucketed(images, self._buckets, run)

    def predict_multi(self, images: np.ndarray,
                      class_names: Sequence[str]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Mixed-class batch: images[i] scored against class_names[i]'s
        anchor, in one device batch. On the card the maps and scores are
        views of page-locked host memory, as :meth:`predict`'s."""
        n = images.shape[0]
        if len(class_names) != n:
            raise ValueError(
                f"{n} images but {len(class_names)} class names")
        unknown = [c for c in class_names if c not in self.anchors]
        if unknown:
            raise KeyError(
                f"unknown class {unknown[0]!r}; available: "
                f"{self.class_names()}")

        def run(i, j, bucket):
            with span("predict/stage"):
                padded = _pad(images[i:j], bucket)
                pad_names = list(class_names[i:j]) + [class_names[j - 1]] * (bucket - (j - i))
                anchors_b = torch.stack([self.anchors[c] for c in pad_names], dim=0)
            return self._run(padded, anchors_b, j - i)

        with span("predict"):
            return _bucketed(images, self._buckets, run)

    def predict_paths(self, paths: Sequence[str],
                      class_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """Load (RGB, bicubic resize to img_size) and predict. The images
        travel as uint8 and are normalized on the device, bit-identically
        to host normalization, for a quarter of the transfer."""
        images = np.stack([_load_image_u8(p, self.img_size) for p in paths])
        return self.predict(images, class_name)


def _flatten_tree(tree, prefix=""):
    """Dict/list tree -> {'a/#0/c': leaf}, the JAX package's flat key scheme
    (``aa_clip_iqm_tpu/serving.py``): list positions get '#<i>' segments so
    the structure round-trips."""
    out = {}
    items = (tree.items() if isinstance(tree, dict)
             else ((f"#{i}", v) for i, v in enumerate(tree)))
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list, tuple)):
            out.update(_flatten_tree(v, key + "/"))
        else:
            out[key] = v
    return out


def _unflatten_tree(flat):
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.startswith("#") for k in node):
            return [node[f"#{i}"] for i in range(len(node))]
        return node

    return listify(out)


class _ExternalWeights(torch.nn.Module):
    """The predict program with the weight trees as inputs."""

    def __init__(self, predict):
        super().__init__()
        self.predict = predict

    def forward(self, frozen, trainable, images, anchors):
        return self.predict(frozen, trainable, images, anchors)


class _BakedWeights(torch.nn.Module):
    """The predict program with the weights as the module's buffers, so the
    exported program carries them."""

    def __init__(self, predict, frozen, trainable):
        super().__init__()
        self.predict = predict
        flat = _flatten_tree({"frozen": frozen, "trainable": trainable})
        self.keys = list(flat)
        for i, k in enumerate(self.keys):
            self.register_buffer(f"w{i}", flat[k])

    def forward(self, images, anchors):
        tree = _unflatten_tree({k: getattr(self, f"w{i}") for i, k in enumerate(self.keys)})
        return self.predict(tree["frozen"], tree["trainable"], images, anchors)


def export_predictor(detector: AnomalyDetector, out_dir: str,
                     batch_sizes: Sequence[int] = (1, 8, 16),
                     weights: str = "external",
                     use_pallas: Optional[bool] = None) -> Dict[int, float]:
    """Write the predict program as deployable artifacts, the layout of the
    JAX package's ``export_predictor``: per batch bucket one
    ``torch.export`` program ``predict_b{b}.pt2`` (shape-specialised, its
    kernels the ``aaclip::`` ops), the per-class anchors ``anchors.npz`` and
    ``manifest.json``. :class:`ExportedPredictor` loads them with no model
    code, config registry or checkpoint layout.

    ``weights="external"`` (default): each program takes ``(frozen,
    trainable, images, anchors)``, the weight trees as inputs, and they ship
    in ``weights.npz`` under the flat keys of :func:`_flatten_tree`
    (bfloat16 leaves stored as float32 and listed in the manifest's
    ``bf16_keys``). ``weights="baked"``: the weights are constants of each
    program, which takes ``(images, anchors)``. ``use_pallas``: the route of
    the exported program, the detector's by default; ``False`` exports the
    stock PyTorch route, a program with no ``aaclip::`` node.

    The programs hold the device they were traced on, so export on the
    device you serve on: the manifest records it (``device``, the card's
    name in ``device_name``). Returns the seconds each bucket's export and
    save took."""
    if weights not in ("external", "baked"):
        raise ValueError(f"weights must be 'external' or 'baked', got {weights!r}")
    if not batch_sizes or any(int(b) <= 0 for b in batch_sizes):
        raise ValueError(
            f"batch_sizes must be non-empty positive ints, got {batch_sizes!r}")
    os.makedirs(out_dir, exist_ok=True)
    if use_pallas is None:
        use_pallas = detector.use_pallas
    predict = (detector._predict if use_pallas == detector.use_pallas
               else detector.predict_fn(use_pallas))
    dev = detector.device
    img, e = detector.img_size, detector.cfg.clip.embed_dim
    bf16_keys: list = []
    if weights == "external":
        module = _ExternalWeights(predict)
        flat = {**_flatten_tree({"frozen": detector.frozen}),
                **_flatten_tree({"trainable": detector.trainable})}
        bf16_keys = [k for k, v in flat.items() if v.dtype == torch.bfloat16]
        np.savez(os.path.join(out_dir, "weights.npz"),
                 **{k: (v.detach().float() if v.dtype == torch.bfloat16 else v.detach())
                    .cpu().numpy() for k, v in flat.items()})

        def args(b):
            return (detector.frozen, detector.trainable) + example(b)
    else:
        module = _BakedWeights(predict, detector.frozen, detector.trainable)

        def args(b):
            return example(b)

    def example(b):
        return (torch.zeros((b, 3, img, img), dtype=torch.float32, device=dev),
                torch.zeros((b, e, 2), dtype=torch.float32, device=dev))

    seconds = {}
    for b in sorted(int(b) for b in batch_sizes):
        t0 = time.perf_counter()
        program = torch.export.export(module, args(b), strict=False)
        # The example inputs would be saved too: with external weights, the
        # whole weight trees in every program.
        program.example_inputs = None
        torch.export.save(program, os.path.join(out_dir, f"predict_b{b}.pt2"))
        seconds[b] = time.perf_counter() - t0
    np.savez(os.path.join(out_dir, "anchors.npz"),
             **{k: v.float().cpu().numpy() for k, v in detector.anchors.items()})
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump({
            "img_size": img,
            "embed_dim": e,
            "dataset": detector.dataset,
            "domain": detector.domain,
            "batch_sizes": sorted(int(b) for b in batch_sizes),
            "classes": detector.class_names(),
            "device": dev.type,
            "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                            else dev.type),
            "use_pallas": bool(use_pallas),
            "weights": weights,
            "bf16_keys": bf16_keys,
        }, f, indent=1)
    return seconds


class ExportedPredictor:
    """Serve anomaly maps from :func:`export_predictor` artifacts, with the
    contract of :meth:`AnomalyDetector.predict` (numpy in and out, bucketed
    batches): it needs only the artifact directory and the port's
    ``aaclip::`` ops, registered by importing this module.

        pred = ExportedPredictor("exported/")
        maps, scores = pred.predict(images, "bottle")

    The programs run on the device type they were exported on (the
    manifest's ``device``); ``device`` picks which one of that type, and
    another type is refused, as the JAX package's artifacts are checked
    against their platform."""

    def __init__(self, path: str, device=None):
        with open(os.path.join(path, "manifest.json")) as f:
            self.manifest = json.load(f)
        exported_on = self.manifest["device"]
        self.device = torch.device(exported_on if device is None else device)
        if self.device.type != exported_on:
            raise ValueError(
                f"{path} was exported for {exported_on} "
                f"({self.manifest.get('device_name', exported_on)}) and runs there only, "
                f"not on {self.device}: export again on the device you serve on")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for cuda, and this process sees no "
                               "CUDA device")
        self.img_size = self.manifest["img_size"]
        self.domain = self.manifest["domain"]
        self.anchors = {k: torch.from_numpy(v).to(self.device) for k, v in
                        np.load(os.path.join(path, "anchors.npz")).items()}
        self._path = path
        self._programs: Dict[int, object] = {}
        self._weights = None
        if self.manifest.get("weights", "baked") == "external":
            bf16 = set(self.manifest.get("bf16_keys", []))
            flat = {k: torch.from_numpy(v).to(self.device,
                                              torch.bfloat16 if k in bf16 else None)
                    for k, v in np.load(os.path.join(path, "weights.npz")).items()}
            tree = _unflatten_tree(flat)
            self._weights = (tree["frozen"], tree["trainable"])

    def class_names(self) -> List[str]:
        return list(self.manifest["classes"])

    def _program(self, bucket: int):
        if bucket not in self._programs:
            program = torch.export.load(os.path.join(self._path, f"predict_b{bucket}.pt2"))
            self._programs[bucket] = program.module()
        return self._programs[bucket]

    def _check_images(self, images):
        img = self.img_size
        if images.ndim != 4 or images.shape[1:] != (3, img, img):
            raise ValueError(
                f"expected (B, 3, {img}, {img}) images (the exported "
                f"programs are shape-specialized), got {images.shape}")

    def predict(self, images: np.ndarray,
                class_name: str) -> Tuple[np.ndarray, np.ndarray]:
        """images: (B, 3, H, W) float32 CLIP-normalized -> (maps, scores)."""
        if class_name not in self.anchors:
            raise KeyError(
                f"unknown class {class_name!r}; available: {self.class_names()}")
        self._check_images(images)

        anchor = self.anchors[class_name]

        def run(i, j, bucket):
            anchors_b = anchor[None].expand((bucket,) + tuple(anchor.shape))
            return self._call(_pad(images[i:j], bucket), anchors_b, j - i)

        return _bucketed(images, self.manifest["batch_sizes"], run)

    def predict_multi(self, images: np.ndarray,
                      class_names: Sequence[str]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Mixed-class batch over the exported programs (per-sample anchors;
        the contract of :meth:`AnomalyDetector.predict_multi`)."""
        n = images.shape[0]
        if len(class_names) != n:
            raise ValueError(
                f"{n} images but {len(class_names)} class names")
        unknown = [c for c in class_names if c not in self.anchors]
        if unknown:
            raise KeyError(
                f"unknown class {unknown[0]!r}; available: "
                f"{self.class_names()}")
        self._check_images(images)

        def run(i, j, bucket):
            pad_names = list(class_names[i:j]) + [class_names[j - 1]] * (bucket - (j - i))
            anchors_b = torch.stack([self.anchors[c] for c in pad_names], dim=0)
            return self._call(_pad(images[i:j], bucket), anchors_b, j - i)

        return _bucketed(images, self.manifest["batch_sizes"], run)

    def _call(self, images, anchors_b, n):
        program = self._program(anchors_b.shape[0])
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(self.device)
        anchors_b = anchors_b.contiguous()
        with torch.no_grad():
            if self._weights is not None:
                maps, scores = program(*self._weights, x, anchors_b)
            else:
                maps, scores = program(x, anchors_b)
        return maps[:n].cpu().numpy(), scores[:n].cpu().numpy()


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
            self._queue.put((image, class_name, fut, time.perf_counter()))
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
            self._dispatch(valid, lambda images: multi(images, [it[1] for it in valid]))

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
        it, and the worker goes on. Counts the batch, its requests and their
        seconds in the queue (from ``submit`` to here)."""
        now = time.perf_counter()
        count("serve.batches")
        count("serve.requests", len(items))
        count("serve.queue_wait_s", sum(now - it[3] for it in items))
        with span("serve/dispatch"):
            try:
                images = np.stack([it[0] for it in items]).astype(np.float32)
                maps, scores = run(images)
            except Exception as exc:
                for it in items:
                    self._settle(it[2], exc=exc)
                return
            for i, it in enumerate(items):
                self._settle(it[2], result=(maps[i], scores[i]))
