#!/usr/bin/env python
"""HTTP anomaly-detection server (standard library only) over the serving
stack.

    python -m aa_clip_iqm_tpu_torch.cli.serve --backbone ViT-L-14-336px.pt \\
        --save_path ckpt/ --dataset MVTec --port 8000
    python -m aa_clip_iqm_tpu_torch.cli.serve --exported exported/ --port 8000

Counterpart of ``aa_clip_iqm_tpu/cli/serve.py``. Every request thread
submits its image to one :class:`..serving.MicroBatchingService` and waits
on the future, so concurrent requests, of any classes, coalesce into one
bucketed device batch per latency window; all device work runs on the
service's worker thread. It runs on ``cuda`` unless ``--device cpu`` is
given, through the port's kernels unless ``--no_pallas`` is given (the
stock PyTorch route: SDPA and the cuBLAS chain). The model is either
assembled from a backbone and a ``cli.train`` save path, or read from
``--exported`` artifacts
(``aa_clip_iqm_tpu_torch.tools.export_model``), served through
:class:`..serving.ExportedPredictor` on the device they were exported for.

Endpoints (JSON responses):
  GET  /v1/health         {"status", "dataset", "img_size", "classes", ...}
  GET  /v1/classes        {"classes": [...]}
  POST /v1/predict        one image -> {"score", "map"?}
  POST /v1/predict_batch  {"requests": [...]} -> {"results": [...]}; the
                          whole list is submitted before any wait.

/v1/predict takes either
  - Content-Type: application/octet-stream: ``.npy`` bytes of a float32
    (3, S, S) CLIP-normalized array (S = img_size), the class in
    ``?class_name=`` or the ``X-Class-Name`` header; or
  - Content-Type: application/json: ``{"class_name": ..., "image_b64":
    <base64 PNG/JPEG file bytes>}``, which the server decodes, resizes
    bicubically to img_size and normalizes as the datasets do (or
    ``"npy_b64"`` for a preprocessed array).

``?map=npy|png|none`` (default npy) selects the map's encoding:
  npy  -> {"map": {"b64": <base64 .npy float32 (S, S)>, "encoding": "npy"}}
  png  -> {"map": {"b64": <base64 PNG>, "encoding": "png"}}, a JET overlay
          on the input image (evaluation/visualize.render_overlay)
  none -> the score alone.
"""
from __future__ import annotations

import argparse
import base64
import io
import json
import logging
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..platform import default_device

logger = logging.getLogger("aa_clip_iqm_tpu_torch.serve")

#: Request bodies above this size are refused (the largest legitimate one is
#: a batch of 518 px float32 arrays).
MAX_BODY_BYTES = 256 * 1024 * 1024


def _b64_npy(arr: np.ndarray) -> str:
    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(arr, np.float32))
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _png_overlay(image01: np.ndarray, amap: np.ndarray) -> str:
    """Base64 PNG of the JET overlay of a min-max-normalized map on the
    [0, 1] CHW RGB input."""
    import cv2

    from ..evaluation.visualize import render_overlay

    bgr = (np.clip(image01, 0, 1).transpose(1, 2, 0)[..., ::-1]
           * 255).astype(np.uint8)
    ok, buf = cv2.imencode(".png", render_overlay(bgr, amap))
    if not ok:
        raise RuntimeError("PNG encoding failed")
    return base64.b64encode(buf.tobytes()).decode("ascii")


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class PredictHandler(BaseHTTPRequestHandler):
    """One instance per request; the state lives on the server object
    (``self.server``): service, img_size, meta, request_timeout,
    denormalize."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        logger.info("%s %s", self.address_string(), fmt % args)

    def _send_json(self, obj, status: int = 200, close: bool = False):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if close:
            # An error may be answered before the request body was read; on
            # a keep-alive connection the unread bytes would be parsed as
            # the next request. Closing the connection discards them.
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(body)

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length <= 0:
            raise _HTTPError(400, "empty body (Content-Length required)")
        if length > MAX_BODY_BYTES:
            raise _HTTPError(413, f"body exceeds {MAX_BODY_BYTES} bytes")
        return self.rfile.read(length)

    # -- request decoding ----------------------------------------------
    def _decode_npy_image(self, data: bytes) -> np.ndarray:
        s = self.server.img_size
        try:
            arr = np.load(io.BytesIO(data), allow_pickle=False)
        except Exception as exc:
            raise _HTTPError(400, f"invalid .npy payload: {exc}")
        if arr.shape != (3, s, s):
            raise _HTTPError(400, f"expected (3, {s}, {s}) array, got {arr.shape}")
        return np.asarray(arr, np.float32)

    def _decode_file_image(self, raw: bytes) -> np.ndarray:
        """Image file bytes -> CLIP-normalized (3, S, S) float32, through
        the datasets' decode (which takes a file object)."""
        from ..data.datasets import _load_image, normalize_clip

        try:
            img01 = _load_image(io.BytesIO(raw), self.server.img_size)
        except Exception as exc:
            raise _HTTPError(400, f"cannot decode image: {exc}")
        return normalize_clip(img01).astype(np.float32)

    def _parse_one(self, entry) -> tuple:
        """A JSON request entry -> (normalized image, class_name)."""
        if not isinstance(entry, dict):
            raise _HTTPError(400, "each request must be a JSON object")
        class_name = entry.get("class_name")
        if not class_name:
            raise _HTTPError(400, "missing 'class_name'")
        for key, decode in (("image_b64", self._decode_file_image),
                            ("npy_b64", self._decode_npy_image)):
            if key in entry:
                try:
                    raw = base64.b64decode(entry[key], validate=True)
                except Exception:
                    raise _HTTPError(400, f"invalid base64 in {key!r}")
                return decode(raw), class_name
        raise _HTTPError(400, "need 'image_b64' (image file) or "
                              "'npy_b64' (preprocessed array)")

    # -- response encoding ---------------------------------------------
    def _result_json(self, amap: np.ndarray, score: float,
                     image: np.ndarray, map_mode: str) -> dict:
        out = {"score": float(score)}
        if map_mode == "npy":
            out["map"] = {"b64": _b64_npy(amap), "encoding": "npy",
                          "shape": list(amap.shape), "dtype": "float32"}
        elif map_mode == "png":
            out["map"] = {"b64": _png_overlay(self.server.denormalize(image),
                                              np.asarray(amap)),
                          "encoding": "png"}
        elif map_mode != "none":
            raise _HTTPError(400, f"map must be npy|png|none, got {map_mode!r}")
        return out

    def _await(self, fut, timeout=None):
        """A future of the service -> (map, score), or an HTTP error:
        unknown class 404, timeout 504, closed service 503."""
        try:
            return fut.result(timeout=self.server.request_timeout
                              if timeout is None else timeout)
        except KeyError as exc:
            raise _HTTPError(404, str(exc.args[0]) if exc.args else str(exc))
        except (TimeoutError, futures.TimeoutError):
            raise _HTTPError(504, "prediction timed out")
        except RuntimeError as exc:
            raise _HTTPError(503, str(exc))

    # -- endpoints -----------------------------------------------------
    def do_GET(self):
        path = urlsplit(self.path).path.rstrip("/")
        if path == "/v1/health":
            self._send_json({"status": "ok", **self.server.meta})
        elif path == "/v1/classes":
            self._send_json({"classes": self.server.meta["classes"]})
        else:
            self._send_json({"error": f"no such endpoint: {path}"}, 404,
                            close=True)

    def do_POST(self):
        split = urlsplit(self.path)
        path = split.path.rstrip("/")
        query = {k: v[-1] for k, v in parse_qs(split.query).items()}
        map_mode = query.get("map", "npy")
        try:
            if path == "/v1/predict":
                self._predict_one(query, map_mode)
            elif path == "/v1/predict_batch":
                self._predict_batch(map_mode)
            else:
                raise _HTTPError(404, f"no such endpoint: {path}")
        except _HTTPError as exc:
            self._send_json({"error": str(exc)}, exc.status, close=True)
        except Exception as exc:    # never end the handler thread
            logger.exception("unhandled error")
            self._send_json({"error": f"internal error: {exc}"}, 500,
                            close=True)

    def _predict_one(self, query, map_mode):
        body = self._read_body()
        ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
        if ctype == "application/json":
            try:
                entry = json.loads(body)
            except Exception as exc:
                raise _HTTPError(400, f"invalid JSON: {exc}")
            image, class_name = self._parse_one(entry)
        else:
            class_name = (query.get("class_name")
                          or self.headers.get("X-Class-Name"))
            if not class_name:
                raise _HTTPError(400, "class via ?class_name= or X-Class-Name")
            image = self._decode_npy_image(body)
        amap, score = self._await(self.server.service.submit(image, class_name))
        self._send_json(self._result_json(amap, score, image, map_mode))

    def _predict_batch(self, map_mode):
        try:
            payload = json.loads(self._read_body())
        except Exception as exc:
            raise _HTTPError(400, f"invalid JSON: {exc}")
        requests = payload.get("requests") if isinstance(payload, dict) else None
        if not isinstance(requests, list) or not requests:
            raise _HTTPError(400, "body must be {'requests': [non-empty list]}")
        decoded = [self._parse_one(e) for e in requests]
        # Submit all before waiting on any, so that the list lands in one
        # window of the service.
        futs = [self.server.service.submit(img, cls) for img, cls in decoded]
        # One deadline for the whole list, not one timeout per item.
        deadline = time.monotonic() + self.server.request_timeout
        results = []
        for fut, (img, _) in zip(futs, decoded):
            try:
                amap, score = self._await(
                    fut, timeout=max(0.0, deadline - time.monotonic()))
                results.append(self._result_json(amap, score, img, map_mode))
            except _HTTPError as exc:   # this item fails, the list goes on
                results.append({"error": str(exc), "status": exc.status})
        self._send_json({"results": results})


class _Server(ThreadingHTTPServer):
    # Clients that connect at once wait in the listen backlog rather than
    # in TCP's connection retries (the socketserver default holds 5).
    request_queue_size = 128


def make_server(service, img_size: int, meta: dict, host: str = "127.0.0.1",
                port: int = 0, request_timeout: float = 600.0,
                denormalize=None) -> ThreadingHTTPServer:
    """Build (without starting) the HTTP server. ``service`` has the
    micro-batcher's ``submit(image, class_name) -> Future``; ``meta`` is
    what /v1/health reports and must hold 'classes'."""
    server = _Server((host, port), PredictHandler)
    server.service = service
    server.img_size = img_size
    server.meta = dict(meta, img_size=img_size)
    server.request_timeout = request_timeout
    if denormalize is None:
        from ..data.datasets import _MEAN, _STD

        def denormalize(image):
            return image * _STD + _MEAN

    server.denormalize = denormalize
    return server


def serve_forever_in_thread(server) -> threading.Thread:
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def build_parser():
    parser = argparse.ArgumentParser(description="HTTP anomaly-detection server")
    src = parser.add_argument_group("model source (exported OR checkpoint)")
    src.add_argument("--exported", type=str, default=None,
                     help="torch.export artifact dir (tools/export_model.py); "
                     "mutually exclusive with --save_path")
    src.add_argument("--save_path", type=str, default=None,
                     help="cli.train checkpoint dir (omit for zero-shot)")
    src.add_argument("--dataset", type=str, default="MVTec",
                     help="class vocabulary and prompts")
    src.add_argument("--model_name", type=str, default="ViT-L-14-336")
    src.add_argument("--img_size", type=int, default=518)
    src.add_argument("--backbone", type=str, default=None,
                     help="OpenAI .pt checkpoint or converted .npz")
    src.add_argument("--random_backbone", action="store_true")
    src.add_argument("--quantize_backbone", type=str, default=None,
                     choices=["int8", "int8_attn", "int8_mlp", "int8+smooth",
                              "int8_attn+smooth", "int8_mlp+smooth"],
                     help="int8 backbone tier (ops/quant.py)")
    src.add_argument("--no_pallas", action="store_true",
                     help="serve the checkpoint on the stock PyTorch route (SDPA "
                     "and the cuBLAS chain) instead of the kernels; an --exported "
                     "program keeps the route it was exported with")
    src.add_argument("--compute_dtype", type=str, default="bfloat16",
                     choices=["bfloat16", "float32"])
    src.add_argument("--device", type=str, default=default_device(),
                     help="cuda, or cpu (AACLIP_PLATFORM=cpu sets cpu); with --exported it must be of the type "
                     "the artifacts were exported for")
    net = parser.add_argument_group("server")
    net.add_argument("--host", type=str, default="127.0.0.1")
    net.add_argument("--port", type=int, default=8000)
    net.add_argument("--max_batch", type=int, default=32)
    net.add_argument("--max_latency_ms", type=float, default=5.0)
    net.add_argument("--request_timeout_s", type=float, default=600.0,
                     help="how long a request waits for its prediction")
    net.add_argument("--warmup", action="store_true",
                     help="run one single-image request before listening")
    return parser


def load_model(args):
    """The model source the parsed ``args`` name: (predictor, the /v1/health
    metadata, img_size). ``--exported`` gives an
    :class:`..serving.ExportedPredictor`, else an
    :class:`..serving.AnomalyDetector` from the backbone and save path."""
    import torch

    from ..serving import AnomalyDetector, ExportedPredictor

    if args.exported:
        det = ExportedPredictor(args.exported, device=args.device)
        meta = {"source": "exported", "dataset": det.manifest["dataset"],
                "classes": det.class_names(),
                "batch_sizes": det.manifest["batch_sizes"]}
        img_size = det.img_size
    else:
        dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
        det = AnomalyDetector.from_checkpoint(
            args.save_path, args.dataset, img_size=args.img_size,
            backbone=args.backbone, allow_random_backbone=args.random_backbone,
            model_name=args.model_name, compute_dtype=dtype,
            device=args.device, quantize=args.quantize_backbone,
            use_pallas=not args.no_pallas)
        meta = {"source": "checkpoint", "dataset": args.dataset,
                "classes": det.class_names(),
                "checkpoint": args.save_path or "(zero-shot)"}
        img_size = args.img_size
    return det, meta, img_size


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..serving import MicroBatchingService

    if args.exported and args.save_path:
        parser.error("--exported and --save_path are mutually exclusive")
    det, meta, img_size = load_model(args)
    if args.warmup:
        det.predict(np.zeros((1, 3, img_size, img_size), np.float32),
                    meta["classes"][0])
        logger.info("warmup done")

    svc = MicroBatchingService(det, max_batch=args.max_batch,
                               max_latency_ms=args.max_latency_ms)
    server = make_server(svc, img_size, meta, host=args.host,
                         port=args.port, request_timeout=args.request_timeout_s)
    logger.info("serving %s on http://%s:%d (classes: %s)",
                meta["dataset"], *server.server_address, len(meta["classes"]))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


if __name__ == "__main__":
    main()
