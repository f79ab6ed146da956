"""Serving under open-loop load: the program's HTTP server
(``cli.serve.make_server`` over ``serving.MicroBatchingService`` over the
detector with its default buckets) in this process on 127.0.0.1, and the
standard-library client ``benchmark/http_client.py`` in a process of its
own.

Each request is ``POST /v1/predict?map=npy`` with ``{"class_name",
"image_b64"}``: a PNG of a seeded image at its class's native MVTec AD
size, which the server decodes, resizes to the model's size and normalizes.
Classes are uniform. Arrivals are Poisson at the cell's fixed rate: the
gaps are the exponential's quantiles for that rate and window, in an order
drawn from the seed, so that every seed offers the same work. The bodies are
encoded in set-up. Set-up captures every bucket the service can use.

latency_p95_ms is the 95th percentile over every request due in the
window, from its due time to the last byte of its reply; a failed request
counts as missing (at the client's timeout). The comparison decodes the
sampled replies' maps and scores and holds them to the reference on the
same PNG bodies (decoded by ``benchmark/png.py``, resized by
``F.interpolate``).
"""
from __future__ import annotations

import base64
import io
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import inputs, png
from benchmark.drivers import common
from benchmark.drivers.offline import Driver as Offline

CLIENT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "http_client.py")


class _Traced:
    """The object it wraps, with the named methods' calls as harness spans."""

    def __init__(self, inner, run, names):
        self._inner, self._run, self._names = inner, run, names

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self._names:
            return attr

        def call(*args, **kwargs):
            with self._run.span(name):
                return attr(*args, **kwargs)

        return call


def schedule(rate: float, seconds: float, seed: int):
    """Due times: the n = round(rate * seconds) quantiles of the exponential
    gap for ``rate``, in an order drawn from ``seed``, summed."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng(seed).permutation(gaps)
    return np.cumsum(gaps) - gaps[0]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


class Driver(Offline):
    def setup(self):
        from aa_clip_iqm_tpu_torch.cli.serve import make_server, serve_forever_in_thread
        from aa_clip_iqm_tpu_torch.serving import MicroBatchingService

        run, cfg, wl = self.run, self.run.config, self.wl
        common.build_kernels(run)
        mc, self.frozen, self.trainable = common.weights(run, common.DTYPES[cfg["compute_dtype"]])
        grid, size = cfg["img_size"] // cfg["patch_size"], cfg["img_size"]
        self.det = self.detector(common.program_frozen(self.frozen, grid), self.trainable, mc,
                                 tuple(wl["buckets"]))
        self.classes = self.det.class_names()
        self.prog_anchors = {c: a.float().clone() for c, a in self.det.anchors.items()}
        warm = np.zeros((max(wl["buckets"]), 3, size, size), np.float32)
        for b in wl["buckets"]:          # the capture, then a replay, of each bucket
            for _ in range(2):
                self.det.predict_multi(warm[:b], [self.classes[0]] * b)
        self.replays0 = sum(s["replays"] for s in self.det.graph_stats())
        run.log(f"graphs {self.det.graph_stats()}; pool {self.det.graph_memory()} bytes")

        gen = inputs.generator(run.seed + 2, run.device)
        self.images, self.bodies, self.body_class = [], [], []
        for c in self.classes:
            side = wl["native_sizes"][c]
            for _ in range(wl["bodies_per_class"]):
                self.images.append(inputs.images_u8(gen, 1, side, run.device)[0]
                                   .permute(1, 2, 0).contiguous().cpu().numpy())
                self.body_class.append(c)
        with ThreadPoolExecutor(4) as pool:
            pngs = list(pool.map(png.encode, self.images))
        self.bodies = [json.dumps({"class_name": c, "image_b64": base64.b64encode(p).decode()})
                       .encode() for c, p in zip(self.body_class, pngs)]
        run.log(f"{len(self.bodies)} bodies, {np.mean([len(b) for b in self.bodies]):.0f} "
                "bytes on average")

        self.service = MicroBatchingService(_Traced(self.det, run, {"predict_multi"}),
                                            max_batch=wl["max_batch"],
                                            max_latency_ms=wl["max_latency_ms"])
        self.server = make_server(_Traced(self.service, run, {"submit"}), size,
                                  {"classes": self.classes, "dataset": cfg["dataset"]},
                                  host="127.0.0.1", port=0)
        self.thread = serve_forever_in_thread(self.server)
        # One request through the whole path, before the window.
        self._client([0.0], [0], [0], timeout=120)
        run.log("the first request answered")

    def _client(self, offsets, which, keep, timeout):
        spec = {"port": self.server.server_address[1], "offsets": list(map(float, offsets)),
                "bodies": list(map(int, which)), "keep": list(map(int, keep)),
                "threads": self.wl["client_threads"], "timeout": timeout}
        used = sorted(set(spec["bodies"]))
        index = {b: i for i, b in enumerate(used)}
        spec["bodies"] = [index[b] for b in spec["bodies"]]
        proc = subprocess.Popen([sys.executable, CLIENT], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE)
        head = io.BytesIO()
        head.write(json.dumps(spec).encode() + b"\n")
        head.write(f"{len(used)}\n".encode())
        for b in used:
            head.write(f"{len(self.bodies[b])}\n".encode())
            head.write(self.bodies[b])
        out, _ = proc.communicate(head.getvalue())
        if proc.returncode != 0:
            raise RuntimeError(f"the client exited with {proc.returncode}")
        return json.loads(out)

    def window(self, seconds):
        wl, seed = self.wl, self.run.seed
        rate = wl["rate"]
        offsets = schedule(rate, seconds, seed)
        rng = np.random.default_rng(seed + 4)
        per = wl["bodies_per_class"]
        cls = rng.permutation(np.arange(len(offsets)) % len(self.classes))
        which = cls * per + rng.integers(per, size=len(offsets))
        keep = sorted(rng.choice(len(offsets), min(wl["sample"], len(offsets)),
                                 replace=False).tolist())
        replays0 = sum(s["replays"] for s in self.det.graph_stats())
        t0 = time.perf_counter()
        with self.run.span("requests in flight"):
            got = self._client(offsets, which, keep, timeout=wl["timeout_s"])
        elapsed = time.perf_counter() - t0
        self.replays_window = sum(s["replays"] for s in self.det.graph_stats()) - replays0
        res = got["results"]
        lat = [r[2] if r[2] is not None else float(wl["timeout_s"]) for r in res]
        failed = sum(1 for r in res if r[2] is None)
        late = sorted(r[1] for r in res)
        self.answered = len(res) - failed
        self.run.log(f"offered {len(res)} at {rate}/s over {offsets[-1]:.3f} s; failed {failed}; "
                     f"p50 {percentile(lat, 50) * 1e3:.3f} ms, p95 {percentile(lat, 95) * 1e3:.3f} ms, "
                     f"max {max(lat) * 1e3:.3f} ms; the client late by p50 "
                     f"{percentile(late, 50) * 1e3:.3f} ms, p99 {percentile(late, 99) * 1e3:.3f} ms, "
                     f"max {late[-1] * 1e3:.3f} ms; device batches {self.replays_window}; "
                     f"call {elapsed:.3f} s")
        self.kept = [(i, int(which[i]), got["kept"].get(str(i))) for i in keep]
        self.latencies = lat
        return {"attempted": len(res), "failed": failed,
                "metrics": {"latency_p95_ms": percentile(lat, 95) * 1e3},
                "work": {"requests": len(res), "answered": self.answered,
                         "seconds": elapsed}}

    def counters(self):
        stats = self.det.graph_stats()
        return {"replays": self.replays_window, "answered": self.answered,
                "graphs": [[s["bucket"], s["replays"]] for s in stats],
                "graph_pool_bytes": self.det.graph_memory()}

    def release(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join()
        self.service.close()
        self.server = self.service = self.det = None

    def readings(self):
        """``common.compare_maps`` on the sampled replies, the reference
        decoding and resizing the PNG bodies that were sent; and the sampled
        requests that got no answer."""
        size = self.run.config["img_size"]
        missing, maps, scores, imgs, names = 0, [], [], [], []
        for _, body, reply in self.kept:
            if reply is None:
                missing += 1
                continue
            r = json.loads(reply)
            maps.append(np.load(io.BytesIO(base64.b64decode(r["map"]["b64"]))))
            scores.append(r["score"])
            sent = json.loads(self.bodies[body])
            rgb = torch.from_numpy(png.decode(base64.b64decode(sent["image_b64"])))
            imgs.append(F.interpolate(rgb.permute(2, 0, 1)[None].float(), size=(size, size),
                                      mode="bicubic", align_corners=False, antialias=True)[0]
                        .round().clamp(0, 255).to(torch.uint8))
            names.append(sent["class_name"])
        with torch.no_grad():
            out = common.compare_maps(self.run, self.frozen, self.trainable, self.prog_anchors,
                                      imgs, names, maps, scores)
        return dict(out, unanswered=missing)

    def check(self):
        r = self.readings()
        return [("unanswered", r["unanswered"], 0)] + [
            (k, r[k], lim) for k, lim in self.wl["limits"].items()]
