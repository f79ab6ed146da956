"""Offline scoring: a closed loop of one caller around
``AnomalyDetector.predict_multi``.

Each call scores ``batch`` uint8 host frames, each against a class drawn
uniformly from the dataset's, and returns float32 maps and scores to the
host. The detector has one bucket, the batch, so set-up captures that one
CUDA graph. A pool of ``pool`` distinct seeded batches is cycled. The window
runs calls until ``--seconds`` have passed; images/s is every image of the
calls made over the time they took.

The comparison: for one row of each call (drawn from the seed) the map and
score are kept; after the window a sample of ``sample`` of them (drawn from
the seed) is held to the reference's, on the same images and classes, with
the reference's own anchors and its own resized positional embedding.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers import common


class Driver:
    def __init__(self, run):
        self.run = run
        self.wl = run.workload
        self.kept = []

    def detector(self, frozen, trainable, mc, buckets):
        from aa_clip_iqm_tpu_torch.serving import AnomalyDetector

        cfg = self.run.config
        return AnomalyDetector(frozen, trainable, mc, cfg["dataset"], img_size=cfg["img_size"],
                               adapted_text=True, compute_dtype=common.DTYPES[cfg["compute_dtype"]],
                               text_weight=cfg["fusion"]["text_weight"],
                               iqm_weight=cfg["fusion"]["iqm_weight"], batch_buckets=buckets,
                               quantize=self.wl.get("quantize"), device=self.run.device,
                               use_pallas=cfg["use_pallas"])

    def setup(self):
        run, cfg, wl = self.run, self.run.config, self.wl
        common.build_kernels(run)
        mc, self.frozen, self.trainable = common.weights(run, common.DTYPES[cfg["compute_dtype"]])
        grid = cfg["img_size"] // cfg["patch_size"]
        self.det = self.detector(common.program_frozen(self.frozen, grid), self.trainable, mc,
                                 (wl["batch"],))
        self.classes = self.det.class_names()
        self.prog_anchors = {c: a.float().clone() for c, a in self.det.anchors.items()}
        gen = inputs.generator(run.seed + 2, run.device)
        b, size = wl["batch"], cfg["img_size"]
        self.pool = [inputs.images_u8(gen, b, size, run.device).cpu().numpy()
                     for _ in range(wl["pool"])]
        picks = torch.randint(len(self.classes), (wl["pool"], b), generator=gen,
                              device=run.device).tolist()
        self.names = [[self.classes[i] for i in row] for row in picks]
        self.rng = np.random.default_rng(run.seed)
        for k in range(min(2, wl["pool"])):     # the capture, then a replay
            self.det.predict_multi(self.pool[k], self.names[k])
        stats = self.det.graph_stats()
        run.log(f"graphs {stats}; pool {self.det.graph_memory()} bytes; "
                f"allocated {torch.cuda.memory_allocated() if run.device.type == 'cuda' else 0}")
        self.replays0 = sum(s["replays"] for s in stats)

    def window(self, seconds):
        b, n = self.wl["batch"], 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            k = n % len(self.pool)
            with self.run.span("predict_multi"):
                maps, scores = self.det.predict_multi(self.pool[k], self.names[k])
            r = int(self.rng.integers(b))
            self.kept.append((k, r, maps[r].copy(), float(scores[r])))
            n += 1
            if time.perf_counter() >= deadline:
                break
        elapsed = time.perf_counter() - t0
        return {"attempted": n * b, "failed": 0,
                "metrics": {"images_per_s": n * b / elapsed},
                "work": {"images": n * b, "calls": n, "batch": b, "seconds": elapsed}}

    def counters(self):
        stats = self.det.graph_stats()
        return {"replays": sum(s["replays"] for s in stats) - self.replays0,
                "graph_pool_bytes": self.det.graph_memory(),
                "capture_s": [s["capture_s"] for s in stats]}

    def release(self):
        self.det = None

    def readings(self):
        """The numbers the comparison can hold (``common.compare_maps``) for
        a sample of the kept rows drawn from the seed."""
        rng = np.random.default_rng(self.run.seed + 3)
        pick = sorted(rng.choice(len(self.kept), min(self.wl["sample"], len(self.kept)),
                                 replace=False).tolist())
        part = [self.kept[i] for i in pick]
        with torch.no_grad():
            return common.compare_maps(
                self.run, self.frozen, self.trainable, self.prog_anchors,
                [torch.from_numpy(self.pool[k][r]) for k, r, _, _ in part],
                [self.names[k][r] for k, r, _, _ in part],
                [m for _, _, m, _ in part], [s for *_, s in part])

    def check(self):
        r = self.readings()
        return [(k, r[k], lim) for k, lim in self.wl["limits"].items()]
