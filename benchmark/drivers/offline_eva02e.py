"""Offline scoring on EVA02-CLIP-E/14+: ``offline``'s closed loop of one
caller around ``AnomalyDetector.predict_multi``, to the letter, held to the
post-norm EVA reference (``reference/eva02e.py``) in place of CLIP's.

The comparison is ``common.compare_maps``'s, with the post-norm tower where
``reference/model.predict`` looks its tower up (``eva02e.in_clips_place``):
the anchors against the reference's text tower (OpenCLIP bigG's, the
model's own), the kept maps and scores against the reference run on the
program's anchors. ``control="fp8_reference"`` (``tools/readings.py
--variant fp8_reference``) puts the maps and scores of the reference whose
vision tower and adapters multiply on float8 products in the program's
place: the control of the bf16 configuration, which has no int8 tier.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.drivers import common, offline
from benchmark.reference import eva02e
from benchmark.reference import model as ref


class Driver(offline.Driver):
    def setup(self):
        """``offline.Driver.setup``, after the program has built the
        configuration: a program without the model stops at once, before any
        kernel build is started."""
        common.model_config(self.run.config)
        super().setup()

    def _fp8_answers(self, images, names):
        """The reference's maps and scores with the tower on float8
        products, on the program's anchors."""
        cfg, wl, dev = self.run.config, self.wl, self.run.device
        grid = cfg["img_size"] // cfg["patch_size"]
        pos = ref.resize_pos_embed(self.frozen["visual"]["positional_embedding"].float(), grid)
        maps, scores = [], []
        with eva02e.in_clips_place(functools.partial(eva02e.vision, mm=ref.fp8_matmul)):
            for at in range(0, len(images), wl["reference_chunk"]):
                part = names[at:at + wl["reference_chunk"]]
                anc = torch.stack([self.prog_anchors[c].float().to(dev) for c in part])
                m, s = ref.predict(self.frozen, self.trainable, cfg,
                                   torch.stack(images[at:at + len(part)]).to(dev), anc, pos,
                                   wl["reference_head_chunk"])
                maps += list(m.cpu().numpy())
                scores += s.cpu().tolist()
        return maps, scores

    def readings(self):
        """``offline.Driver.readings``' sample of the kept rows, compared
        with the post-norm EVA reference."""
        rng = np.random.default_rng(self.run.seed + 3)
        pick = sorted(rng.choice(len(self.kept), min(self.wl["sample"], len(self.kept)),
                                 replace=False).tolist())
        part = [self.kept[i] for i in pick]
        images = [torch.from_numpy(self.pool[k][r]) for k, r, _, _ in part]
        names = [self.names[k][r] for k, r, _, _ in part]
        maps, scores = [m for _, _, m, _ in part], [s for *_, s in part]
        with torch.no_grad():
            if self.wl.get("control") == "fp8_reference":
                maps, scores = self._fp8_answers(images, names)
            with eva02e.in_clips_place():
                return common.compare_maps(self.run, self.frozen, self.trainable,
                                           self.prog_anchors, images, names, maps, scores)
