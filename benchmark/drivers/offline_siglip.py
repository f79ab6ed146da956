"""Offline scoring on SigLIP So400m/14: ``offline``'s closed loop of one
caller around ``AnomalyDetector.predict_multi``, to the letter, held to
SigLIP's reference (``reference/siglip.py``) in place of CLIP's.

The comparison is ``offline.Driver.readings``' (``common.compare_maps``)
with SigLIP's towers, text anchors and positional-embedding resize where
``reference/model.py`` looks them up (``siglip.in_clips_place``).
``control="fp8_reference"`` (``tools/readings.py --variant fp8_reference``)
first puts the maps and scores of the reference whose vision tower and
adapters multiply on float8 products in the program's place, for the rows
that the comparison samples: the control of the bf16 configuration.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.drivers import common, offline
from benchmark.reference import model as ref
from benchmark.reference import siglip


def program_frozen(frozen, grid: int):
    """``common.program_frozen`` for a tower without a class row: every row
    of the table resized as the grid's, by the program's own load-time
    resize."""
    from aa_clip_iqm_tpu_torch.models.clip import resize_pos_embed_np

    pos = frozen["visual"]["positional_embedding"]
    resized = resize_pos_embed_np(pos.cpu().numpy(), grid, class_token=False)
    visual = dict(frozen["visual"], positional_embedding=torch.from_numpy(
        np.ascontiguousarray(resized)).to(pos.device))
    return dict(frozen, visual=visual)


class Driver(offline.Driver):
    def setup(self):
        """``offline.Driver.setup``, after the program has built the
        configuration (a program without the model stops at once, before any
        kernel build is started), with :func:`program_frozen` in
        ``common.program_frozen``'s place."""
        common.model_config(self.run.config)
        saved = common.program_frozen
        common.program_frozen = program_frozen
        try:
            super().setup()
        finally:
            common.program_frozen = saved

    def _fp8_in_the_program_s_place(self):
        """The sampled rows' maps and scores (``offline.Driver.readings``'
        draw) replaced by the reference's on float8 products, on the
        program's anchors."""
        cfg, wl, dev = self.run.config, self.wl, self.run.device
        rng = np.random.default_rng(self.run.seed + 3)
        pick = rng.choice(len(self.kept), min(wl["sample"], len(self.kept)), replace=False)
        grid = cfg["img_size"] // cfg["patch_size"]
        pos = siglip.resize_pos_embed(self.frozen["visual"]["positional_embedding"].float(), grid)
        with siglip.in_clips_place(functools.partial(siglip.vision, mm=ref.fp8_matmul)):
            for i in pick.tolist():
                k, r, _, _ = self.kept[i]
                anc = self.prog_anchors[self.names[k][r]].float().to(dev)[None]
                image = torch.from_numpy(self.pool[k][r])[None].to(dev)
                m, s = ref.predict(self.frozen, self.trainable, cfg, image, anc, pos,
                                   wl["reference_head_chunk"])
                self.kept[i] = (k, r, m[0].cpu().numpy(), float(s[0]))

    def readings(self):
        """``offline.Driver.readings`` with SigLIP's reference."""
        with torch.no_grad(), siglip.in_clips_place():
            if self.wl.get("control") == "fp8_reference":
                self._fp8_in_the_program_s_place()
            return super().readings()
