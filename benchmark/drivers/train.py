"""Stage-2 adaptation as ``cli.train`` runs it on the card: the program's
``train.steps.make_stage2_step`` replayed by ``train.graphs.GraphedStep``,
with the graphable AdamW of ``train.optim.stage2_optimizer``, float32 master
adapters and bf16 compute.

The input is a device-resident pool of ``pool`` seeded batches, cycled:
normalized images (half with a darkened elliptical defect), their masks,
labels (defect or not), per-class unit anchors made here (stage 2 takes its
anchors as frozen inputs) and unit weights. Set-up makes one step object
with its optimizer and drives it through its first three steps on the
pool's first three batches, through the window's own call (the first call
captures the graph); the window goes on from there. train_images_per_s is
the images of every step the window ran over the time they took, at most
two steps in flight.

The comparison: the reference (``benchmark/reference/train.py``) takes the
same three steps from the same initial adapters. Compared: each step's loss;
the first gradient as the optimizer holds it after one step (AdamW's first
moment over 1 - beta1), by the worst leaf; and the change of each trained
leaf after the three steps, by the worst leaf among those whose reference
gradient is over a thousandth of the median leaf's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.drivers import common
from benchmark.reference import train as ref_train
from benchmark.reference import model as ref

BETA1 = 0.9


def _norms(named):
    return {p: float(t.double().norm()) for p, t in named.items()}


def worst_leaf(prog: dict, refn: dict, paths) -> float:
    """max over ``paths`` of |prog - ref| / max(ref, the median leaf's
    ref)."""
    paths = list(paths)
    med = float(np.median([refn[p] for p in paths]))
    return max(abs(prog[p] - refn[p]) / max(refn[p], med) for p in paths)


class Driver:
    def __init__(self, run):
        self.run = run
        self.wl = run.workload

    def setup(self):
        from aa_clip_iqm_tpu_torch.configs import TrainConfig
        from aa_clip_iqm_tpu_torch.train import graphs, optim, steps

        run, cfg, wl = self.run, self.run.config, self.wl
        dev, t = run.device, cfg["train"]
        common.build_kernels(run)
        mc, self.frozen, trainable = common.weights(run, common.DTYPES[cfg["master_dtype"]])
        for leaf in ref_train.leaves(trainable):
            leaf[1].requires_grad_(True)
        self.trainable = trainable
        self.start = {p: x.detach().clone() for p, x in ref_train.leaves(trainable)}
        grid = cfg["img_size"] // cfg["patch_size"]
        prog_frozen = common.program_frozen(self.frozen, grid)
        if wl.get("quantize"):
            # The program's int8 tier of the frozen backbone, a control.
            from aa_clip_iqm_tpu_torch.ops.quant import quantize_backbone_auto

            prog_frozen = quantize_backbone_auto(prog_frozen, wl["quantize"], cfg=mc)
        train_cfg = TrainConfig(dataset=cfg["dataset"], img_size=cfg["img_size"],
                                image_batch_size=wl["batch"], image_lr=t["image_lr"],
                                iqm_lr_scale=t["iqm_lr_scale"],
                                image_weight_decay=t["image_weight_decay"],
                                iqm_weight_decay=t["iqm_weight_decay"],
                                det_loss_weight=t["det_loss_weight"],
                                text_loss_weight=t["text_loss_weight"],
                                iqm_loss_weight=t["iqm_loss_weight"],
                                compute_dtype=cfg["compute_dtype"])
        graphed = graphs.enabled(dev)
        self.opt = optim.stage2_optimizer(trainable, t["image_lr"], t["total_steps"],
                                          iqm_lr_scale=t["iqm_lr_scale"],
                                          image_wd=t["image_weight_decay"],
                                          iqm_wd=t["iqm_weight_decay"], graphable=graphed)
        step = steps.make_stage2_step(mc, train_cfg,
                                      compute_dtype=common.DTYPES[cfg["compute_dtype"]])
        self.cache = graphs.GraphCache()
        self.step = graphs.GraphedStep(step, self.cache, "stage2 step") if graphed else step
        self.prog_frozen = prog_frozen
        self.batches = self._pool()

        # The first three steps, through the window's call; the graph's
        # capture in the first.
        self.losses = []
        for k in range(3):
            loss = self._call(k)
            self.losses.append(float(loss))
            if k == 0:
                state = self.opt.optimizer.state
                self.first_grad = {p: state[x]["exp_avg"].detach().double() / (1 - BETA1)
                                   for p, x in ref_train.leaves(trainable) if x in state}
        self.change = {p: (x.detach() - self.start[p]) for p, x in ref_train.leaves(trainable)
                       if p in self.first_grad}
        self.steps_done = 3
        run.log(f"first losses {self.losses}; graph pool {self.cache.memory()} bytes; "
                f"allocated {torch.cuda.memory_allocated() if dev.type == 'cuda' else 0}")

    def _pool(self):
        run, cfg, wl = self.run, self.run.config, self.wl
        dev, b, size = run.device, wl["batch"], cfg["img_size"]
        gen = inputs.generator(run.seed + 2, dev)
        n_cls = len(ref.prompts()["real_names"])
        anchors = torch.randn((n_cls, cfg["embed_dim"], 2), generator=gen, device=dev)
        anchors = anchors / anchors.norm(dim=1, keepdim=True)
        mean = torch.tensor(ref.prompts()["image_mean"], device=dev).reshape(1, 3, 1, 1)
        std = torch.tensor(ref.prompts()["image_std"], device=dev).reshape(1, 3, 1, 1)
        out = []
        for _ in range(wl["pool"]):
            u8 = inputs.images_u8(gen, b, size, dev).float()
            masks = inputs.blob_masks(gen, b, size, dev)
            img = u8 * (1 - 0.5 * masks)
            img = (img.round() / 255.0 - mean) / std
            labels = (masks.flatten(1).amax(1) > 0).long()
            cls = torch.randint(n_cls, (b,), generator=gen, device=dev)
            out.append((img, masks, labels, anchors[cls].contiguous(),
                        torch.ones(b, device=dev)))
        return out

    def _call(self, k):
        img, masks, labels, anchors, weights = self.batches[k % len(self.batches)]
        if self.wl.get("fault") == "half_batch":
            # A planted fault: the step sees the first half of the batch.
            h = img.shape[0] // 2
            img, masks, labels, anchors, weights = (t[:h] for t in (img, masks, labels,
                                                                    anchors, weights))
        with self.run.span("step"):
            _, _, loss = self.step(self.trainable, self.opt, self.prog_frozen, img, masks,
                                   labels, anchors, weights)
        return loss

    def window(self, seconds):
        b, n = self.wl["batch"], 0
        pending = []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            pending.append(self._call(self.steps_done + n))
            n += 1
            if len(pending) > 2:
                float(pending.pop(0))
            if time.perf_counter() >= deadline:
                break
        last = [float(x) for x in pending]
        elapsed = time.perf_counter() - t0
        self.steps_done += n
        self.run.log(f"{n} steps; last losses {last}")
        return {"attempted": n * b, "failed": 0,
                "metrics": {"train_images_per_s": n * b / elapsed},
                "work": {"images": n * b, "calls": n, "batch": b, "seconds": elapsed}}

    def counters(self):
        caps = getattr(self.step, "graphs", {})
        return {"replays": sum(c.replays for c in caps.values()),
                "capture_s": [c.capture_s for c in caps.values()],
                "graph_pool_bytes": self.cache.memory() if self.run.device.type == "cuda" else 0}

    def release(self):
        self.step = self.opt = self.cache = self.prog_frozen = None
        self.trainable = None

    def readings(self):
        """The reference's three steps and the numbers compared."""
        cfg = self.run.config
        start = _rebuild_like(self.start)
        grid = cfg["img_size"] // cfg["patch_size"]
        pos = ref.resize_pos_embed(self.frozen["visual"]["positional_embedding"].float(), grid)
        batches = [(img, m, lab, anc) for img, m, lab, anc, _ in self.batches[:3]]
        losses, grads, change = ref_train.steps(self.frozen, start, cfg, batches, pos)
        g_ref, d_ref = _norms(grads), _norms(change)
        g_prog, d_prog = _norms(self.first_grad), _norms(self.change)
        if self.wl.get("control") == "fp8_reference":
            # The control: the reference on float8 products in the
            # program's place.
            self.losses, grads8, change8 = ref_train.steps(
                self.frozen, _rebuild_like(self.start), cfg, batches, pos, mm=ref.fp8_matmul)
            g_prog, d_prog = _norms(grads8), _norms(change8)
        med = float(np.median(list(g_ref.values())))
        moving = [p for p in g_ref if g_ref[p] > 1e-3 * med]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(self.losses, losses))
        self.run.log(f"reference losses {losses}; program {self.losses}; "
                     f"{len(moving)} of {len(g_ref)} leaves move")
        return {"loss_rel": loss_rel, "grad_rel": worst_leaf(g_prog, g_ref, g_ref),
                "change_rel": worst_leaf(d_prog, d_ref, moving)}

    def check(self):
        r = self.readings()
        lim = self.wl["limits"]
        return [(k, r[k], lim[k]) for k in ("loss_rel", "grad_rel", "change_rel")]


def _rebuild_like(flat: dict):
    """{path: tensor} -> the nested dict / list tree of those paths."""
    root: dict = {}
    for path, t in flat.items():
        node, parts = root, path.split("/")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)
