"""What the drivers share: the program's model configuration checked against
the configuration file, the weights, the kernels' build, and the
comparisons' arithmetic."""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import inputs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(cfg: dict, img_size=None):
    """The program's ``ModelConfig`` for the configuration file, checked
    against every size the file states."""
    from aa_clip_iqm_tpu_torch.loader import build_model_config

    a = cfg["adapter"]
    mc = build_model_config(cfg["model_name"], img_size=img_size or cfg["img_size"],
                            relu=a["relu"], text_adapt_weight=a["text_adapt_weight"],
                            image_adapt_weight=a["image_adapt_weight"],
                            text_adapt_until=a["text_adapt_until"],
                            image_adapt_until=a["image_adapt_until"], levels=a["levels"],
                            iqm_hidden_size=cfg["iqm"]["hidden_size"],
                            iqm_num_layers=cfg["iqm"]["num_hidden_layers"],
                            iqm_num_heads=cfg["iqm"]["num_attention_heads"])
    v, t, q = mc.clip.vision, mc.clip.text, mc.iqm
    stated = {
        "patch_size": (v.patch_size, cfg["patch_size"]),
        "embed_dim": (mc.clip.embed_dim, cfg["embed_dim"]),
        "act": (mc.clip.act, cfg["act"]),
        "vision.width": (v.width, cfg["vision"]["width"]),
        "vision.layers": (v.layers, cfg["vision"]["layers"]),
        "vision.head_width": (v.head_width, cfg["vision"]["head_width"]),
        "vision.mlp_ratio": (v.mlp_ratio, cfg["vision"]["mlp_ratio"]),
        "text.width": (t.width, cfg["text"]["width"]),
        "text.layers": (t.layers, cfg["text"]["layers"]),
        "text.heads": (t.heads, cfg["text"]["heads"]),
        "text.context_length": (t.context_length, cfg["text"]["context_length"]),
        "text.vocab_size": (t.vocab_size, cfg["text"]["vocab_size"]),
        "iqm.intermediate_size": (q.intermediate_size, cfg["iqm"]["intermediate_size"]),
        "iqm.layer_norm_eps": (q.layer_norm_eps, cfg["iqm"]["layer_norm_eps"]),
        "iqm.fuse": ([q.fuse_self, q.fuse_visual, q.fuse_text], cfg["iqm"]["fuse"]),
        "iqm.text_encoder_hidden_size": (q.text_encoder_hidden_size,
                                         cfg["iqm"]["text_encoder_hidden_size"]),
    }
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"the program's config differs from the file: {wrong}")
    return mc


def build_kernels(run) -> None:
    """Build the cell's kernels, all nvcc processes at once (the program
    would build each at its first launch)."""
    from aa_clip_iqm_tpu_torch.ops import _build

    if run.device.type != "cuda":
        return
    t0 = time.perf_counter()
    seconds = _build.build(run.workload["kernels"])
    run.log(f"kernel builds {seconds} (wall {time.perf_counter() - t0:.3f} s)")


def weights(run, trainable_dtype):
    """(frozen, trainable) made from the seed, in the program's layout;
    the vision tower's positional embedding at the native grid."""
    from aa_clip_iqm_tpu_torch.loader import init_trainable, random_backbone

    cfg = run.config
    native = model_config(cfg, cfg["native_image_size"])
    mc = model_config(cfg)
    frozen = inputs.fill(random_backbone(native, device="meta",
                                         dtype=DTYPES[cfg["compute_dtype"]]),
                         run.seed, run.device)
    trainable = inputs.fill(init_trainable(mc, device="meta", dtype=trainable_dtype),
                            run.seed + 1, run.device)
    run.log("weights made")
    return mc, frozen, trainable


def program_frozen(frozen, grid: int):
    """The frozen tree the program is given: the positional embedding
    resized by the program's own load-time resize."""
    from aa_clip_iqm_tpu_torch.models.clip import resize_pos_embed_np

    pos = frozen["visual"]["positional_embedding"]
    resized = resize_pos_embed_np(pos.cpu().numpy(), grid)
    visual = dict(frozen["visual"], positional_embedding=torch.from_numpy(
        np.ascontiguousarray(resized)).to(pos.device))
    return dict(frozen, visual=visual)


def map_errors(maps, ref_maps):
    """Per image, the RMS of the difference over the reference map's
    standard deviation."""
    d = (maps.double() - ref_maps.double()).flatten(1)
    r = ref_maps.double().flatten(1)
    return (d.pow(2).mean(1).sqrt() / r.std(1)).tolist()


def worst(values):
    return max(values) if values else math.inf


def compare_maps(run, frozen, trainable, prog_anchors, images, names, maps, scores):
    """The serving cells' readings. ``images``: uint8 (3, S, S) tensors as
    the model takes them, ``names`` their classes, ``maps`` and ``scores``
    what the program answered for them.

    The anchors are compared by themselves: ``anchor_err``, the worst
    class's relative (Frobenius) error of the program's (embed_dim, 2)
    anchors against the reference's text tower. The maps and scores are
    compared with the reference run on the program's anchors: with random
    weights the normal and abnormal anchors lie close together, so bf16
    rounding in the text tower alone moves the maps by tens of percent
    through them, which would hide every error of the vision path, the
    heads and the scoring.
    ``control="fp8_anchors"`` puts the reference's text tower on float8
    products in the program's place (the anchors' control).
    """
    from benchmark.reference import model as ref

    cfg, wl, dev = run.config, run.workload, run.device
    ref_anchors = ref.text_anchors(frozen, trainable, cfg, dev)
    if wl.get("control") == "fp8_anchors":
        prog_anchors = ref.text_anchors(frozen, trainable, cfg, dev, mm=ref.fp8_matmul)
    grid = cfg["img_size"] // cfg["patch_size"]
    pos = ref.resize_pos_embed(frozen["visual"]["positional_embedding"].float(), grid)
    errs, score_errs = [], []
    chunk = wl["reference_chunk"]
    for at in range(0, len(images), chunk):
        imgs = torch.stack(images[at:at + chunk]).to(dev)
        part = names[at:at + chunk]
        got = torch.from_numpy(np.stack(maps[at:at + chunk])).to(dev)
        anc = torch.stack([prog_anchors[c].float().to(dev) for c in part])
        rmaps, rscores = ref.predict(frozen, trainable, cfg, imgs, anc, pos,
                                     wl["reference_head_chunk"])
        errs += map_errors(got, rmaps)
        score_errs += (torch.tensor(scores[at:at + chunk], dtype=torch.float64)
                       - rscores.double().cpu()).abs().tolist()
    out = {"anchor_err": max(float((prog_anchors[c].double().to(r.device) - r.double()).norm()
                                   / r.double().norm()) for c, r in ref_anchors.items()),
           "map_rel_rms": worst(errs), "score_abs": worst(score_errs)}
    return out
