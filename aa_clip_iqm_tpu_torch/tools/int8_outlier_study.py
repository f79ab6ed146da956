#!/usr/bin/env python
"""Int8 outlier-robustness study: how each int8 tier's anomaly maps degrade
against the bf16 pipeline when a few channels run 20-100x the rest, with
and without the SmoothQuant-style ``+smooth`` mitigation (``ops/quant.py``).

    python -m aa_clip_iqm_tpu_torch.tools.int8_outlier_study --size flagship
    python -m aa_clip_iqm_tpu_torch.tools.int8_outlier_study --size tiny --device cpu

Counterpart of the JAX package's ``tools/int8_outlier_study.py``, with its
flags and its table. Outliers are injected into the LayerNorm gains (one
fixed channel set in every block's ln_1 and ln_2), so the qkv and c_fc
inputs, the tensors that the int8 tiers quantize per token, carry them.
Per (factor, tier): the anomaly map's Spearman rho against the float
pipeline on the same (outlier-injected) weights, the largest relative
image-score change, and the pixel-AUROC change against the synthetic masks.

``--size flagship`` is ViT-L-14-336 at 518 px in bf16 on the card (the
tiers' MLPs run B3, the fused int8 kernel); ``--size tiny`` the tiny test
model at 56 px in float32. It runs on ``cuda`` unless ``--device cpu`` is
given. As the JAX tool, it prints a ``FAILED`` or ``SKIPPED`` row for a tier
that cannot run and carries on; :func:`run_study` returns every row with
its error, so that a caller can require that none is one. ``--use_pallas``
is accepted and changes nothing: the port always runs its kernels.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..platform import default_device

TIERS = "int8,int8+smooth,int8_attn,int8_attn+smooth,int8_mlp,int8_mlp+smooth"


def make_images(n: int, size: int, seed: int):
    """An in-memory synthetic eval batch: textured images, the second half
    with painted blob defects and their masks. (images (n, 3, size, size)
    CLIP-normalized float32, masks (n, size, size) bool)."""
    from ..data.datasets import normalize_clip
    from ..data.synthetic import _texture, paint_defect

    rng = np.random.default_rng(seed)
    images, masks = [], []
    for i in range(n):
        img = _texture(rng, size, rng.uniform(60, 180, 3))
        mask = np.zeros((size, size), np.uint8)
        if i >= n // 2:
            img, mask = paint_defect(rng, img, size)
        chw = np.transpose(img, (2, 0, 1)).astype(np.float32) / 255.0
        images.append(normalize_clip(chw))
        masks.append(mask > 0)
    return np.stack(images), np.stack(masks)


def inject_ln_gain_outliers(frozen, channels, factor: float):
    """A copy of ``frozen`` whose ln_1 and ln_2 gains of every visual block
    have ``channels`` scaled by ``factor`` (the same channels in every
    layer); ``frozen`` itself when the factor is 1."""
    if factor == 1.0:
        return frozen
    idx = torch.as_tensor(np.asarray(channels, np.int64))

    def boost(ln):
        scale = ln["scale"].clone()
        scale[idx.to(scale.device)] *= factor
        return dict(ln, scale=scale)

    blocks = [dict(b, ln_1=boost(b["ln_1"]), ln_2=boost(b["ln_2"]))
              for b in frozen["visual"]["blocks"]]
    return dict(frozen, visual=dict(frozen["visual"], blocks=blocks))


def pixel_auroc(maps, masks) -> float:
    """Pixel AUROC by the rank-sum formula (NaN where one class is empty)."""
    from scipy import stats

    scores = np.asarray(maps, np.float32).ravel()
    labels = np.asarray(masks).ravel().astype(bool)
    n_pos, n_neg = labels.sum(), (~labels).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = stats.rankdata(scores)
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", choices=["tiny", "flagship"], default="tiny",
                   help="tiny: the tiny test model; flagship: ViT-L @518")
    p.add_argument("--factors", default="1,20,100",
                   help="comma list of LN-gain outlier factors (1 = control)")
    p.add_argument("--frac", type=float, default=0.002,
                   help="fraction of width channels made outliers (>=1 chan)")
    p.add_argument("--images", type=int, default=8)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="SmoothQuant migration strength")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for the JAX tool's flag surface: the port "
                   "always runs its kernels")
    p.add_argument("--tiers", default=TIERS,
                   help="comma list of quant tiers to measure")
    p.add_argument("--device", default=default_device(),
                   help="cuda (default) or cpu; AACLIP_PLATFORM=cpu sets cpu")
    return p


def run_study(size="tiny", factors=(1.0, 20.0, 100.0), frac=0.002, images=8,
              alpha=0.5, seed=0, tiers=tuple(TIERS.split(",")), device="cuda",
              out=print):
    """The study. Prints its table through ``out`` as it goes and returns
    its rows: dicts with ``factor``, ``tier`` and either ``rho``,
    ``score_maxrel`` and ``dauroc_pts`` or ``error`` ("FAILED: ..." or
    "SKIPPED: ...")."""
    from scipy import stats as sps

    from ..configs import tiny_test_config
    from ..evaluation.predict import make_predict_fn
    from ..loader import build_model_config, init_trainable, random_backbone
    from ..ops.quant import calibrate_ln_amax, quantize_backbone_tier

    if size == "flagship":
        img, cfg, dtype = 518, build_model_config(img_size=518), torch.bfloat16
    else:
        img, cfg, dtype = 56, tiny_test_config(56), torch.float32
    rng = np.random.default_rng(seed)
    frozen0 = random_backbone(cfg, seed=seed, device=device, dtype=dtype)
    trainable = init_trainable(cfg, seed=seed + 1, device=device, dtype=dtype)
    width = cfg.clip.vision.width
    channels = rng.choice(width, size=max(1, int(round(frac * width))), replace=False)
    out(f"# model={size} width={width} outlier_channels={sorted(channels.tolist())}")

    images_np, masks = make_images(images, img, seed + 7)
    batch = torch.from_numpy(images_np).to(device)
    anchors = rng.standard_normal((images, cfg.clip.embed_dim, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    anchors = torch.from_numpy(anchors).to(device)
    predict = make_predict_fn(cfg, img, "Industrial", compute_dtype=dtype)

    def run(frozen_x):
        maps, scores = predict(frozen_x, trainable, batch, anchors)
        return maps.cpu().numpy(), scores.cpu().numpy()

    need_stats = any(t.endswith("+smooth") for t in tiers)
    out(f"{'factor':>6} {'tier':>16} {'rho_vs_bf16':>11} {'score_maxrel':>12} "
        f"{'dAUROC_pts':>10}")
    rows = []
    for factor in factors:
        frozen = inject_ln_gain_outliers(frozen0, channels, factor)
        maps_ref, scores_ref = run(frozen)
        auroc_ref = pixel_auroc(maps_ref, masks)
        stats = None
        if need_stats:
            try:
                stats = calibrate_ln_amax(frozen["visual"], cfg.clip.vision, batch,
                                          act_name=cfg.clip.act, compute_dtype=dtype)
                ratio = float(np.max(stats["qkv"]) / max(np.median(stats["qkv"]), 1e-9))
                out(f"# factor={factor:g}: qkv-input amax max/median = {ratio:.1f}")
            except Exception as exc:  # noqa: BLE001 — the plain tiers still land
                out(f"# factor={factor:g}: calibration failed ({exc}); skipping ratio + "
                    "'+smooth' tiers")
        for tier in tiers:
            smooth = tier.endswith("+smooth")
            if smooth and stats is None:
                rows.append({"factor": factor, "tier": tier, "error": "SKIPPED: no calibration"})
                out(f"{factor:>6g} {tier:>16} SKIPPED: no calibration")
                continue
            try:
                q = quantize_backbone_tier(frozen, tier, smooth_stats=stats if smooth else None,
                                           smooth_alpha=alpha)
                maps_q, scores_q = run(q)
            except Exception as exc:  # noqa: BLE001 — keep the sweep's partial table
                rows.append({"factor": factor, "tier": tier, "error": f"FAILED: {exc}"})
                out(f"{factor:>6g} {tier:>16} FAILED: {exc}")
                continue
            rho = float(sps.spearmanr(maps_ref.ravel(), maps_q.ravel()).statistic)
            srel = float(np.max(np.abs(scores_q - scores_ref))
                         / max(np.max(np.abs(scores_ref)), 1e-9))
            dauc = (pixel_auroc(maps_q, masks) - auroc_ref) * 100
            rows.append({"factor": factor, "tier": tier, "rho": rho, "score_maxrel": srel,
                         "dauroc_pts": dauc})
            out(f"{factor:>6g} {tier:>16} {rho:>11.5f} {srel:>12.4f} {dauc:>+10.3f}")
    return rows


def main(argv=None):
    args = build_parser().parse_args(argv)
    run_study(size=args.size, factors=[float(f) for f in args.factors.split(",")],
              frac=args.frac, images=args.images, alpha=args.alpha, seed=args.seed,
              tiers=[t.strip() for t in args.tiers.split(",") if t.strip()],
              device=args.device, out=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
