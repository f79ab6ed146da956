#!/usr/bin/env python
"""Export the anomaly-map predict program as deployable artifacts.

    python -m aa_clip_iqm_tpu_torch.tools.export_model --dataset MVTec \\
        --save_path ckpt/run1 --backbone ViT-L-14-336px.pt \\
        --out exported/mvtec --img_size 518 --batches 1 8 16

Counterpart of the JAX package's ``tools/export_model.py``, with its flags:
the whole scoring pipeline (adapted ViT forward, projections, IQM maps,
anchor similarity, blur and upsample, fusion) goes through
:func:`..serving.export_predictor`, one ``torch.export`` program per batch
bucket whose kernels are the ``aaclip::`` ops, with the per-class anchors
and, unless ``--baked``, the weights in ``weights.npz``. A deployment then
needs only :class:`..serving.ExportedPredictor` and the artifact directory
(``cli.serve --exported``).

It exports on ``cuda`` unless ``--device cpu`` is given: the programs hold
the device they were traced on, so export on the kind of device you serve
on. The JAX tool's ``--no_pallas`` has no counterpart (the card always runs
its kernels) and is refused as an unknown flag.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--save_path", type=str, default=None,
                   help="cli.train save dir (omit for zero-shot)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--model_name", type=str, default="ViT-L-14-336")
    p.add_argument("--backbone", type=str, default=None,
                   help="OpenAI .pt checkpoint or converted .npz")
    p.add_argument("--random_backbone", action="store_true")
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8, 16])
    p.add_argument("--quantize_backbone", type=str, default=None,
                   choices=("int8", "int8_attn", "int8_mlp"),
                   help="export the int8 backbone tier (ops/quant.py)")
    p.add_argument("--baked", action="store_true",
                   help="make the weights constants of the programs instead of "
                        "the default external weights.npz")
    p.add_argument("--check", action="store_true",
                   help="reload the artifacts and run one batch")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--compute_dtype", type=str, default="bfloat16",
                   choices=("bfloat16", "float32"))
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from ..serving import AnomalyDetector, ExportedPredictor, export_predictor

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
    det = AnomalyDetector.from_checkpoint(
        args.save_path, args.dataset, img_size=args.img_size,
        backbone=args.backbone, allow_random_backbone=args.random_backbone,
        model_name=args.model_name, compute_dtype=dtype, device=args.device,
        quantize=args.quantize_backbone)
    t0 = time.perf_counter()
    seconds = export_predictor(det, args.out, batch_sizes=tuple(args.batches),
                               weights="baked" if args.baked else "external")
    print(f"exported {sorted(args.batches)} -> {args.out} in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"b{b} {s:.1f} s" for b, s in seconds.items()) + ")")

    if args.check:
        pred = ExportedPredictor(args.out, device=args.device)
        cls = pred.class_names()[0]
        images = np.zeros((1, 3, args.img_size, args.img_size), np.float32)
        maps, scores = pred.predict(images, cls)
        assert maps.shape == (1, args.img_size, args.img_size)
        print(f"check OK: class={cls} map range "
              f"[{maps.min():.4f}, {maps.max():.4f}]")
    return seconds


if __name__ == "__main__":
    main()
