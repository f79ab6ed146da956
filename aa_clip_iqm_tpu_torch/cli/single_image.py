#!/usr/bin/env python
"""Single-image anomaly-map CLI.

    python -m aa_clip_iqm_tpu_torch.cli.single_image --image_path a.png \\
        --class_name bottle --backbone ViT-L-14-336px.pt [--save_path ckpt/]

Counterpart of ``aa_clip_iqm_tpu/cli/single_image.py``. With a stage-2
checkpoint of ``cli.train`` under ``--save_path`` the adapted predict
program runs; without one, a zero-shot map comes from the surgery tower's
features against the frozen text anchors (stage 1's feature path), summed
over the levels. It writes the map as ``<out stem>.npy``, or with
``--visualize`` a JET overlay PNG to ``--out``. It runs on ``cuda`` unless
``--device cpu`` is given. ``--use_pallas`` is accepted and changes nothing:
the port always runs its kernels.
"""
import argparse
import os

import numpy as np
import torch

from ..data.datasets import _load_image, normalize_clip
from ..data.registry import DATASETS
from ..evaluation.predict import make_predict_fn
from ..evaluation.scoring import similarity_map_test
from ..loader import build_model_config, init_trainable, load_frozen_backbone
from ..models import adapters as adapters_mod
from ..platform import default_device
from ..prompts import compute_class_anchor
from ..train import checkpoint as ckpt
from ..train.steps import make_stage1_visual_fn
from ..utils.misc import setup_seed


def find_dataset_for_class(class_name):
    for ds, info in DATASETS.items():
        if class_name in info["classes"]:
            return ds
    return None


def build_parser():
    parser = argparse.ArgumentParser(description="Single image test")
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--image_path", type=str, required=True)
    parser.add_argument("--class_name", type=str, default="object",
                        help="object class for the prompt ensemble; 'object' "
                        "works generically")
    parser.add_argument("--dataset", type=str, default=None,
                        help="dataset whose prompt real-names to use; "
                        "inferred from --class_name when omitted")
    parser.add_argument("--save_path", type=str, default=None,
                        help="checkpoint dir; omit for zero-shot")
    parser.add_argument("--backbone", type=str, default=None,
                        help="OpenAI .pt checkpoint or converted .npz")
    parser.add_argument("--random_backbone", action="store_true")
    parser.add_argument("--visualize", action="store_true")
    parser.add_argument("--out", type=str, default="anomaly_map.png")
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--device", type=str, default=default_device(),
                        help="cuda (default) or cpu; AACLIP_PLATFORM=cpu sets cpu")
    parser.add_argument("--use_pallas", action="store_true",
                        help="accepted for the JAX CLI's flag surface: the port always runs its "
                        "kernels (JAX's default, without this flag, is its XLA route)")
    return parser


def main(argv=None):
    """Returns (anomaly map (H, W) float32, image score)."""
    args = build_parser().parse_args(argv)
    setup_seed(args.seed)
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
    device = args.device

    model_cfg = build_model_config(model_name=args.model_name,
                                   img_size=args.img_size)
    frozen = load_frozen_backbone(model_cfg, args.backbone,
                                  allow_random=args.random_backbone,
                                  device=device, dtype=dtype)
    trainable = init_trainable(model_cfg, seed=args.seed, device=device,
                               dtype=dtype)
    dataset = args.dataset or find_dataset_for_class(args.class_name)
    domain = DATASETS.get(dataset, {}).get("domain", "Industrial")
    img = normalize_clip(_load_image(args.image_path, args.img_size))
    images = torch.from_numpy(np.ascontiguousarray(img[None], np.float32)).to(device)

    use_ckpt = args.save_path and ckpt.latest_numbered_dir(args.save_path)
    if use_ckpt:
        trainable, adapted, _ = ckpt.restore_adapters(args.save_path, trainable)
    with torch.inference_mode():
        if use_ckpt:
            def encode(tokens):
                if adapted:
                    return adapters_mod.encode_text_adapted(
                        frozen, trainable, model_cfg, tokens, compute_dtype=dtype)
                return adapters_mod.encode_text_frozen(
                    frozen, model_cfg, tokens, compute_dtype=dtype)

            anchor = compute_class_anchor(encode, dataset or "MVTec",
                                          args.class_name, device=device)
            predict = make_predict_fn(model_cfg, args.img_size, domain,
                                      compute_dtype=dtype)
            final_map, logit = predict(frozen, trainable, images, anchor[None])
            score = float(logit[0])
        else:
            # Zero-shot: the surgery tower's patch features against the
            # frozen CLIP anchors.
            def encode(tokens):
                return adapters_mod.encode_text_frozen(frozen, model_cfg, tokens,
                                                       compute_dtype=dtype)

            anchor = compute_class_anchor(encode, dataset or "MVTec",
                                          args.class_name, device=device)
            feats = make_stage1_visual_fn(model_cfg, compute_dtype=dtype)(frozen, images)
            final_map = sum(similarity_map_test(f, anchor[None], args.img_size, domain)
                            for f in feats)
            score = float(final_map.max())

    final_map = final_map[0].float().cpu().numpy()
    print(f"image anomaly score: {score:.4f}")
    print(f"map range: [{final_map.min():.4f}, {final_map.max():.4f}]")

    if args.visualize:
        import cv2

        from ..evaluation.visualize import render_overlay

        orig = cv2.imread(args.image_path)
        orig = cv2.resize(orig, (args.img_size, args.img_size))
        cv2.imwrite(args.out, render_overlay(orig, final_map))
        print(f"saved visualization to {args.out}")
    else:
        path = os.path.splitext(args.out)[0] + ".npy"
        np.save(path, final_map)
        print(f"saved raw map to {path}")
    return final_map, score


if __name__ == "__main__":
    main()
