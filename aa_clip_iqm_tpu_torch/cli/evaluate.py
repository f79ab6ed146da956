#!/usr/bin/env python
"""Batch evaluation CLI: sweeps every class of a dataset and prints the
AUROC / AP table.

    python -m aa_clip_iqm_tpu_torch.cli.evaluate --dataset MVTec \\
        --random_backbone --no_adapters [--quantize_backbone int8]

Counterpart of ``aa_clip_iqm_tpu/cli/evaluate.py``. It runs on ``cuda``
unless ``--device cpu`` is given. Restoring trained adapters from a
checkpoint, visualization, reference-checkpoint import, data-parallel
evaluation and profiling are not ported yet.
"""
import argparse

import torch

from ..configs import EvalConfig
from ..data.datasets import get_dataset
from ..evaluation.predict import evaluate_dataset, results_table
from ..loader import build_model_config, init_trainable, load_frozen_backbone
from ..ops.quant import quantize_backbone_auto
from ..prompts import compute_frozen_anchors
from ..utils.misc import setup_logger, setup_seed

TIERS = ["int8", "int8_attn", "int8_mlp", "int8+smooth", "int8_attn+smooth",
         "int8_mlp+smooth"]


def build_parser():
    parser = argparse.ArgumentParser(description="Evaluation")
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--backbone", type=str, default=None,
                        help="converted .npz weight cache")
    parser.add_argument("--random_backbone", action="store_true")
    parser.add_argument("--dataset", type=str, default="MVTec")
    parser.add_argument("--image_batch_size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--save_path", type=str, default="ckpt/baseline")
    parser.add_argument("--metadata_root", type=str, default=None)
    parser.add_argument("--iqm_weight", type=float, default=0.4)
    parser.add_argument("--text_weight", type=float, default=0.6)
    parser.add_argument("--image_score_mode", type=str, default="fixed",
                        choices=["fixed", "reference_eval"],
                        help="image-level score semantics: 'fixed' = "
                        "per-sample abnormal logit; 'reference_eval' = exact "
                        "transcription of the reference's executed eval path "
                        "(depends on the batch's composition) for parity "
                        "studies")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--no_adapters", action="store_true",
                        help="evaluate without any trained checkpoint "
                        "(zero-shot plumbing check)")
    parser.add_argument("--quantize_backbone", type=str, default=None,
                        choices=TIERS,
                        help="int8 frozen-backbone inference tier; "
                        "'int8_attn' quantizes only the attention "
                        "projections and keeps the fused float MLP kernel, "
                        "'int8_mlp' only the MLP (fused int8 kernel)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.no_adapters:
        raise NotImplementedError(
            "restoring trained adapters from --save_path "
            "(train/checkpoint.restore_adapters) is not ported yet; pass "
            "--no_adapters to evaluate with untrained adapters")
    setup_seed(args.seed)
    logger = setup_logger(args.save_path, "test.log")
    logger.info("args: %s", vars(args))

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.compute_dtype]
    model_cfg = build_model_config(model_name=args.model_name,
                                   img_size=args.img_size)
    frozen = load_frozen_backbone(model_cfg, args.backbone,
                                  allow_random=args.random_backbone,
                                  device=args.device, dtype=dtype)
    trainable = init_trainable(model_cfg, seed=args.seed, device=args.device,
                               dtype=dtype)
    if args.quantize_backbone:
        frozen = quantize_backbone_auto(frozen, args.quantize_backbone,
                                        cfg=model_cfg)
        logger.info("frozen backbone quantized (tier=%s)",
                    args.quantize_backbone)

    anchors = compute_frozen_anchors(frozen, trainable, model_cfg,
                                     args.dataset, adapted=False,
                                     compute_dtype=dtype)
    datasets = get_dataset(args.dataset, args.img_size, "test", logger=logger,
                           metadata_root=args.metadata_root,
                           device_normalize=True)
    eval_cfg = EvalConfig(
        dataset=args.dataset, img_size=args.img_size,
        batch_size=args.image_batch_size, seed=args.seed,
        save_path=args.save_path, iqm_weight=args.iqm_weight,
        text_weight=args.text_weight, compute_dtype=args.compute_dtype,
        image_score_mode=args.image_score_mode)
    rows = evaluate_dataset(frozen, trainable, model_cfg, eval_cfg, datasets,
                            anchors, logger=logger, compute_dtype=dtype)
    table = results_table(rows)
    logger.info("final results:\n%s", table)
    print(table)
    return rows


if __name__ == "__main__":
    main()
