#!/usr/bin/env python
"""Batch evaluation CLI: sweeps every class of a dataset and prints the
AUROC / AP table.

    python -m aa_clip_iqm_tpu_torch.cli.evaluate --dataset MVTec \\
        --random_backbone --save_path ckpt/baseline [--quantize_backbone int8]

Counterpart of ``aa_clip_iqm_tpu/cli/evaluate.py``. It runs on ``cuda``
unless ``--device cpu`` is given, and restores the adapters that
``cli.train`` left under ``--save_path`` (the stage-1 text adapter if there
is one, then the newest stage-2 checkpoint); ``--no_adapters`` evaluates
untrained adapters instead, and ``--import_reference`` reads the PyTorch
reference's ``text_adapter.pth`` / ``image_adapter_{N}.pth`` from
``--save_path``. ``--visualize`` writes heatmaps under
``<save_path>/visualization/``. ``--profile_dir`` writes a ``torch.profiler``
trace of the sweep there, and ``--debug_nans`` raises ``FloatingPointError``
at the first op that makes a NaN. ``--use_pallas`` is accepted and changes
nothing: the port always runs its kernels. ``--data_parallel`` under
``torchrun`` splits every batch over its ranks (``evaluate_dataset(mesh=)``):
each rank predicts its rows, the maps are gathered, and rank 0 logs and
prints the table, which is the single-process table. In one process without
``torchrun`` the flag changes nothing.
"""
import argparse
import os

import torch

from ..configs import EvalConfig
from ..data.datasets import get_dataset
from ..evaluation.predict import evaluate_dataset, results_table
from ..loader import build_model_config, init_trainable, load_frozen_backbone
from ..models.convert import import_reference_checkpoints
from ..ops.quant import quantize_backbone_auto
from ..parallel.multihost import data_parallel_mesh, is_primary
from ..platform import default_device
from ..prompts import compute_frozen_anchors
from ..train.checkpoint import restore_adapters
from ..utils.misc import quiet_logger, setup_logger, setup_seed
from ..utils.profiling import enable_nan_checks, trace

TIERS = ["int8", "int8_attn", "int8_mlp", "int8+smooth", "int8_attn+smooth",
         "int8_mlp+smooth"]


def build_parser():
    parser = argparse.ArgumentParser(description="Evaluation")
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--relu", action="store_true")
    parser.add_argument("--backbone", type=str, default=None,
                        help="OpenAI .pt checkpoint or converted .npz")
    parser.add_argument("--random_backbone", action="store_true")
    parser.add_argument("--dataset", type=str, default="MVTec")
    parser.add_argument("--batch_size", type=int, default=32,
                        help="accepted for reference-CLI compatibility; the "
                        "eval loader uses --image_batch_size (the reference's "
                        "test_last.py has the same pair and likewise only "
                        "uses image_batch_size)")
    parser.add_argument("--image_batch_size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--save_path", type=str, default="ckpt/baseline")
    parser.add_argument("--metadata_root", type=str, default=None)
    parser.add_argument("--visualize", action="store_true",
                        help="write each test image's heatmaps under "
                        "<save_path>/visualization/")
    parser.add_argument("--text_adapt_weight", type=float, default=0.1)
    parser.add_argument("--image_adapt_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_until", type=int, default=3)
    parser.add_argument("--image_adapt_until", type=int, default=6)
    parser.add_argument("--iqm_hidden_size", type=int, default=512)
    parser.add_argument("--iqm_num_layers", type=int, default=2)
    parser.add_argument("--iqm_num_heads", type=int, default=8)
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
    parser.add_argument("--import_reference", action="store_true",
                        help="treat --save_path as a PyTorch-reference "
                        "checkpoint dir (text_adapter.pth / "
                        "image_adapter_N.pth) and import the adapters")
    parser.add_argument("--quantize_backbone", type=str, default=None,
                        choices=TIERS,
                        help="int8 frozen-backbone inference tier; "
                        "'int8_attn' quantizes only the attention "
                        "projections and keeps the fused float MLP kernel, "
                        "'int8_mlp' only the MLP (fused int8 kernel)")
    parser.add_argument("--device", type=str, default=default_device(),
                        help="cuda (default) or cpu; AACLIP_PLATFORM=cpu sets cpu")
    parser.add_argument("--data_parallel", action="store_true",
                        help="under torchrun: split every batch over its ranks, "
                        "one card each (a single process: no effect)")
    parser.add_argument("--use_pallas", action="store_true",
                        help="accepted for the JAX CLI's flag surface: the port always runs its "
                        "kernels (JAX's default, without this flag, is its XLA route)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the sweep here")
    parser.add_argument("--debug_nans", action="store_true",
                        help="raise FloatingPointError at the first op that "
                        "makes a NaN (slow: it synchronises at every op)")
    return parser


def model_config(args):
    """The model configuration that the parsed flags describe: the adapter
    and IQM flags a checkpoint was trained with change the model it is
    scored with, as in the JAX CLI."""
    return build_model_config(
        model_name=args.model_name, img_size=args.img_size, relu=args.relu,
        text_adapt_weight=args.text_adapt_weight,
        image_adapt_weight=args.image_adapt_weight,
        text_adapt_until=args.text_adapt_until,
        image_adapt_until=args.image_adapt_until,
        iqm_hidden_size=args.iqm_hidden_size,
        iqm_num_layers=args.iqm_num_layers,
        iqm_num_heads=args.iqm_num_heads)


def main(argv=None):
    args = build_parser().parse_args(argv)
    mesh = None
    if args.data_parallel:
        mesh, args.device = data_parallel_mesh(args.device)
    primary = is_primary()
    setup_seed(args.seed)
    logger = setup_logger(args.save_path, "test.log") if primary else quiet_logger("test")
    logger.info("args: %s", vars(args))

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.compute_dtype]
    model_cfg = model_config(args)
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

    if args.debug_nans:
        enable_nan_checks(True)
    try:
        adapted_text = False
        if args.import_reference:
            trainable = import_reference_checkpoints(args.save_path, trainable,
                                                     relu=args.relu)
            adapted_text = os.path.isfile(os.path.join(args.save_path,
                                                       "text_adapter.pth"))
            logger.info("imported reference adapters from %s", args.save_path)
        elif not args.no_adapters:
            trainable, adapted_text, epoch = restore_adapters(args.save_path, trainable)
            logger.info("restored adapters from %s (epoch %s, adapted text: %s)",
                        args.save_path, epoch, adapted_text)

        anchors = compute_frozen_anchors(frozen, trainable, model_cfg,
                                         args.dataset, adapted=adapted_text,
                                         compute_dtype=dtype)
        datasets = get_dataset(args.dataset, args.img_size, None, -1, "test",
                               logger=logger, metadata_root=args.metadata_root,
                               device_normalize=True)
        eval_cfg = EvalConfig(
            dataset=args.dataset, img_size=args.img_size,
            batch_size=args.image_batch_size, seed=args.seed,
            save_path=args.save_path, iqm_weight=args.iqm_weight,
            text_weight=args.text_weight, compute_dtype=args.compute_dtype,
            image_score_mode=args.image_score_mode)
        with trace(args.profile_dir):
            rows = evaluate_dataset(frozen, trainable, model_cfg, eval_cfg, datasets,
                                    anchors, logger=logger, compute_dtype=dtype,
                                    visualize_dir=(args.save_path if args.visualize and primary
                                                   else None), mesh=mesh)
    finally:
        if args.debug_nans:
            enable_nan_checks(False)
    table = results_table(rows)
    logger.info("final results:\n%s", table)
    if primary:
        print(table)
    return rows


if __name__ == "__main__":
    main()
