#!/usr/bin/env python
"""Two-stage adapter training CLI (reference train.py:240-286 flag surface).

    python -m aa_clip_iqm_tpu_torch.cli.train --dataset VisA \\
        --training_mode full_shot --save_path ckpt/baseline \\
        --backbone /path/to/ViT-L-14-336px.pt

Counterpart of ``aa_clip_iqm_tpu/cli/train.py``. It runs on ``cuda`` unless
``--device cpu`` is given: the frozen backbone in the compute dtype, the
trainable adapters as float32 master weights. Data-parallel training,
profiling and NaN checks are not ported yet.
"""
import argparse

import torch

from ..configs import TrainConfig
from ..loader import build_model_config, init_trainable, load_frozen_backbone
from ..ops.quant import quantize_backbone_auto
from ..train.driver import run_training
from ..utils.misc import setup_logger, setup_seed
from .evaluate import TIERS


def build_parser():
    parser = argparse.ArgumentParser(description="Training")
    # model
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--surgery_until_layer", type=int, default=20)
    parser.add_argument("--relu", action="store_true",
                        help="use relu after projection")
    parser.add_argument("--backbone", type=str, default=None,
                        help="OpenAI .pt checkpoint or converted .npz")
    parser.add_argument("--random_backbone", action="store_true",
                        help="random-init backbone (smoke runs only)")
    # training
    parser.add_argument("--dataset", type=str, default="VisA")
    parser.add_argument("--training_mode", type=str, default="few_shot",
                        choices=["few_shot", "full_shot"])
    parser.add_argument("--shot", type=int, default=32)
    parser.add_argument("--text_batch_size", type=int, default=16)
    parser.add_argument("--image_batch_size", type=int, default=2)
    parser.add_argument("--text_epoch", type=int, default=5)
    parser.add_argument("--image_epoch", type=int, default=20)
    parser.add_argument("--text_lr", type=float, default=1e-5)
    parser.add_argument("--image_lr", type=float, default=5e-4)
    # exp
    parser.add_argument("--seed", type=int, default=111)
    parser.add_argument("--save_path", type=str, default="ckpt/baseline")
    parser.add_argument("--metadata_root", type=str, default=None,
                        help="metadata tree root (default: packaged metadata "
                        "or $AACLIP_METADATA_ROOT)")
    parser.add_argument("--keep_checkpoints", type=int, default=0,
                        help="keep only the last N numbered stage-2 "
                        "checkpoints (0 = keep all, the reference behavior)")
    parser.add_argument("--checkpoint_every_steps", type=int, default=0,
                        help="mid-epoch step-checkpoint interval for both "
                        "stages (0 = epoch-only, the reference behavior); "
                        "an interrupted run resumes at (epoch, step) with "
                        "bit-identical results")
    parser.add_argument("--sync_step_checkpoints", action="store_true",
                        help="write step checkpoints in the step loop instead "
                        "of on the background writer (debugging)")
    # hyper-parameters
    parser.add_argument("--text_norm_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_weight", type=float, default=0.1)
    parser.add_argument("--image_adapt_weight", type=float, default=0.1)
    parser.add_argument("--text_adapt_until", type=int, default=3)
    parser.add_argument("--image_adapt_until", type=int, default=6)
    # IQM
    parser.add_argument("--iqm_hidden_size", type=int, default=512)
    parser.add_argument("--iqm_num_layers", type=int, default=2)
    parser.add_argument("--iqm_num_heads", type=int, default=8)
    parser.add_argument("--iqm_weight", type=float, default=0.4)
    # device
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--clip_grad_norm", type=float, default=None,
                        help="global-norm gradient clip for stage 2. Default "
                        "off = the executed reference (its clip runs before "
                        "backward, so it never clips the real update)")
    parser.add_argument("--torch_lr_quirk", action="store_true",
                        help="reproduce the reference's per-batch-stepped "
                        "T_max=epochs cosine schedule")
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint the blocks in the stage-2 backward")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="stage-2 gradient accumulation: this many "
                        "microbatches per optimizer step (peak activation "
                        "memory = one microbatch; exact against the full "
                        "batch). image_batch_size must divide by it")
    parser.add_argument("--patch_dropout", type=float, default=0.0,
                        help="stage-2 patch-dropout rate (the reference "
                        "configures 0.2 but never activates it; off by "
                        "default for fidelity)")
    parser.add_argument("--quantize_backbone", type=str, default=None,
                        choices=TIERS,
                        help="int8-forward training experiment: quantize the "
                        "frozen backbone (straight-through backward); "
                        "'int8_attn' quantizes only the attention projections")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_seed(args.seed)
    logger = setup_logger(args.save_path, "train.log")
    logger.info("args: %s", vars(args))

    model_cfg = build_model_config(
        model_name=args.model_name, img_size=args.img_size, relu=args.relu,
        text_adapt_weight=args.text_adapt_weight,
        image_adapt_weight=args.image_adapt_weight,
        text_adapt_until=args.text_adapt_until,
        image_adapt_until=args.image_adapt_until,
        iqm_hidden_size=args.iqm_hidden_size,
        iqm_num_layers=args.iqm_num_layers,
        iqm_num_heads=args.iqm_num_heads,
        surgery_until_layer=args.surgery_until_layer,
        patch_dropout=args.patch_dropout,
    )
    train_cfg = TrainConfig(
        dataset=args.dataset, img_size=args.img_size,
        training_mode=args.training_mode, shot=args.shot,
        text_batch_size=args.text_batch_size,
        image_batch_size=args.image_batch_size,
        text_epoch=args.text_epoch, image_epoch=args.image_epoch,
        text_lr=args.text_lr, image_lr=args.image_lr,
        text_norm_weight=args.text_norm_weight,
        iqm_loss_weight=args.iqm_weight, seed=args.seed,
        save_path=args.save_path, compute_dtype=args.compute_dtype,
        torch_lr_quirk=args.torch_lr_quirk, remat=args.remat,
        grad_accum_steps=args.grad_accum,
        keep_checkpoints=args.keep_checkpoints,
        checkpoint_every_steps=args.checkpoint_every_steps,
        async_step_checkpoint=not args.sync_step_checkpoints,
        clip_grad_norm=args.clip_grad_norm,
    )
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        args.compute_dtype]
    frozen = load_frozen_backbone(model_cfg, args.backbone,
                                  allow_random=args.random_backbone,
                                  device=args.device, dtype=dtype)
    if args.quantize_backbone:
        frozen = quantize_backbone_auto(frozen, args.quantize_backbone,
                                        cfg=model_cfg)
        logger.info("frozen backbone quantized (straight-through backward, "
                    "tier=%s)", args.quantize_backbone)
    # float32 master weights, whatever the compute dtype.
    trainable = init_trainable(model_cfg, seed=args.seed, device=args.device,
                               dtype=torch.float32, requires_grad=True)
    return run_training(frozen, trainable, model_cfg, train_cfg, logger,
                        metadata_root=args.metadata_root)


if __name__ == "__main__":
    main()
