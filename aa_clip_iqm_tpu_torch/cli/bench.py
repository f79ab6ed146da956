#!/usr/bin/env python
"""Benchmark: 518 px throughput (images/sec per GPU) of inference and of the
two training stages.

    python -m aa_clip_iqm_tpu_torch.cli.bench [--mode inference|train|stage1]
        [--quant int8] [--batch 8] [--img_size 518] [--twins] [--repeats 3]
        [--iters 10]

``--mode inference`` (default) runs the whole scoring pipeline (adapted ViT-L/14 forward with taps at
{6, 12, 18, 24}, seg/det projections, IQM query transformer, 4-level anchor
similarity with blur/upsample as matmuls, 4-level IQM maps, fusion) in
bfloat16 on one GPU with seeded random weights, on uint8 batches that
already lie on the device, and prints ONE JSON line: the median over
``--repeats`` timed blocks of ``--iters`` batches each (CUDA events around
each block) and ``spread_pct`` = (max - min) / median. Lines that start
with ``#`` are diagnostics. ``--twins`` routes every hand-written kernel to
its plain PyTorch twin, so the two runs of one call are an A/B of the
kernels.

``--mode train`` times the stage-2 step (adapted forward, the five losses,
backward through the attention-backward and dx kernels, AdamW) on a fixed
device-resident batch: float32 master adapters, bf16 compute, metric
``stage2_train_518px_images_per_sec_per_gpu``. ``--mode stage1`` times the
stage-1 batch (no-grad dual-tower visual features, then the text-adapter
step through MVTec's prompt ensemble), metric
``stage1_train_518px_images_per_sec_per_gpu``; its default batch is 16.

Counterpart of the inference, train and stage1 modes of
``aa_clip_iqm_tpu/cli/bench.py``; it needs a GPU and never falls back to the
CPU.
"""
import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

METRIC = "anomaly_map_inference_518px_images_per_sec_per_gpu"
TRAIN_METRICS = {"train": "stage2_train_518px_images_per_sec_per_gpu",
                 "stage1": "stage1_train_518px_images_per_sec_per_gpu"}


def _median_spread(samples):
    med = float(np.median(samples))
    spread = (100.0 * (max(samples) - min(samples)) / med) if med > 0 else 0.0
    return med, spread


@contextlib.contextmanager
def plain_twins():
    """Route the kernel call sites to their plain PyTorch twins (autograd
    then differentiates the twins, so the backward kernels are out too)."""
    from ..models import clip
    from ..ops import attention, attn_block, fused_mlp, packed_attention

    saved = (attention.flash_mha_packed, attention.flash_mha, clip.ln_attn_residual,
             clip.ln_mlp_residual, clip.ln_mlp_residual_frozen, clip.ln_mlp_residual_int8)
    attention.flash_mha_packed = packed_attention.flash_mha_packed_reference
    attention.flash_mha = attention.sdpa
    clip.ln_attn_residual = attn_block.ln_attn_residual_reference
    clip.ln_mlp_residual = fused_mlp.ln_mlp_residual_reference
    clip.ln_mlp_residual_frozen = fused_mlp.ln_mlp_residual_reference
    clip.ln_mlp_residual_int8 = fused_mlp.ln_mlp_residual_int8_reference
    try:
        yield
    finally:
        (attention.flash_mha_packed, attention.flash_mha, clip.ln_attn_residual,
         clip.ln_mlp_residual, clip.ln_mlp_residual_frozen, clip.ln_mlp_residual_int8) = saved


def _measure(predict, frozen, trainable, batch, img, embed_dim, iters, repeats):
    """images/s of ``repeats`` blocks of ``iters`` batches, CUDA events
    around each block, after one warm-up batch (which also builds the
    kernels)."""
    rng = np.random.default_rng(0)
    n_bufs = 4
    image_bufs = [torch.from_numpy(
        rng.integers(0, 256, (batch, 3, img, img), dtype=np.uint8)).cuda()
        for _ in range(n_bufs)]
    anchors = rng.standard_normal((batch, embed_dim, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    anchors = torch.from_numpy(anchors).cuda()
    predict(frozen, trainable, image_bufs[0], anchors)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(iters):
            predict(frozen, trainable, image_bufs[i % n_bufs], anchors)
        end.record()
        torch.cuda.synchronize()
        samples.append(batch * iters / (start.elapsed_time(end) / 1e3))
    return samples


def _time_blocks(one_batch, batch, iters, repeats):
    """images/s of ``repeats`` blocks of ``iters`` calls, CUDA events around
    each block, after one warm-up call (which also builds the kernels)."""
    one_batch()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            one_batch()
        end.record()
        torch.cuda.synchronize()
        samples.append(batch * iters / (start.elapsed_time(end) / 1e3))
    return samples


def _measure_train(mode, cfg, frozen, batch, img, quant, iters, repeats):
    """The stage-2 step (``train``) or the stage-1 batch (``stage1``) on a
    fixed batch that already lies on the device."""
    from ..configs import TrainConfig
    from ..loader import init_trainable
    from ..ops.quant import quantize_backbone_auto
    from ..prompts import batched_prompt_tokens
    from ..train import optim, steps

    trainable = init_trainable(cfg, dtype=torch.float32, requires_grad=True)
    train_cfg = TrainConfig(img_size=img, compute_dtype="bfloat16", dataset="MVTec")
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.standard_normal((batch, 3, img, img)).astype(np.float32)).cuda()
    masks = torch.from_numpy(
        (rng.random((batch, 1, img, img)) > 0.9).astype(np.float32)).cuda()
    weights = torch.ones(batch, device="cuda")
    if mode == "train":
        frozen = quantize_backbone_auto(frozen, quant, cfg=cfg)
        opt_state = optim.stage2_optimizer(trainable, train_cfg.image_lr, 100)
        step = steps.make_stage2_step(cfg, train_cfg, compute_dtype=torch.bfloat16)
        labels = torch.from_numpy(rng.integers(0, 2, batch).astype(np.int64)).cuda()
        anchors = torch.from_numpy(rng.standard_normal(
            (batch, cfg.clip.embed_dim, 2)).astype(np.float32)).cuda()

        def one_batch():
            step(trainable, opt_state, frozen, images, masks, labels, anchors, weights)
    else:
        # The visual extraction builds no graph, so int8 there is a pure
        # inference tier; the text step keeps the float backbone.
        frozen_vis = quantize_backbone_auto(frozen, quant, cfg=cfg)
        classes, tokens, n_norm, n_abn = batched_prompt_tokens("MVTec")
        tokens = torch.from_numpy(np.asarray(tokens, np.int64)).cuda()
        text_params = trainable["text_adapter"]
        opt_state = optim.stage1_optimizer(text_params, train_cfg.text_lr)
        visual_fn = steps.make_stage1_visual_fn(cfg, compute_dtype=torch.bfloat16)
        step = steps.make_stage1_step(cfg, train_cfg, tokens, len(classes), n_norm,
                                      n_abn, compute_dtype=torch.bfloat16)
        class_idx = torch.from_numpy(rng.integers(0, len(classes), batch)).cuda()

        def one_batch():
            feats = visual_fn(frozen_vis, images)
            step(text_params, opt_state, frozen, feats, masks, class_idx, weights)

    return _time_blocks(one_batch, batch, iters, repeats)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", type=str, default="inference",
                        choices=["inference", "train", "stage1"])
    parser.add_argument("--quant", type=str, default=None,
                        help="int8 tier: int8, int8_attn, int8_mlp "
                        "(optionally +smooth); a typo raises")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 8; 16 for --mode stage1")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--twins", action="store_true",
                        help="plain PyTorch twins instead of the kernels")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is false; this "
                         "measurement needs a GPU")

    from ..evaluation.predict import make_predict_fn
    from ..loader import build_model_config, init_trainable, load_frozen_backbone
    from ..ops.quant import quantize_backbone_auto

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.batch is None:
        args.batch = 16 if args.mode == "stage1" else 8
    cfg = build_model_config(args.model_name, img_size=args.img_size)
    frozen = load_frozen_backbone(cfg, allow_random=True)
    with plain_twins() if args.twins else contextlib.nullcontext():
        if args.mode == "inference":
            trainable = init_trainable(cfg)
            frozen = quantize_backbone_auto(frozen, args.quant, cfg=cfg)
            predict = make_predict_fn(cfg, args.img_size, "Industrial",
                                      compute_dtype=torch.bfloat16)
            samples = _measure(predict, frozen, trainable, args.batch,
                               args.img_size, cfg.clip.embed_dim, args.iters,
                               max(1, args.repeats))
        else:
            samples = _measure_train(args.mode, cfg, frozen, args.batch,
                                     args.img_size, args.quant, args.iters,
                                     max(1, args.repeats))
    med, spread = _median_spread(samples)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f"# mode={args.mode} batch={args.batch} quant={args.quant} "
          f"twins={args.twins}: median "
          f"{med:.2f} img/s, spread {spread:.1f}%, repeats "
          f"[{', '.join(f'{s:.2f}' for s in samples)}]")
    print(json.dumps({
        "metric": TRAIN_METRICS.get(args.mode, METRIC),
        "value": round(med, 2),
        "unit": "images/sec",
        "spread_pct": round(spread, 1),
        "batch": args.batch,
        "img_size": args.img_size,
        "quant": args.quant,
        "kernels": "twins" if args.twins else "cuda",
        "device": torch.cuda.get_device_name(0),
        "card": card[0].strip() if card else None,
    }))


if __name__ == "__main__":
    main()
