#!/usr/bin/env python
"""Benchmark: 518 px anomaly-map inference throughput (images/sec per GPU).

    python -m aa_clip_iqm_tpu_torch.cli.bench [--quant int8] [--batch 8]
        [--twins] [--repeats 3] [--iters 10]

Runs the whole scoring pipeline (adapted ViT-L/14 forward with taps at
{6, 12, 18, 24}, seg/det projections, IQM query transformer, 4-level anchor
similarity with blur/upsample as matmuls, 4-level IQM maps, fusion) in
bfloat16 on one GPU with seeded random weights, on uint8 batches that
already lie on the device, and prints ONE JSON line: the median over
``--repeats`` timed blocks of ``--iters`` batches each (CUDA events around
each block) and ``spread_pct`` = (max - min) / median. Lines that start
with ``#`` are diagnostics. ``--twins`` routes every hand-written kernel to
its plain PyTorch twin, so the two runs of one call are an A/B of the
kernels. Counterpart of the inference mode of ``aa_clip_iqm_tpu/cli/bench.py``;
it needs a GPU and never falls back to the CPU.
"""
import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

METRIC = "anomaly_map_inference_518px_images_per_sec_per_gpu"


def _median_spread(samples):
    med = float(np.median(samples))
    spread = (100.0 * (max(samples) - min(samples)) / med) if med > 0 else 0.0
    return med, spread


@contextlib.contextmanager
def plain_twins():
    """Route the three kernel call sites to their plain PyTorch twins."""
    from ..models import clip
    from ..ops import attention, fused_mlp, packed_attention

    saved = (attention.flash_mha_packed, clip.ln_mlp_residual,
             clip.ln_mlp_residual_int8)
    attention.flash_mha_packed = packed_attention.flash_mha_packed_reference
    clip.ln_mlp_residual = fused_mlp.ln_mlp_residual_reference
    clip.ln_mlp_residual_int8 = fused_mlp.ln_mlp_residual_int8_reference
    try:
        yield
    finally:
        (attention.flash_mha_packed, clip.ln_mlp_residual,
         clip.ln_mlp_residual_int8) = saved


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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quant", type=str, default=None,
                        help="int8 tier: int8, int8_attn, int8_mlp "
                        "(optionally +smooth); a typo raises")
    parser.add_argument("--batch", type=int, default=8)
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
    cfg = build_model_config(args.model_name, img_size=args.img_size)
    frozen = load_frozen_backbone(cfg, allow_random=True)
    trainable = init_trainable(cfg)
    frozen = quantize_backbone_auto(frozen, args.quant, cfg=cfg)
    predict = make_predict_fn(cfg, args.img_size, "Industrial",
                              compute_dtype=torch.bfloat16)
    with plain_twins() if args.twins else contextlib.nullcontext():
        samples = _measure(predict, frozen, trainable, args.batch,
                           args.img_size, cfg.clip.embed_dim, args.iters,
                           max(1, args.repeats))
    med, spread = _median_spread(samples)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    print(f"# batch={args.batch} quant={args.quant} twins={args.twins}: median "
          f"{med:.2f} img/s, spread {spread:.1f}%, repeats "
          f"[{', '.join(f'{s:.2f}' for s in samples)}]")
    print(json.dumps({
        "metric": METRIC,
        "value": round(med, 2),
        "unit": "images/sec",
        "spread_pct": round(spread, 1),
        "batch": args.batch,
        "quant": args.quant,
        "kernels": "twins" if args.twins else "cuda",
        "device": torch.cuda.get_device_name(0),
        "card": card[0].strip() if card else None,
    }))


if __name__ == "__main__":
    main()
