#!/usr/bin/env python
"""Benchmark: 518 px throughput (images/sec per GPU) of inference, the
evaluation sweep and the two training stages, and single-request latency.

    python -m aa_clip_iqm_tpu_torch.cli.bench
        [--mode inference|latency|eval|train|stage1] [--batch N]
        [--sweep grid|B1,B2,...] [--pallas 0|1] [--accum K] [--quant int8]
        [--img_size 518] [--twins] [--repeats 3] [--iters 10]
        [--profile_dir DIR]

Every mode prints ONE JSON line, on a GPU with seeded random weights; lines
that start with ``#`` are diagnostics. Throughput is the median over
``--repeats`` timed blocks with ``spread_pct`` = (max - min) / median.

``--mode inference`` (default) runs the whole scoring pipeline (adapted
ViT-L/14 forward with taps at {6, 12, 18, 24}, seg/det projections, IQM
query transformer, 4-level anchor similarity with blur/upsample as matmuls,
4-level IQM maps, fusion) in bfloat16 on uint8 batches that already lie on
the device, ``--iters`` batches a block, CUDA events around each block.
``--sweep`` measures several configurations and reports the best, each on a
``#`` line: ``grid`` (or ``1``) is the batch x route grid (16, 32) x
(``--pallas`` 0, 1), a comma list those batch sizes on the ``--pallas``
route. ``--pallas 0`` is the stock PyTorch route (``use_pallas=False``: SDPA
and the cuBLAS chain, no kernel of the port), the JAX bench's
``AACLIP_BENCH_PALLAS=0``; 1, the default, the hand-written kernels.

``--mode latency`` times 30 ``AnomalyDetector.predict`` calls of ``--batch``
(default 1) float32 518 px images after a warm-up, each from the host copy
in to the maps and scores back on the host, on the detector's CUDA graph
of that bucket (host clock). It reports the p50 in ms; the p95 goes on a
``#`` line.

``--mode eval`` times the end-to-end sweep a user of ``cli.evaluate`` runs:
the anchors (``compute_frozen_anchors``) and ``evaluate_dataset`` over a
synthetic dataset on disk (2 classes x 24 images at 518 px, PNG decode
included; ``--batch`` default 16, so a full batch and a tail bucket of 8 a
class), after one warm-up sweep, wall clock ending in a synchronise. The
Average pixel AUC goes on a ``#`` line. The sweep's predict calls replay one
CUDA graph per bucket (``train/graphs.py``), captured in the warm-up sweep,
as ``cli.evaluate``'s do; its images go through the data layer's default
transforms (the native pipeline).

``--mode train`` times the stage-2 step (adapted forward, the five losses,
backward through the attention-backward and dx kernels, AdamW) on a fixed
device-resident batch of ``--batch`` (default 8): float32 master adapters,
bf16 compute; ``--accum K`` runs it at ``grad_accum_steps=K`` (the batch
must divide by K). ``--mode stage1`` times the stage-1 batch (no-grad
dual-tower visual features, then the text-adapter step through MVTec's
prompt ensemble); its default batch is 16. Both run as ``cli.train`` runs
them on the card: the steps (and stage 1's feature program) replayed as CUDA
graphs, captured in the warm-up call, with graphable optimizers.

Every JSON line has a ``"route"``: ``"graphs"`` where the timed program is a
graph replay (latency, eval, train, stage1), ``"eager"`` for the inference
mode, which times the predict program itself.

``--twins`` routes every hand-written kernel to its plain PyTorch twin.
``--profile_dir`` writes a ``torch.profiler`` trace of the timed blocks
there (``tools/trace_summary.py`` reads it).

Counterpart of ``aa_clip_iqm_tpu/cli/bench.py``, with flags for its
``AACLIP_BENCH_*`` knobs. It needs a GPU and never falls back to the CPU.
"""
import argparse
import contextlib
import itertools
import json
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

METRIC = "anomaly_map_inference_518px_images_per_sec_per_gpu"
TRAIN_METRICS = {"train": "stage2_train_518px_images_per_sec_per_gpu",
                 "stage1": "stage1_train_518px_images_per_sec_per_gpu"}
LATENCY_METRIC = "serving_latency_single_image_518px_p50_ms"
EVAL_METRIC = "eval_sweep_end_to_end_518px_images_per_sec"
DEFAULT_BATCH = {"inference": 8, "latency": 1, "eval": 16, "train": 8, "stage1": 16}
LATENCY_CALLS = 30
EVAL_CLASSES = ("widget", "gadget")


def _median_spread(samples):
    med = float(np.median(samples))
    spread = (100.0 * (max(samples) - min(samples)) / med) if med > 0 else 0.0
    return med, spread


def _fmt(samples):
    return "[" + ", ".join(f"{s:.2f}" for s in samples) + "]"


def _sweep_configs(sweep, default_batch, default_pallas):
    """``--sweep`` -> [(batch, use_pallas)] measurement configurations, as the
    JAX bench's ``_sweep_configs``: None or '' -> one configuration from
    ``--batch`` / ``--pallas``; 'grid' (or its alias '1') -> the batch x
    route grid; a comma list of batch sizes -> those, on ``--pallas``'s
    route. Malformed entries raise."""
    if not sweep:
        return [(default_batch, default_pallas)]
    if sweep in ("grid", "1"):
        return [(16, False), (16, True), (32, False), (32, True)]
    try:
        batches = [int(b) for b in sweep.split(",")]
    except ValueError:
        raise ValueError(
            f"--sweep must be 'grid' or a comma list of batch sizes, got {sweep!r}")
    if any(b <= 0 for b in batches):
        raise ValueError(f"--sweep batches must be positive, got {sweep!r}")
    return [(b, default_pallas) for b in batches]


@contextlib.contextmanager
def plain_twins():
    """Route every kernel call site of ``models.clip`` and ``ops.attention``
    to its plain PyTorch version (autograd then differentiates those, so the
    backward kernels are out too)."""
    from ..models import clip
    from ..ops import attention, attn_block, fused_mlp, layers, packed_attention, rope, swiglu

    twins = {
        (attention, "flash_mha_packed"): packed_attention.flash_mha_packed_reference,
        (attention, "flash_mha"): attention.sdpa,
        (clip, "ln_attn_front"): attn_block.ln_attn_front_reference,
        (clip, "ln_attn_back"): attn_block.ln_attn_back_reference,
        (clip, "ln_mlp_residual"): fused_mlp.ln_mlp_residual_reference,
        (clip, "ln_mlp_residual_frozen"): fused_mlp.ln_mlp_residual_reference,
        (clip, "ln_mlp_residual_int8"): fused_mlp.ln_mlp_residual_int8_reference,
        (clip, "ln_swiglu_residual"): swiglu.ln_swiglu_residual_reference,
        (clip, "layer_norm_rows"): layers.layer_norm,
        (clip, "rope_qk"): rope.rope_qk_reference,
    }
    saved = {(mod, name): getattr(mod, name) for mod, name in twins}
    for (mod, name), twin in twins.items():
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for (mod, name), kernel in saved.items():
            setattr(mod, name, kernel)


def _time_blocks(one_batch, batch, iters, repeats, profile_dir=None):
    """images/s of ``repeats`` blocks of ``iters`` calls, CUDA events around
    each block, after one warm-up call (which also builds the kernels); the
    timed blocks under ``utils.profiling.trace(profile_dir)``."""
    from ..utils.profiling import trace

    one_batch()
    torch.cuda.synchronize()
    samples = []
    with trace(profile_dir):
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


def _device(frozen):
    return frozen["visual"]["class_embedding"].device


def _measure(predict, frozen, trainable, batch, img, embed_dim, iters, repeats,
             profile_dir=None):
    """Inference images/s: ``predict`` on four uint8 batches in turn, on the
    weights' device (:func:`_time_blocks`)."""
    rng = np.random.default_rng(0)
    dev = _device(frozen)
    image_bufs = [torch.from_numpy(
        rng.integers(0, 256, (batch, 3, img, img), dtype=np.uint8)).to(dev)
        for _ in range(4)]
    anchors = rng.standard_normal((batch, embed_dim, 2)).astype(np.float32)
    anchors /= np.linalg.norm(anchors, axis=1, keepdims=True)
    anchors = torch.from_numpy(anchors).to(dev)
    bufs = itertools.cycle(image_bufs)

    def one_batch():
        predict(frozen, trainable, next(bufs), anchors)

    return _time_blocks(one_batch, batch, iters, repeats, profile_dir)


def _measure_train(mode, cfg, frozen, batch, img, quant, iters, repeats,
                   accum=1, profile_dir=None):
    """The stage-2 step (``train``, at ``grad_accum_steps=accum``) or the
    stage-1 batch (``stage1``) on a fixed batch on the weights' device, as
    the training driver runs them there (graph replays on the card).
    Returns (images/s samples, the losses of the last block)."""
    from ..configs import TrainConfig
    from ..loader import init_trainable
    from ..ops.quant import quantize_backbone_auto
    from ..prompts import batched_prompt_tokens
    from ..train import graphs, optim, steps

    if batch % accum:
        raise ValueError(f"--batch {batch} must divide by --accum {accum}")
    dev = _device(frozen)
    trainable = init_trainable(cfg, device=dev, dtype=torch.float32, requires_grad=True)
    train_cfg = TrainConfig(img_size=img, compute_dtype="bfloat16", dataset="MVTec",
                            grad_accum_steps=accum)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(
        rng.standard_normal((batch, 3, img, img)).astype(np.float32)).to(dev)
    masks = torch.from_numpy(
        (rng.random((batch, 1, img, img)) > 0.9).astype(np.float32)).to(dev)
    weights = torch.ones(batch, device=dev)
    losses = []
    graphed = graphs.enabled(dev)
    cache = graphs.GraphCache()
    if mode == "train":
        frozen = quantize_backbone_auto(frozen, quant, cfg=cfg)
        opt_state = optim.stage2_optimizer(trainable, train_cfg.image_lr, 100,
                                           graphable=graphed)
        step = steps.make_stage2_step(cfg, train_cfg, compute_dtype=torch.bfloat16)
        if graphed:
            step = graphs.GraphedStep(step, cache, "stage2 step")
        labels = torch.from_numpy(rng.integers(0, 2, batch).astype(np.int64)).to(dev)
        anchors = torch.from_numpy(rng.standard_normal(
            (batch, cfg.clip.embed_dim, 2)).astype(np.float32)).to(dev)

        def one_batch():
            losses.append(step(trainable, opt_state, frozen, images, masks, labels,
                               anchors, weights)[-1])
    else:
        # The visual extraction builds no graph, so int8 there is a pure
        # inference tier; the text step keeps the float backbone.
        frozen_vis = quantize_backbone_auto(frozen, quant, cfg=cfg)
        classes, tokens, n_norm, n_abn = batched_prompt_tokens("MVTec")
        tokens = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
        text_params = trainable["text_adapter"]
        opt_state = optim.stage1_optimizer(text_params, train_cfg.text_lr,
                                           graphable=graphed)
        visual_fn = steps.make_stage1_visual_fn(cfg, compute_dtype=torch.bfloat16)
        step = steps.make_stage1_step(cfg, train_cfg, tokens, len(classes), n_norm,
                                      n_abn, compute_dtype=torch.bfloat16)
        if graphed:
            visual_fn = graphs.GraphedFn(visual_fn, cache, "stage1 features")
            step = graphs.GraphedStep(step, cache, "stage1 step")
        class_idx = torch.from_numpy(rng.integers(0, len(classes), batch)).to(dev)

        def one_batch():
            feats = visual_fn(frozen_vis, images)
            losses.append(step(text_params, opt_state, frozen, feats, masks, class_idx,
                               weights)[-1])

    samples = _time_blocks(one_batch, batch, iters, repeats, profile_dir)
    return samples, losses[-iters:]


def measure_latency(det, images, class_name, calls=LATENCY_CALLS, profile_dir=None):
    """Milliseconds of each of ``calls`` ``det.predict`` calls (host clock:
    the copy in, the bucket's graph replay, the maps and scores back on the
    host), cycling through ``images`` (a list of batches), after a warm-up
    call that captures the bucket's graph."""
    from ..utils.profiling import trace

    det.predict(images[0], class_name)
    lat_ms = []
    with trace(profile_dir):
        for i in range(calls):
            t0 = time.perf_counter()
            det.predict(images[i % len(images)], class_name)
            lat_ms.append((time.perf_counter() - t0) * 1e3)
    return lat_ms


def eval_sweeps(frozen, trainable, cfg, img, batch, repeats, use_pallas=True,
                profile_dir=None):
    """images/s of ``repeats`` end-to-end sweeps (anchors, then
    ``evaluate_dataset``) over a synthetic dataset written to a temporary
    directory and read back through ``get_dataset``, after one warm-up
    sweep (wall clock: a sweep ends when its last metrics are on the host).
    Returns (samples, the last sweep's rows, images a sweep)."""
    from ..configs import EvalConfig
    from ..data.datasets import get_dataset
    from ..data.synthetic import generate, register_synthetic
    from ..evaluation.predict import evaluate_dataset
    from ..prompts import compute_frozen_anchors
    from ..train.graphs import GraphCache
    from ..utils.profiling import trace

    root = tempfile.mkdtemp(prefix="aaclip_bench_eval_")
    try:
        generate(root, n_normal=12, n_anomalous=12, size=img,
                 class_names=EVAL_CLASSES, seed=3, dataset_name="Synth")
        metadata_root = register_synthetic(root, class_names=EVAL_CLASSES)
        datasets = get_dataset("Synth", img, None, -1, "test",
                               metadata_root=metadata_root, device_normalize=True)
        n_images = sum(len(d) for d in datasets.values())
        eval_cfg = EvalConfig(dataset="Synth", img_size=img, batch_size=batch,
                              compute_dtype="bfloat16")
        graphs = GraphCache()   # the warm-up sweep captures, the timed ones replay

        def sweep():
            anchors = compute_frozen_anchors(frozen, trainable, cfg, "Synth",
                                             adapted=False, compute_dtype=torch.bfloat16,
                                             use_pallas=use_pallas)
            # The rows' metrics are fetched: the sweep's device work is done.
            return evaluate_dataset(frozen, trainable, cfg, eval_cfg, datasets, anchors,
                                    compute_dtype=torch.bfloat16, use_pallas=use_pallas,
                                    graphs=graphs)

        sweep()
        samples, rows = [], None
        with trace(profile_dir):
            for _ in range(repeats):
                t0 = time.perf_counter()
                rows = sweep()
                samples.append(n_images / (time.perf_counter() - t0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return samples, rows, n_images


def card():
    """The card's name and power limit, as nvidia-smi prints them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()
    return lines[0].strip() if lines else None


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", type=str, default="inference",
                        choices=list(DEFAULT_BATCH))
    parser.add_argument("--quant", type=str, default=None,
                        help="int8 tier: int8, int8_attn, int8_mlp "
                        "(optionally +smooth); a typo raises")
    parser.add_argument("--batch", type=int, default=None,
                        help="default 8; 1 for latency, 16 for eval and stage1")
    parser.add_argument("--img_size", type=int, default=518)
    parser.add_argument("--model_name", type=str, default="ViT-L-14-336")
    parser.add_argument("--twins", action="store_true",
                        help="plain PyTorch twins instead of the kernels")
    parser.add_argument("--pallas", type=int, default=1, choices=[0, 1],
                        help="1: the hand-written kernels; 0: the stock PyTorch "
                        "route (inference, latency and eval)")
    parser.add_argument("--sweep", type=str, default=None,
                        help="inference: 'grid' (batch 16, 32 x --pallas 0, 1) "
                        "or a comma list of batch sizes; the best is reported")
    parser.add_argument("--accum", type=int, default=1,
                        help="train: gradient accumulation steps (the batch "
                        "must divide by it)")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the timed blocks here")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--iters", type=int, default=10)
    return parser


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.sweep and args.mode != "inference":
        parser.error("--sweep applies to --mode inference")
    if args.accum != 1 and args.mode != "train":
        parser.error("--accum applies to --mode train")
    if args.accum < 1:
        parser.error("--accum must be positive")
    if not args.pallas and args.mode in TRAIN_METRICS:
        parser.error("--pallas 0 applies to --mode inference, latency and eval")
    if args.batch is None:
        args.batch = DEFAULT_BATCH[args.mode]
    configs = _sweep_configs(args.sweep, args.batch, bool(args.pallas))
    if not torch.cuda.is_available():
        raise SystemExit("bench: torch.cuda.is_available() is false; this "
                         "measurement needs a GPU")

    from ..evaluation.predict import make_predict_fn
    from ..loader import build_model_config, init_trainable, load_frozen_backbone
    from ..ops.quant import quantize_backbone_auto
    from ..train import graphs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    repeats = max(1, args.repeats)
    cfg = build_model_config(args.model_name, img_size=args.img_size)
    frozen = load_frozen_backbone(cfg, allow_random=True)
    batch, use_pallas, extra = args.batch, bool(args.pallas), {}
    route = "graphs" if graphs.enabled(_device(frozen)) else "eager"
    with plain_twins() if args.twins else contextlib.nullcontext():
        if args.mode == "inference":
            trainable = init_trainable(cfg)
            frozen = quantize_backbone_auto(frozen, args.quant, cfg=cfg)
            best = None
            for batch, use_pallas in configs:
                predict = make_predict_fn(cfg, args.img_size, "Industrial",
                                          compute_dtype=torch.bfloat16,
                                          use_pallas=use_pallas)
                samples = _measure(predict, frozen, trainable, batch, args.img_size,
                                   cfg.clip.embed_dim, args.iters, repeats,
                                   args.profile_dir)
                med, spread = _median_spread(samples)
                print(f"# batch={batch} pallas={use_pallas}: median {med:.2f} img/s, "
                      f"spread {spread:.1f}%, repeats {_fmt(samples)}")
                if best is None or med > best[0]:
                    best = (med, spread, batch, use_pallas)
            med, spread, batch, use_pallas = best
            metric, value, unit = METRIC, med, "images/sec"
            route = "eager"
        elif args.mode == "latency":
            from ..serving import AnomalyDetector

            det = AnomalyDetector(frozen, init_trainable(cfg), cfg, "MVTec",
                                  img_size=args.img_size, adapted_text=False,
                                  batch_buckets=(args.batch,), quantize=args.quant,
                                  use_pallas=bool(args.pallas))
            rng = np.random.default_rng(0)
            images = [rng.standard_normal((args.batch, 3, args.img_size, args.img_size))
                      .astype(np.float32) for _ in range(4)]
            lat = measure_latency(det, images, det.class_names()[0],
                                  profile_dir=args.profile_dir)
            p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
            print(f"# latency p95: {p95:.2f} ms (n={len(lat)}), batch {args.batch}")
            metric, value, unit = LATENCY_METRIC, p50, "ms"
            spread = 100.0 * (max(lat) - min(lat)) / p50
            extra["p95_ms"] = round(p95, 2)
        elif args.mode == "eval":
            frozen = quantize_backbone_auto(frozen, args.quant, cfg=cfg)
            samples, rows, n = eval_sweeps(frozen, init_trainable(cfg), cfg,
                                           args.img_size, args.batch, repeats,
                                           bool(args.pallas), args.profile_dir)
            med, spread = _median_spread(samples)
            print(f"# eval sweep: {n} images / {len(EVAL_CLASSES)} classes; Average "
                  f"pixel AUC {rows[-1]['pixel AUC']:.2f}; repeats {_fmt(samples)} img/s")
            metric, value, unit = EVAL_METRIC, med, "images/sec"
        else:
            samples, _ = _measure_train(args.mode, cfg, frozen, args.batch,
                                        args.img_size, args.quant, args.iters, repeats,
                                        args.accum, args.profile_dir)
            med, spread = _median_spread(samples)
            print(f"# mode={args.mode} batch={args.batch} accum={args.accum} "
                  f"quant={args.quant} twins={args.twins}: median {med:.2f} img/s, "
                  f"spread {spread:.1f}%, repeats {_fmt(samples)}")
            metric, value, unit = TRAIN_METRICS[args.mode], med, "images/sec"
            extra["accum"] = args.accum
    print(json.dumps({
        "metric": metric,
        "value": round(value, 2),
        "unit": unit,
        "spread_pct": round(spread, 1),
        **extra,
        "route": route,
        "batch": batch,
        "img_size": args.img_size,
        "quant": args.quant,
        "kernels": "twins" if args.twins else ("cuda" if use_pallas else "library"),
        "device": torch.cuda.get_device_name(0),
        "card": card(),
    }))


if __name__ == "__main__":
    main()
