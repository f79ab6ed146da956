#!/usr/bin/env python
"""One-command real-weights parity run: checkpoint -> convert -> [reference
adapters] -> per-dataset metric tables -> delta report against a table of
expected numbers.

    python -m aa_clip_iqm_tpu_torch.tools.parity_run \\
        --backbone /weights/ViT-L-14-336px.pt --datasets MVTec VisA \\
        --save_path ckpt/baseline --out parity_report

Counterpart of the JAX package's ``tools/parity_run.py``, with its flags,
outputs and exit codes. The adaptation weights (mutually exclusive):
  --save_path DIR        the port's training checkpoints (``cli.train``'s
                         stage-1 and newest stage-2 save). A JAX (orbax)
                         save_path goes through ``tools/orbax_to_torch.py``
                         first.
  --reference_ckpt DIR   the PyTorch reference's text_adapter.pth /
                         image_adapter_N.pth
  neither                zero-shot (raw CLIP anchors, untrained adapters)

The anchor table is a JSON file {dataset: {metric: value}} with metrics from
{"pixel AUC", "pixel AP", "image AUC", "image AP"} (keys starting with "_"
are ignored); the default is the repository's docs/expected_anchors.json, an
unverified transcription of the paper's headline rows (see its _provenance
block), read as a file. Each dataset's Average row is diffed against it; a
|pixel AUC delta| above --budget (0.2 points) fails the run with exit code
1. ``--anchor_table ""`` skips the deltas.

Outputs under --out: ``{dataset}.json`` (per-class rows and Average),
``{dataset}.txt`` (the reference-style table), ``report.md`` and
``report.json`` (the summary; its ``failed`` list mirrors the exit code).

It runs on ``cuda`` unless ``--device cpu`` is given. ``--use_pallas`` is
accepted and changes nothing: the port always runs its kernels. A dry run
needs no weights or data: ``--random_backbone`` and a synthetic dataset
registered through ``data.synthetic.register_synthetic``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..platform import default_device

METRICS = ("pixel AUC", "pixel AP", "image AUC", "image AP")
TIERS = ["int8", "int8_attn", "int8_mlp", "int8+smooth", "int8_attn+smooth",
         "int8_mlp+smooth"]
DEFAULT_ANCHORS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "docs", "expected_anchors.json")


def build_parser():
    p = argparse.ArgumentParser(
        description="one-command parity run: checkpoint -> tables -> deltas")
    p.add_argument("--model_name", default="ViT-L-14-336")
    p.add_argument("--img_size", type=int, default=518)
    p.add_argument("--backbone", default=None,
                   help="OpenAI .pt checkpoint or converted .npz cache")
    p.add_argument("--random_backbone", action="store_true",
                   help="dry-run mode: random backbone weights")
    p.add_argument("--datasets", nargs="+", default=["MVTec", "VisA"])
    p.add_argument("--save_path", default=None,
                   help="the port's training save_path (a JAX one after "
                   "tools/orbax_to_torch.py)")
    p.add_argument("--reference_ckpt", default=None,
                   help="PyTorch-reference checkpoint dir (.pth adapters)")
    p.add_argument("--anchor_table", default=DEFAULT_ANCHORS,
                   help="JSON {dataset: {metric: expected}} to diff against; "
                   "defaults to docs/expected_anchors.json (an unverified "
                   "transcription, see its _provenance block). '' skips it.")
    p.add_argument("--budget", type=float, default=0.2,
                   help="max |pixel AUC delta| (points) before FAIL")
    p.add_argument("--out", default="parity_report")
    p.add_argument("--metadata_root", default=None)
    p.add_argument("--image_batch_size", type=int, default=32)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--use_pallas", action="store_true",
                   help="accepted for the JAX tool's flag surface: the port "
                   "always runs its kernels")
    p.add_argument("--quantize_backbone", default=None, choices=TIERS,
                   help="evaluate an int8 inference tier instead of fp")
    p.add_argument("--seed", type=int, default=111)
    p.add_argument("--image_score_mode", default="fixed",
                   choices=["fixed", "reference_eval"],
                   help="'reference_eval' transcribes the reference's "
                   "executed eval image score")
    p.add_argument("--relu", action="store_true")
    p.add_argument("--device", default=default_device(),
                   help="cuda (default) or cpu; AACLIP_PLATFORM=cpu sets cpu")
    return p


def _build_datasets(args, name, logger):
    """Per-class eval datasets (uint8 images, normalized on the device)."""
    from ..data.datasets import get_dataset

    return get_dataset(name, args.img_size, None, -1, "test", logger=logger,
                       metadata_root=args.metadata_root, device_normalize=True)


def _calibration_batch(datasets, args, logger, n: int = 8):
    """Up to n CLIP-normalized test images of the first dataset's first
    class for the int8 outlier diagnostic; a seeded random batch when no
    data is reachable (logged as such)."""
    try:
        from ..data.datasets import normalize_clip

        ds = next(iter(datasets.values()))
        imgs = np.stack([ds[i]["image"] for i in range(min(n, len(ds)))])
        if imgs.dtype == np.uint8:
            imgs = normalize_clip(imgs.astype(np.float32) / 255.0)
        return imgs.astype(np.float32)
    except Exception as exc:  # noqa: BLE001 — the diagnostic falls back
        logger.warning("calibration falling back to a random batch "
                       "(real images unreachable: %s)", exc)
        rng = np.random.default_rng(0)
        return rng.standard_normal((4, 3, args.img_size, args.img_size)).astype(np.float32)


def run_dataset(args, dataset, frozen, trainable, model_cfg, adapt_text, dtype,
                logger, datasets=None):
    """One dataset's sweep: (rows, the results table)."""
    from ..configs import EvalConfig
    from ..evaluation.predict import evaluate_dataset, results_table
    from ..prompts import compute_frozen_anchors

    anchors = compute_frozen_anchors(frozen, trainable, model_cfg, dataset,
                                     adapted=adapt_text, compute_dtype=dtype)
    if datasets is None:
        datasets = _build_datasets(args, dataset, logger)
    eval_cfg = EvalConfig(
        dataset=dataset, img_size=args.img_size, batch_size=args.image_batch_size,
        seed=args.seed, save_path=args.out, compute_dtype=args.compute_dtype,
        image_score_mode=args.image_score_mode)
    rows = evaluate_dataset(frozen, trainable, model_cfg, eval_cfg, datasets, anchors,
                            logger=logger, compute_dtype=dtype)
    return rows, results_table(rows)


def average_row(rows):
    for row in rows:
        if row.get("class name") == "Average":
            return row
    raise RuntimeError("no Average row in results")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.save_path and args.reference_ckpt:
        raise SystemExit("--save_path and --reference_ckpt are exclusive")

    from ..loader import build_model_config, init_trainable, load_frozen_backbone
    from ..ops.quant import activation_outlier_ratio, calibrate_ln_amax, quantize_backbone_auto
    from ..train.checkpoint import restore_adapters
    from ..utils.misc import setup_logger, setup_seed

    setup_seed(args.seed)
    os.makedirs(args.out, exist_ok=True)
    logger = setup_logger(args.out, "parity.log")
    logger.info("parity run args: %s", vars(args))

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.compute_dtype]
    model_cfg = build_model_config(model_name=args.model_name, img_size=args.img_size,
                                   relu=args.relu)
    frozen = load_frozen_backbone(model_cfg, args.backbone, allow_random=args.random_backbone,
                                  device=args.device, dtype=dtype)
    trainable = init_trainable(model_cfg, seed=args.seed, device=args.device, dtype=dtype)

    adapt_text = False
    weights_mode = "zero-shot"
    if args.reference_ckpt:
        from ..models.convert import import_reference_checkpoints

        trainable = import_reference_checkpoints(args.reference_ckpt, trainable,
                                                 relu=args.relu)
        adapt_text = os.path.isfile(os.path.join(args.reference_ckpt, "text_adapter.pth"))
        weights_mode = f"reference adapters ({args.reference_ckpt})"
    elif args.save_path:
        try:
            trainable, adapt_text, epoch = restore_adapters(args.save_path, trainable)
        except FileNotFoundError as exc:
            raise SystemExit(str(exc))
        weights_mode = f"trained checkpoint ({args.save_path}, epoch {epoch})"

    # The int8 go/no-go diagnostic: the float backbone's post-LN activation
    # amax on a test batch, each quantized-matmul input site's max/median
    # channel ratio. The first dataset's eval sweep reuses its datasets.
    try:
        first_datasets = _build_datasets(args, args.datasets[0], logger)
    except Exception as exc:  # noqa: BLE001 — the sweep below builds again
        logger.warning("could not build %s datasets for calibration: %s",
                       args.datasets[0], exc)
        first_datasets = None
    outlier_ratios = None
    try:
        calib = _calibration_batch(first_datasets or {}, args, logger)
        stats = calibrate_ln_amax(
            frozen["visual"], model_cfg.clip.vision, calib, act_name=model_cfg.clip.act,
            adapters=trainable["image_adapter"]["layer_adapters"],
            adapter_weight=model_cfg.adapter.image_adapt_weight,
            adapt_until=model_cfg.adapter.image_adapt_until)
        outlier_ratios = activation_outlier_ratio(stats)
        logger.info("int8 outlier diagnostic (amax max/median per site): %s",
                    outlier_ratios)
    except Exception as exc:  # noqa: BLE001 — a diagnostic never fails the run
        logger.warning("outlier diagnostic skipped: %s", exc)

    if args.quantize_backbone:
        frozen = quantize_backbone_auto(frozen, args.quantize_backbone, cfg=model_cfg,
                                        trainable=trainable)
        weights_mode += f" + quantized backbone ({args.quantize_backbone})"

    anchor_table = {}
    if args.anchor_table and os.path.isfile(args.anchor_table):
        with open(args.anchor_table) as f:
            anchor_table = json.load(f)
        prov = anchor_table.get("_provenance", {})
        if isinstance(prov, dict) and "UNVERIFIED" in str(prov.get("status", "")):
            logger.warning("anchor table %s is an UNVERIFIED transcription — see its "
                           "_provenance block before treating a FAIL as a regression",
                           args.anchor_table)
    elif args.anchor_table:
        logger.warning("anchor table %s not found; deltas not evaluated", args.anchor_table)

    summary = {"weights": weights_mode, "budget_pt": args.budget,
               "int8_outlier_ratios": outlier_ratios, "datasets": {}}
    failed = []
    report = [
        "# Parity report", "",
        f"- weights: {weights_mode}",
        f"- backbone: {'RANDOM (dry run)' if args.random_backbone else args.backbone}",
        f"- operating point: {args.model_name} @ {args.img_size}px, {args.compute_dtype}, "
        f"{args.device}",
        f"- budget: |pixel AUC delta| <= {args.budget}pt",
        f"- int8 outlier diagnostic (amax max/median per site): {outlier_ratios}", "",
    ]
    for dataset in args.datasets:
        prebuilt = first_datasets if dataset == args.datasets[0] else None
        rows, table = run_dataset(args, dataset, frozen, trainable, model_cfg, adapt_text,
                                  dtype, logger, datasets=prebuilt)
        with open(os.path.join(args.out, f"{dataset}.json"), "w") as f:
            json.dump(rows, f, indent=1)
        with open(os.path.join(args.out, f"{dataset}.txt"), "w") as f:
            f.write(table + "\n")
        avg = average_row(rows)
        entry = {"average": {m: avg.get(m) for m in METRICS}}
        report += [f"## {dataset}", "", "```", table, "```", ""]
        expected = anchor_table.get(dataset)
        if expected:
            deltas = {m: round(avg[m] - expected[m], 3)
                      for m in METRICS if m in expected and m in avg}
            entry["expected"] = expected
            entry["delta"] = deltas
            ok = abs(deltas.get("pixel AUC", 0.0)) <= args.budget
            entry["pass"] = ok
            if not ok:
                failed.append(dataset)
            report.append(f"deltas vs expected: {deltas} -> {'PASS' if ok else 'FAIL'} "
                          f"(budget {args.budget}pt)")
        else:
            entry["pass"] = None
            report.append("_no expected numbers supplied for this dataset "
                          "(pass --anchor_table); deltas not evaluated_")
        report.append("")
        summary["datasets"][dataset] = entry
        print(f"[{dataset}]")
        print(table)

    summary["failed"] = failed
    with open(os.path.join(args.out, "report.md"), "w") as f:
        f.write("\n".join(report))
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(summary, f, indent=1)
    if failed:
        print(f"PARITY FAIL: {failed} exceeded the {args.budget}pt pixel-AUC budget")
        return 1
    print(f"parity run complete -> {args.out}/report.md")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
