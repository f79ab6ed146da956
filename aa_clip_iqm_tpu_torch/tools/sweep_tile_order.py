"""Time the bf16 GEMM core's products alone at each tile order.

    python -m aa_clip_iqm_tpu_torch.tools.sweep_tile_order [--reps 20] [--groups 1,4,8,16,32]
        [--only W1,W2] [--out sweep.jsonl]

On a CUDA card: for each product of the table below, the core's launch
(``ops.gemm``'s wrappers, the core-alone entries) with its tiles in bands of
each ``--groups`` M-tiles (1 is N-tiles fastest), and with the band that
``ops.gemm.tile_group`` chooses. Each band's output is held bit for bit to
the N-fastest order's. Every round takes the bands in a new (seeded)
order and times, for each, one launch with CUDA events after a write of
128 MB that evicts the operands from L2 ("cold"), then a burst of 5 launches
back to back ("warm", the mean), so that a drift of the card's clock falls
on every band alike. The medians of ``--reps`` rounds are printed, with the
product's TFLOP/s and its time a k-slice of a tile (ms / waves of the SM
count / k-slices of 64).
"""
from __future__ import annotations

import argparse
import json
import random
import statistics
import subprocess
import time

import torch

from ..ops import gemm
from ..ops.layers import gelu

# name: (M, K, N, epilogue) -- "act" epilogue (a) with the exact GELU,
# "none" epilogue (a) without an activation, "f32" epilogue (d).
PRODUCTS = {
    "P1 W1 + GELU (EVA02-CLIP-E/14+, batch 16)": (21920, 1792, 15360, "act"),
    "P1 qkv": (21920, 1792, 5376, "none"),
    "P1 W2, fp32 out": (21920, 15360, 1792, "f32"),
    "P1 out-projection, fp32 out": (21920, 1792, 1792, "f32"),
    "B2 GEMM 1 + GELU (ViT-L/518, batch 32)": (43840, 1024, 4096, "act"),
    "B8 front qkv (ViT-L/518, batch 32)": (43840, 1024, 3072, "none"),
}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def launcher(m, k, n, epi, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=dev) * k ** -0.5).to(torch.bfloat16)
    b = torch.randn((n,), generator=gen, device=dev) * 0.1
    if epi == "f32":
        return lambda group: gemm.gemm_f32(a, w, group=group)
    act = gelu if epi == "act" else None
    return lambda group: gemm.gemm_bias_act(a, w, b, act, group=group)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--groups", default="1,4,8,16,32")
    p.add_argument("--only", default="", help="comma-separated parts of product names")
    p.add_argument("--out", default=None, help="append one JSON line per product here")
    args = p.parse_args(argv)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    sms, l2 = props.multi_processor_count, props.L2_cache_size
    print(f"# {card()}; {sms} SMs, L2 {l2} bytes; torch {torch.__version__}; "
          f"{time.strftime('%Y-%m-%d %H:%M:%S %Z')}", flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    shuffle = random.Random(0)
    only = [part for part in args.only.split(",") if part]
    for seed, (name, (m, k, n, epi)) in enumerate(PRODUCTS.items()):
        if only and not any(part in name for part in only):
            continue
        run = launcher(m, k, n, epi, dev, seed)
        bn = 256 if n % 256 == 0 else 128
        rule = gemm.tile_group(m, n, k, bn, sms, l2)
        groups = sorted({int(g) for g in args.groups.split(",")} | {rule})
        want = run(1)
        same = {g: bool(torch.equal(run(g), want)) for g in groups}
        del want
        cold, warm = {g: [] for g in groups}, {g: [] for g in groups}
        for _ in range(args.reps):
            for g in shuffle.sample(groups, len(groups)):
                flush.zero_()
                start.record()
                run(g)
                end.record()
                end.synchronize()
                cold[g].append(start.elapsed_time(end))
                start.record()
                for _ in range(5):
                    run(g)
                end.record()
                end.synchronize()
                warm[g].append(start.elapsed_time(end) / 5)
        tiles = -(-m // gemm.TILE_M) * (n // bn)
        waves, slices = tiles / min(sms, tiles), k // 64
        row = {"product": name, "m": m, "k": k, "n": n, "bn": bn, "rule": rule,
               "tiles": tiles, "groups": {}}
        print(f"{name}: M {m}, K {k}, N {n}, {tiles} tiles of 128 x {bn}; the rule's "
              f"band {rule}", flush=True)
        for g in groups:
            med, hot = statistics.median(cold[g]), statistics.median(warm[g])
            row["groups"][g] = {"cold_ms": med, "warm_ms": hot, "same_bits": same[g]}
            print(f"  band {g:3d}: cold {med:.4f} ms, warm {hot:.4f} ms "
                  f"({2 * m * n * k / hot / 1e9:.1f} TFLOP/s, "
                  f"{hot * 1e3 / waves / slices:.4f} us a k-slice of a tile); "
                  f"bits {'same' if same[g] else 'DIFFER'}", flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
