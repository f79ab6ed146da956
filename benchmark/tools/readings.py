#!/usr/bin/env python3
"""The numbers a cell's comparison holds, over many seeds in one process:
the readings from which its limits are set.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3
        [--seconds 2] [--variant program|int8|half_batch]

``program`` runs the cell as configured; ``int8`` the program with its
int8 backbone tier switched on (``quantize="int8"``), the control of a
bf16 configuration; ``fp8_anchors`` (serving cells) the reference's text
tower on float8 products in place of the program's anchors, the anchors'
control (the program has no lower-precision text path); ``fp8_reference``
(training cells) the reference's step on float8 products in the program's
place, the control (the program's int8 tier leaves the trained heads and
the losses in bf16); ``half_batch``
(training cells) a planted fault, the step given half of each batch. Each seed makes its own weights and inputs,
sets the cell up, runs a window of ``--seconds`` and prints one JSON line
with every reading of the comparison (``readings()``).
"""
import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT

from benchmark import harness, inputs  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--variant", default="program", choices=("program", "int8", "fp8_anchors", "fp8_reference", "half_batch"))
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("readings: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    workload = inputs.load_json("workloads", args.workload)
    # A traffic file that no cell of BENCHMARK.json runs yet is read alone.
    cell = next((w for w in cells if w["name"] == args.workload),
                {"name": args.workload, "config": workload["config"], "chips": 1})
    if args.variant == "int8":
        workload["quantize"] = "int8"
    elif args.variant in ("fp8_anchors", "fp8_reference"):
        workload["control"] = args.variant
    elif args.variant == "half_batch":
        workload["fault"] = "half_batch"
    config = inputs.load_json("configs", cell["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(workload=workload, config=config, cell=cell, seed=seed,
                          seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                          log=harness.log)
        t0 = time.perf_counter()
        d = harness.load_module("drivers", workload["driver"]).Driver(run)
        d.setup()
        out = d.window(args.seconds)
        d.release()
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        r = d.readings()
        print(json.dumps({"workload": args.workload, "variant": args.variant, "seed": seed,
                          "readings": r, "metrics": out["metrics"],
                          "setup_and_window_s": t1 - t0,
                          "reference_s": time.perf_counter() - t1}), flush=True)
        del d
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
