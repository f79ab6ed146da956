#!/usr/bin/env python3
"""The serving cell's knee: its window at several offered rates, one
set-up, one process.

    python3 benchmark/tools/sweep.py --workload http-518-poisson
        --rates 10,20,30 [--seconds 20] [--seed 1]

Per rate one JSON line: requests offered and answered, p50, p95 and max
latency, how late the client ran, the device batches, and whether the
backlog grew (the median latency of the last quarter of the requests over
that of the first). The knee is the highest rate whose requests all return
and whose backlog does not grow (that ratio under 1.5).
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path[0] = ROOT

from benchmark import harness, inputs  # noqa: E402
from benchmark.drivers.http import percentile  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="http-518-poisson")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("sweep: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cells = json.load(f)["workloads"]
    workload = inputs.load_json("workloads", args.workload)
    # A traffic file that no cell of BENCHMARK.json runs yet is read alone.
    cell = next((w for w in cells if w["name"] == args.workload),
                {"name": args.workload, "config": workload["config"], "chips": 1})
    run = harness.Run(workload=workload, config=inputs.load_json("configs", cell["config"]),
                      cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                      device=torch.device("cuda", 0), log=harness.log)
    d = harness.load_module("drivers", workload["driver"]).Driver(run)
    d.setup()
    knee = None
    for rate in (float(r) for r in args.rates.split(",")):
        workload["rate"] = rate
        out = d.window(args.seconds)
        lat = d.latencies
        q = max(1, len(lat) // 4)
        growth = float(np.median(lat[-q:]) / np.median(lat[:q]))
        ok = out["failed"] == 0 and growth < 1.5
        if ok:
            knee = rate
        print(json.dumps({"rate": rate, "offered": out["attempted"], "failed": out["failed"],
                          "p50_ms": percentile(lat, 50) * 1e3,
                          "p95_ms": percentile(lat, 95) * 1e3, "max_ms": max(lat) * 1e3,
                          "growth": growth, "batches": d.replays_window,
                          "requests_per_batch": (out["attempted"] - out["failed"])
                          / max(d.replays_window, 1), "sustained": ok}), flush=True)
    d.release()
    print(json.dumps({"knee": knee, "cell_rate": None if knee is None else 0.8 * knee}))


if __name__ == "__main__":
    main()
