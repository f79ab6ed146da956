#!/usr/bin/env python3
"""One traced window of a cell read against the program's own spans and
counters: where the device's idle time falls among the program's stages,
and whether the host's ranges and the device's operations share a clock.

    python3 benchmark/tools/spans.py --workload <cell> --seed <n> [--seconds 30]

It sets the cell up as ``benchmark/run.py`` does, takes the program's
counters, runs the window under ``torch.profiler`` (the host's ``aaclip/``
ranges kept beside the device's operations, as the trace's
``program_spans``), takes the counters again and prints one JSON line:

- ``images``, ``window_s``, ``busy_s``, ``traced_images_per_s`` (the
  window's images over ``window_s``);
- ``metrics``: the per-layer metrics ``BENCHMARK.json`` lists for the cell,
  and ``predict.host_idle`` / ``step.host_idle``, which read program spans;
- ``idle_s``: {span name: idle device seconds while it is open}, each name
  counted once over its spans' union, ``(none)`` for idle time with no
  program span open; ``host_s``: {span name: seconds open};
- ``copies_inside``: {operation: the share of its device seconds inside the
  program's copy spans} for ``Memcpy DtoH`` (in ``*/copy_out``) and
  ``Memcpy HtoD`` (in ``*/copy_in``);
- ``ranges_as_ops``: device operations named ``aaclip/...`` (none: the
  program's ranges are no device work);
- ``window_counters``: what the window added to each counter, and
  ``setup_counters``: the counters before it.

Nothing is compared with the reference.
"""
import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, inputs  # noqa: E402
from benchmark.metrics import _program  # noqa: E402

SPAN_METRICS = ("predict.host_idle", "step.host_idle")


def split(trace, spans) -> dict:
    """The readings of the trace and program spans (see the module)."""
    gaps = _program.idle_gaps(trace)
    names = sorted({n for n, _, _ in spans})
    by_name = {n[len(_program.PROGRAM_PREFIX):]: _program.union(
        (s, e) for m, s, e in spans if m == n) for n in names}
    idle = {n: _program.overlap(gaps, u) / 1e6 for n, u in by_name.items()}
    every = _program.union((s, e) for _, s, e in spans)
    idle["(none)"] = (sum(e - s for s, e in gaps) - _program.overlap(gaps, every)) / 1e6
    inside = {}
    for op, stage in (("Memcpy DtoH", "copy_out"), ("Memcpy HtoD", "copy_in")):
        ops = _program.union((s, e) for n, s, e in trace.device if n.startswith(op))
        copies = _program.union((s, e) for n, u in by_name.items()
                                if n.endswith("/" + stage) for s, e in u)
        total = sum(e - s for s, e in ops)
        inside[op] = _program.overlap(ops, copies) / total if total else None
    return {"idle_s": idle,
            "host_s": {n: sum(e - s for s, e in u) / 1e6 for n, u in by_name.items()},
            "copies_inside": inside,
            "ranges_as_ops": sorted({n for n, _, _ in trace.device
                                     if n.startswith(_program.PROGRAM_PREFIX)})}


def main(argv=None, device=None, config=None, workload=None) -> dict:
    """One window; ``device``, ``config`` and ``workload`` replace the card
    and the cell's files in a rehearsal on the CPU."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from aa_clip_iqm_tpu_torch.utils import profiling

    from benchmark.trace import Trace

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    workload = workload or inputs.load_json("workloads", args.workload)
    config = config or inputs.load_json("configs", cell["config"])
    device = device or torch.device("cuda", 0)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("spans: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    run = harness.Run(workload=workload, config=config, cell=cell, seed=args.seed,
                      seconds=args.seconds, trace=True, device=device,
                      log=lambda msg: harness.log(f"at {time.perf_counter() - t0:.3f} s: {msg}"))
    driver = harness.load_module("drivers", workload["driver"]).Driver(run)
    driver.setup()
    harness.sync(device)
    before = profiling.counters()
    prof = profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []))
    with prof:
        with run.span("window"):
            result = driver.window(args.seconds)
        harness.sync(device)
    after = profiling.counters()
    tr = Trace.from_profiler(prof, None)
    tr.program_spans = _program.program_spans(prof, tr.window)
    del prof
    ctx = SimpleNamespace(trace=tr, work=result["work"], counters=driver.counters(),
                          config=config, workload=workload, cell=cell)
    names = [m["name"] for m in harness.cell_metrics(bench, args.workload, "per_layer")]
    metrics = {}
    for name in names + [n for n in SPAN_METRICS if n not in names]:
        value = harness.load_module("metrics", name).read(ctx)
        if value is not None:
            metrics[name] = float(value)
    driver.release()
    out = {"workload": args.workload, "seed": args.seed, "images": result["work"]["images"],
           "window_s": tr.window_s, "busy_s": tr.busy_s,
           "traced_images_per_s": result["work"]["images"] / tr.window_s,
           "metrics": metrics, **split(tr, tr.program_spans),
           "window_counters": {k: v - before.get(k, 0) for k, v in after.items()
                               if v != before.get(k, 0)},
           "setup_counters": before,
           "card": harness.card() if cuda else "cpu"}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
