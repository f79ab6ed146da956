"""The harness: one run of one cell (``benchmark/run.py`` is its entry).

A driver (``benchmark/drivers/<name>.py``) is a class ``Driver(run)`` with

- ``setup()``: weights, inputs, the program, every warm-up (``setup_s``);
- ``window(seconds) -> dict``: the measured window; returns ``attempted``,
  ``failed``, ``metrics`` (the end-to-end values by name) and ``work``
  (counts that the per-layer readers turn into rates);
- ``counters() -> dict``: the program's own counters after the window;
- ``release()``: drops the program's state;
- ``check() -> [(name, value, limit)]``: the comparison with the
  reference, each number passing when it is at most its limit.

``run`` carries the cell's files, the seed, the device and ``span(name)``:
a ``record_function`` range that names the host's work in a trace.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

from . import inputs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "aa_clip_iqm_tpu")


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Top-level names of loaded modules that this run may not load,
    compared whole (the program's own name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0].strip() if out else "unknown"


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The entries of ``BENCHMARK.json``'s ``end_to_end`` or ``per_layer``
    list that this cell reports."""
    if kind == "end_to_end":
        return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    e2e = {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e else [])]


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Run(SimpleNamespace):
    """What a driver is given."""

    def span(self, name: str):
        import torch

        return torch.profiler.record_function("bench/" + name)


def build_parser():
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def main(argv, t0: float, device=None, config=None, workload=None) -> int:
    """One run. ``device``, ``config`` and ``workload`` replace the card and
    the cell's files in a rehearsal on the CPU; the command passes none."""
    args = build_parser().parse_args(argv)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    workload = workload or inputs.load_json("workloads", args.workload)
    config = config or inputs.load_json("configs", cell["config"])

    import torch

    device = device or torch.device("cuda", 0)
    cuda = device.type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    # The configuration's float32 is float32: no TF32 anywhere.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(workload=workload, config=config, cell=cell, seed=args.seed,
              seconds=args.seconds, trace=bool(args.trace), device=device,
              log=lambda msg: log(f"at {time.perf_counter() - t0:.3f} s: {msg}"))
    driver = load_module("drivers", workload["driver"]).Driver(run)
    driver.setup()
    sync(device)
    setup_s = time.perf_counter() - t0
    log(f"setup_s {setup_s:.3f}")

    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if cuda else []))
        prof.__enter__()
    try:
        with run.span("window"):
            result = driver.window(args.seconds)
        sync(device)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    peak = (max(torch.cuda.max_memory_allocated(i) for i in range(cell["chips"]))
            if cuda else 0)
    counters = driver.counters()
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": int(result["attempted"]),
           "failed": int(result["failed"])}
    if args.trace:
        from .trace import Trace

        tr = Trace.from_profiler(prof, None)
        prof = None
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        ctx = SimpleNamespace(trace=tr, work=result["work"], counters=counters,
                              config=config, workload=workload, cell=cell)
        metrics = {}
        for m in cell_metrics(bench, args.workload, "per_layer"):
            value = load_module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out["metrics"] = metrics
        out["device"] = info
        out["breakdown"] = tr.breakdown()
        ops = tr.ops()
        log(f"trace: {sum(n for n, _ in ops.values())} device operations, "
            f"{sum(s for _, s in ops.values()):.6f} s in all, busy {tr.busy_s:.6f} s "
            f"of {tr.window_s:.6f} s")
        for group, sec in sorted(tr.groups().items(), key=lambda kv: -kv[1]):
            log(f"group {group}: {sec:.6f} s")
        for name, (n, sec) in sorted(ops.items(), key=lambda kv: -kv[1][1])[:25]:
            log(f"op {sec:.6f} s x{n} {name[:160]}")
    else:
        values = dict(result["metrics"], setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                          for m in cell_metrics(bench, args.workload, "end_to_end")}
        out["device"] = info
    log(f"card {card() if cuda else 'cpu'}; memory peak {peak} bytes; counters {json.dumps(counters)}")

    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = driver.check()
    out["correct"] = all(value <= limit for _, value, limit in checks)
    out["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
