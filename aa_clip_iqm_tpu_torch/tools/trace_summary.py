#!/usr/bin/env python
"""Summarise a profiler trace: the hottest ops by self time on each track,
or with ``--device`` the device's kernels by group.

    python -m aa_clip_iqm_tpu_torch.tools.trace_summary TRACE_DIR [--top 30]
        [--track NAME] [--device]

It reads the newest ``*.pt.trace.json[.gz]`` (what ``utils.profiling.trace``
and torch's TensorBoard handler write) or ``*.trace.json[.gz]`` under
TRACE_DIR, and exits nonzero when there is none. The port's counterpart of
the repo-root ``tools/trace_summary.py``, whose track view it keeps: complete
events (``ph == "X"``) per ``<process>/<thread>`` track, self time from a
stack sweep, so nested ranges are not counted twice. Flow events (torch's
``ac2g`` arrows) and instant events have no duration and are skipped.

``--device`` keeps the kernel events alone (``cat == "kernel"``), each
kernel's launches and self ms, grouped as ``chip_smoke.py`` groups them:
B1 ... B8 (the port's hand-written kernels), GEMM (cuBLAS), memcpy and
other. A group's launches are its kernels' events, so a port kernel made of
stages counts each (B2: its LayerNorm pass and two GEMMs, three a call). A
kernel replayed from a CUDA graph is a kernel event of its own on its
stream, so a replay's kernels are counted like eager launches.
"""
from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import sys


def find_trace(root: str) -> str:
    pats = [os.path.join(root, "**", "*.trace.json.gz"),
            os.path.join(root, "**", "*.trace.json")]
    hits = []
    for p in pats:
        hits += glob.glob(p, recursive=True)
    if not hits:
        raise SystemExit(f"no trace.json[.gz] under {root}")
    return max(hits, key=os.path.getmtime)


def load_events(path: str):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def summarize(events, track_filter=None):
    """Self time per op name per track, and each track's total.

    Complete events on one thread nest; a naive sum of durations counts a
    parent and its children twice. Events are swept in (ts, -dur) order with
    a stack of open intervals per track, and each child's duration is taken
    from its enclosing parent, so the self times sum to the track's busy
    time."""
    proc = {}
    thread = {}
    for e in events:
        if e.get("ph") == "M":
            if e.get("name") == "process_name":
                proc[e["pid"]] = e["args"].get("name", str(e["pid"]))
            elif e.get("name") == "thread_name":
                thread[(e["pid"], e.get("tid"))] = e["args"].get("name", "")
    by_thread = collections.defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        track = (f"{proc.get(e['pid'], e['pid'])}/"
                 f"{thread.get((e['pid'], e.get('tid')), e.get('tid'))}")
        if track_filter and track_filter.lower() not in track.lower():
            continue
        by_thread[track].append(e)

    per_track = collections.defaultdict(lambda: collections.defaultdict(float))
    track_total = collections.defaultdict(float)
    for track, evs in by_thread.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []  # (end_ts, index into selfs)
        selfs = []
        for e in evs:
            ts, dur = e["ts"], e["dur"]
            while stack and stack[-1][0] <= ts:
                stack.pop()
            if stack:
                selfs[stack[-1][1]][1] -= dur
            selfs.append([e.get("name", "?"), dur])
            stack.append((ts + dur, len(selfs) - 1))
        for name, sd in selfs:
            per_track[track][name] += max(sd, 0.0)
            track_total[track] += max(sd, 0.0)
    return per_track, track_total


def kernel_group(name: str) -> str:
    """The group of a device kernel, by its name: one of the port's
    hand-written kernels (B1 ... B9, B1's 112- and 72-wide instances; EVA-02's S1,
    its LayerNorm pass alone, and R1; the post-norm EVA block's products P1
    and its row pass P2), a cuBLAS GEMM, a copy, or other."""
    low = name.lower()
    if "attention_bwd" in low:
        return "B6 packed_attention_vv_bwd" if "<true>" in low else "B4 packed_attention_bwd"
    if "flash_attention" in low:
        return "B7 flash_attention"
    if "ln_attn_residual" in low:
        return "B8 ln_attn_residual"
    if "packed_attention_hd112" in low:
        return "B1 packed_attention_hd112"
    if "packed_attention_hd72" in low:
        return "B1 packed_attention_hd72"
    if "packed_attention" in low:
        return "B1 packed_attention"
    if "ln_residual_rows" in low:
        return "P2 ln_residual_rows"
    if "eva_postnorm" in low:
        return "P1 eva_postnorm_gemm"
    if "ln_mlp_residual_dx" in low:
        return "B5 ln_mlp_residual_dx"
    if "ln_mlp_residual_int8_probe" in low:
        return "B9 ln_mlp_residual_int8_probe"
    if "ln_mlp_residual_int8" in low:
        return "B3 ln_mlp_residual_int8"
    if "ln_mlp_residual" in low:
        return "B2 ln_mlp_residual"
    if "eva02_layer_norm" in low:
        return "S1 ln_swiglu_residual_layer_norm"
    if "ln_swiglu_residual" in low:
        return "S1 ln_swiglu_residual"
    if "rope_qk" in low:
        return "R1 rope_qk"
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    if any(k in low for k in ("gemm", "nvjet", "sm90_xmma", "cutlass", "imma", "i8816")):
        return "GEMM (cuBLAS)"
    return "other"


def is_kernel(e) -> bool:
    return e.get("ph") == "X" and e.get("cat", "").lower() == "kernel"


def device_summary(events):
    """The device's kernels by group: {group: {"launches": n, "ms": self ms,
    "kernels": {name: [launches, ms]}}}. A kernel's launches count its
    events; its ms is its self time on its stream's track."""
    kernels = [e for e in events if is_kernel(e)]
    launches = collections.Counter(e.get("name", "?") for e in kernels)
    per_track, _ = summarize([e for e in events if e.get("ph") == "M"] + kernels)
    ms = collections.defaultdict(float)
    for ops in per_track.values():
        for name, us in ops.items():
            ms[name] += us / 1e3
    groups = {}
    for name, n in launches.items():
        g = groups.setdefault(kernel_group(name), {"launches": 0, "ms": 0.0, "kernels": {}})
        g["launches"] += n
        g["ms"] += ms[name]
        g["kernels"][name] = [n, ms[name]]
    return groups


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--track", default=None,
                    help="substring filter on '<process>/<thread>' names")
    ap.add_argument("--device", action="store_true",
                    help="the device's kernels by group, with their launches")
    args = ap.parse_args(argv)
    path = find_trace(args.trace_dir)
    print(f"# {path}")
    events = load_events(path)
    if args.device:
        groups = device_summary(events)
        if not groups:
            raise SystemExit(f"{path} holds no kernel events (was the card traced?)")
        busy = sum(g["ms"] for g in groups.values())
        print(f"== device kernels (busy {busy:.2f} ms) ==")
        for group, g in sorted(groups.items(), key=lambda kv: -kv[1]["ms"]):
            print(f"  {g['ms']:9.2f} ms  {100 * g['ms'] / busy:5.1f}%  "
                  f"x{g['launches']:<6d} {group}")
            top = sorted(g["kernels"].items(), key=lambda kv: -kv[1][1])[:args.top]
            for name, (n, ms) in top:
                print(f"      {ms:9.2f} ms  x{n:<6d} {name[:100]}")
        return 0
    per_track, totals = summarize(events, args.track)
    for track in sorted(per_track, key=lambda t: -totals[t]):
        ops = per_track[track]
        total = totals[track]
        if total < 1000:  # skip sub-millisecond tracks
            continue
        print(f"\n== {track}  (total {total / 1e3:.1f} ms) ==")
        for name, dur in sorted(ops.items(), key=lambda kv: -kv[1])[:args.top]:
            print(f"  {dur / 1e3:9.2f} ms  {100 * dur / total:5.1f}%  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
