"""Reduction of a ``torch.profiler`` trace of the measured window.

What the readers of per-layer metrics and the result's ``device`` and
``breakdown`` take from the trace:

- the device's busy seconds (the union of its kernel, copy and set
  intervals) and the traced window's length;
- the self time of each device operation by name, and its launches;
- the idle gaps (the window less the busy intervals), each named by the
  innermost span of the harness (a ``record_function`` range whose name
  starts with ``bench/``) open on the host at the gap's middle.

:func:`kernel_group` is the grouping of kernel names that the program's
``tools/trace_summary.py`` makes (copied: the benchmark reads no module of
the program's tools), used for the breakdown's groups.
"""
from __future__ import annotations

import bisect
import collections
import re

SPAN_PREFIX = "bench/"


def kernel_group(name: str) -> str:
    """The group of a device kernel by its name: one of the program's
    hand-written kernels (B1 ... B9), a cuBLAS GEMM, a copy, or other."""
    low = name.lower()
    if "attention_bwd" in low:
        return "B6 packed_attention_vv_bwd" if "<true>" in low else "B4 packed_attention_bwd"
    if "flash_attention" in low:
        return "B7 flash_attention"
    if "ln_attn_residual" in low:
        return "B8 ln_attn_residual"
    if "packed_attention" in low:
        return "B1 packed_attention"
    if "ln_mlp_residual_dx" in low:
        return "B5 ln_mlp_residual_dx"
    if "ln_mlp_residual_int8_probe" in low:
        return "B9 ln_mlp_residual_int8_probe"
    if "ln_mlp_residual_int8" in low:
        return "B3 ln_mlp_residual_int8"
    if "ln_mlp_residual" in low:
        return "B2 ln_mlp_residual"
    if "memcpy" in low or "memset" in low:
        return "memcpy"
    if any(k in low for k in ("gemm", "nvjet", "sm90_xmma", "cutlass", "imma", "i8816")):
        return "GEMM (cuBLAS)"
    return "other"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """The device and host events of one profiled window, in microseconds
    on the profiler's clock."""

    def __init__(self, device_events, host_spans, window):
        # device_events: [(name, start_us, end_us)]; host_spans: [(name,
        # start_us, end_us)]; window: (start_us, end_us).
        self.window = window
        lo, hi = window
        self.device = [(n, max(s, lo), min(e, hi)) for n, s, e in device_events
                       if e > lo and s < hi]
        self.spans = sorted(host_spans, key=lambda x: x[1])
        self.busy = _merge([(s, e) for _, s, e in self.device])

    @classmethod
    def from_profiler(cls, prof, window):
        """From a finished ``torch.profiler.profile`` and the (start, end)
        of the window as ``bench/window`` span marks it (or None: the
        first and last event)."""
        from torch.autograd import DeviceType

        device, spans = [], []
        for evt in prof.events():
            tr = evt.time_range
            # A host range is mirrored on the device's timeline as a user
            # annotation: it is no operation of the device.
            annotation = getattr(evt, "is_user_annotation", False)
            if evt.device_type == DeviceType.CUDA:
                if not annotation and not evt.name.startswith(SPAN_PREFIX):
                    device.append((evt.name, tr.start, tr.end))
            elif evt.name.startswith(SPAN_PREFIX):
                spans.append((evt.name, tr.start, tr.end))
        if window is None:
            marks = [s for s in spans if s[0] == SPAN_PREFIX + "window"]
            if marks:
                window = (marks[0][1], marks[0][2])
            else:
                every = [(s, e) for _, s, e in device + spans]
                window = (min(s for s, _ in every), max(e for _, e in every))
        return cls(device, [s for s in spans if s[0] != SPAN_PREFIX + "window"], window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def ops(self):
        """{name: [launches, self seconds]} of the device operations. Device
        operations of one stream do not nest, so each one's duration is its
        self time."""
        out = collections.defaultdict(lambda: [0, 0.0])
        for n, s, e in self.device:
            out[n][0] += 1
            out[n][1] += (e - s) / 1e6
        return dict(out)

    def seconds_matching(self, include, exclude=()) -> tuple:
        """(launches, seconds) of the device operations whose names match a
        pattern of ``include`` and none of ``exclude`` (regular expressions,
        case-insensitive)."""
        inc = [re.compile(p, re.I) for p in include]
        exc = [re.compile(p, re.I) for p in exclude]
        n, sec = 0, 0.0
        for name, (k, s) in self.ops().items():
            if any(p.search(name) for p in inc) and not any(p.search(name) for p in exc):
                n, sec = n + k, sec + s
        return n, sec

    def idle_gaps(self):
        """{span name: idle seconds} over the window's gaps, each gap named
        by the innermost harness span open at its middle."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self.busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        starts = [s for _, s, _ in self.spans]
        longest = max((e - s for _, s, e in self.spans), default=0.0)
        out = collections.defaultdict(float)
        for s, e in gaps:
            mid = 0.5 * (s + e)
            name = "no harness span"
            # Spans sorted by start: the first one back from ``mid`` that
            # covers it is the innermost; none starts before mid - longest.
            for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                n, ss, se = self.spans[i]
                if se >= mid:
                    name = n
                    break
                if mid - ss > longest:
                    break
            out[name] += (e - s) / 1e6
        return dict(out)

    def breakdown(self, top=10) -> dict:
        ops = sorted(self.ops().items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}

    def groups(self) -> dict:
        """{group: seconds} by :func:`kernel_group`."""
        out = collections.defaultdict(float)
        for name, (_, s) in self.ops().items():
            out[kernel_group(name)] += s
        return dict(out)
