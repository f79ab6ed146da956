"""What the readers of the program's own spans and counters share.

The program (``aa_clip_iqm_tpu_torch.utils.profiling``) keeps counters in
its process, ``counters()``, and names its host work with ``record_function``
ranges whose names start with ``aaclip/`` (``span``), on the profiler's clock
like the device's operations. A program without them (an older one) gives
nothing to read: every reader then returns None.

The readers read a run on the card: in a run whose traced window holds no
device operation (a rehearsal on the CPU) they read nothing.

Interval helpers work on (start, end) pairs in microseconds: a set of spans
counts as their union, so that nested and overlapping spans count once, and
it meets the device's idle gaps and operations by interval.
"""
from __future__ import annotations

from benchmark.trace import _merge as union  # sorted, disjoint [start, end] pairs

PROGRAM_PREFIX = "aaclip/"


def registry(ctx):
    """The program's counters {name: sum} after the window, or None where
    the program keeps none or the run was not on the card."""
    if not ctx.trace.device:
        return None
    from aa_clip_iqm_tpu_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return None if read is None else read()


def overlap(a, b) -> float:
    """Length of the intersection of two unions of intervals (each sorted
    and disjoint, as :func:`union` gives them)."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(trace):
    """The window's intervals with no operation on the device."""
    lo, hi = trace.window
    gaps, at = [], lo
    for s, e in trace.busy:
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def program_spans(prof, window):
    """[(name, start, end)] of the program's host ranges in a finished
    ``torch.profiler.profile``, clipped to ``window`` (the Trace's)."""
    from torch.autograd import DeviceType

    lo, hi = window
    return sorted(((e.name, max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in prof.events()
                   if e.device_type == DeviceType.CPU and e.name.startswith(PROGRAM_PREFIX)
                   and e.time_range.end > lo and e.time_range.start < hi),
                  key=lambda s: s[1])


def spans_named(spans, name):
    """The union of the spans ``aaclip/<name>``."""
    return union((s, e) for n, s, e in spans if n == PROGRAM_PREFIX + name)


def idle_share(ctx, name):
    """Percent of the window with the device idle while a span
    ``aaclip/<name>`` is open on the host; None without such spans (the
    trace's ``program_spans``, where it has them)."""
    spans = spans_named(getattr(ctx.trace, "program_spans", ()), name)
    if not ctx.trace.device or not spans:
        return None
    lo, hi = ctx.trace.window
    return 100.0 * overlap(idle_gaps(ctx.trace), spans) / (hi - lo)
