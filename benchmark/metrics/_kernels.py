"""What the kernel rooflines share: the share of the least time the work
could take (``benchmark/flops.py``) in the device time of the kernels that
did it, in percent; None where the window ran none of them."""
from __future__ import annotations

from benchmark import flops


def roofline(ctx, include, exclude, per_call, calls):
    """``per_call`` is (operations, bytes) of one call, ``calls`` how many
    the window made."""
    launches, seconds = ctx.trace.seconds_matching(include, exclude)
    if launches == 0 or seconds <= 0.0 or calls <= 0:
        return None
    return 100.0 * calls * flops.bound_s(*per_call) / seconds


def tokens(ctx):
    return flops.tokens(ctx.config)


def idle_share(ctx):
    """Percent of the traced window with nothing running on the device."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
