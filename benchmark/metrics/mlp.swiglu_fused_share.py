"""The share of the EVA-02 MLP calls that took ``ln_swiglu_residual``,
in percent: the program's counters ``mlp.swiglu_fused`` and
``mlp.swiglu_chain`` (each call counted as the program runs it: at the
warm-up and the graph's capture, not at its replays). None without them."""
from benchmark.metrics._program import registry


def read(ctx):
    c = registry(ctx)
    if not c:
        return None
    fused, chain = c.get("mlp.swiglu_fused", 0), c.get("mlp.swiglu_chain", 0)
    return 100.0 * fused / (fused + chain) if fused + chain else None
