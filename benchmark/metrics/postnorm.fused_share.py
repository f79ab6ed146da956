"""The share of the post-norm EVA block halves that took the block's
kernels, in percent: the program's counters ``postnorm.fused`` and
``postnorm.chain`` (each half counted as the program runs it: at the
warm-up and the graph's capture, not at its replays). None without them."""
from benchmark.metrics._program import registry


def read(ctx):
    c = registry(ctx)
    if not c:
        return None
    fused, chain = c.get("postnorm.fused", 0), c.get("postnorm.chain", 0)
    return 100.0 * fused / (fused + chain) if fused + chain else None
