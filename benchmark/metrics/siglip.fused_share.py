"""The share of SigLIP's vision block halves that took the block's kernels,
in percent: the program's counters ``siglip.fused`` and ``siglip.chain``
(each half counted as the program runs it: at the warm-up and the graph's
capture, not at its replays). None without them."""
from benchmark.metrics._program import registry


def read(ctx):
    c = registry(ctx)
    if not c:
        return None
    fused, chain = c.get("siglip.fused", 0), c.get("siglip.chain", 0)
    return 100.0 * fused / (fused + chain) if fused + chain else None
