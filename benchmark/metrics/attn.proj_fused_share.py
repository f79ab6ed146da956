"""The share of the vision blocks' attention halves whose LayerNorm, qkv
and out-projection ran on B8's front and back kernels around the attention
kernel, in percent: the program's counters ``attn.proj_fused`` and
``attn.proj_chain`` (each call counted as the program runs it: at the
warm-up and the graph's capture, not at its replays). None without them."""
from benchmark.metrics._program import registry


def read(ctx):
    c = registry(ctx)
    if not c:
        return None
    fused, chain = c.get("attn.proj_fused", 0), c.get("attn.proj_chain", 0)
    return 100.0 * fused / (fused + chain) if fused + chain else None
