"""Timing a chain of layers, for the probes (``probe_mlp_int8``,
``probe_mlp_int8_sweep``, ``probe_attn_fused``).

The JAX probes time each 24-deep chain inside one ``jit``. On the card the
port captures the chain once as a CUDA graph (``train.graphs.capture``,
after a warm-up call on a side stream) and times its replays with CUDA
events, so that no host launch overhead enters the time. On the CPU the
chain runs eagerly under the host clock, a number the callers label as the
host's.
"""
from __future__ import annotations

import time

import torch


def time_chain(fn, x, iters: int = 10, warmup: int = 3):
    """Milliseconds per call of ``fn(x)``, and where they were measured:
    ("cuda graph", ms) on the card, ("cpu host clock", ms) elsewhere."""
    if x.device.type != "cuda":
        for _ in range(warmup):
            fn(x)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(x)
        return "cpu host clock", (time.perf_counter() - t0) / iters * 1e3
    from ..train import graphs

    graph, _ = graphs.capture(lambda: fn(x), None, x.device)
    for _ in range(warmup):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize(x.device)
    ms = start.elapsed_time(end) / iters
    del graph
    return "cuda graph", ms


def rel_err(out, ref) -> float:
    """max |out - ref| / max |ref|, in float32."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max() / (ref.abs().max() + 1e-9)).item()
