"""Seconds of set-up spent on CUDA graph captures (each a warm-up call and
the capture): the program's counter ``graphs.capture_s``."""
from benchmark.metrics._program import registry


def read(ctx):
    c = registry(ctx)
    return None if not c or "graphs.capture_s" not in c else c["graphs.capture_s"]
