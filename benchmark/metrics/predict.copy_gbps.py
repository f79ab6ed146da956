"""The rate of the detector's copies between host and device memory: the
bytes a call copies (the program's counters ``predict.bytes_in`` and
``predict.bytes_out`` over ``predict.calls``: the frames in, the maps and
scores out) times the window's calls, over the device seconds of the
window's ``Memcpy HtoD`` and ``Memcpy DtoH`` operations, in GB/s. In the
offline cells every such copy is the detector's."""
from benchmark.metrics._program import registry

INCLUDE = [r"^Memcpy HtoD", r"^Memcpy DtoH"]


def read(ctx):
    c = registry(ctx)
    if not c or not c.get("predict.calls"):
        return None
    _, seconds = ctx.trace.seconds_matching(INCLUDE)
    if seconds <= 0.0:
        return None
    per_call = (c.get("predict.bytes_in", 0) + c.get("predict.bytes_out", 0)) / c["predict.calls"]
    return per_call * ctx.work["calls"] / seconds / 1e9
