"""The packed attention backward (dq, then dk and dv): B4 today. Work: one
call per block above the first adapted one, per step of the window."""
from benchmark import flops
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"attention_bwd"]
EXCLUDE = [r"<true>"]


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE, flops.attn_bwd(w["batch"], tokens(ctx), v["width"]),
                    w["calls"] * (v["layers"] - 1))
