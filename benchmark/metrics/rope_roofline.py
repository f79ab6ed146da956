"""EVA-02's rotation of q and k on the packed projection: ``rope_qk``.
Work: one call per block of every forward the window ran, over its
batch."""
from benchmark import flops_eva02
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"\brope_qk_kernel\b"]
EXCLUDE = []


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_eva02.rope_fwd(w["batch"], tokens(ctx), v["width"], v["head_width"]),
                    w["calls"] * v["layers"])
