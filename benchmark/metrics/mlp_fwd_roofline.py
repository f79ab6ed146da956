"""LayerNorm -> MLP -> residual of the vision blocks: B2 (its LayerNorm pass
and two GEMMs) today. Work: one call per block of every forward the window
ran, over its batch."""
from benchmark import flops
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"\bln_mlp_residual_stage\b"]
EXCLUDE = []


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops.mlp_fwd(w["batch"], tokens(ctx), v["width"], v["mlp_ratio"]),
                    w["calls"] * v["layers"])
