"""The frozen LN -> MLP -> residual half's input gradient: B5 (LayerNorm,
the dual GEMM, GEMM 3, the rows pass) today. Work: one call per block above
the first adapted one, per step of the window."""
from benchmark import flops
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"\bln_mlp_residual_dx_stage\b"]
EXCLUDE = []


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops.mlp_bwd(w["batch"], tokens(ctx), v["width"], v["mlp_ratio"]),
                    w["calls"] * (v["layers"] - 1))
