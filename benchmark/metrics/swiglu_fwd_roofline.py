"""LayerNorm -> SwiGLU with its sub-LN -> residual of the EVA-02 vision
blocks: ``ln_swiglu_residual`` (its LayerNorm pass and two products). Work:
one call per block of every forward the window ran, over its batch."""
from benchmark import flops_eva02
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"\bln_swiglu_residual_stage\b"]
EXCLUDE = []


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_eva02.swiglu_fwd(w["batch"], tokens(ctx), v["width"],
                                           flops_eva02.hidden(ctx.config)),
                    w["calls"] * v["layers"])
