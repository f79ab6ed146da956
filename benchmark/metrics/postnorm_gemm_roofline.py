"""The post-norm EVA block's four products (qkv, out, W1, W2) on the GEMM
core under the ``eva_postnorm_stage`` tag. Work: one call of the four per
block of every forward the window ran, over its batch."""
from benchmark import flops_eva02e
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"gemm_\w*kernel<[^>]*\beva_postnorm_stage\b"]
EXCLUDE = []


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_eva02e.postnorm_gemms(w["batch"], tokens(ctx), v["width"],
                                                flops_eva02e.hidden(ctx.config)),
                    w["calls"] * v["layers"])
