"""The post-norm EVA block's row pass ``x + LN(z + bias)``
(``ln_residual_rows``), by bytes. Work: two calls per block of every
forward the window ran, over its batch."""
from benchmark import flops_eva02e
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"\bln_residual_rows_kernel\b"]
EXCLUDE = []


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_eva02e.postnorm_rows(w["batch"], tokens(ctx), v["width"]),
                    2 * w["calls"] * v["layers"])
