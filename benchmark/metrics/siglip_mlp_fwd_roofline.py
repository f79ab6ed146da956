"""LayerNorm -> MLP -> residual of SigLIP's vision blocks: B2 (its LayerNorm
pass and two GEMMs, the first with the tanh-GELU epilogue) on the model's
4,304-wide hidden layer (the kernels pad it to 4,352; the work counted is
the model's). Work: one call per block of every forward the window ran,
over its batch of 1,369-row images."""
from benchmark import flops_siglip
from benchmark.metrics._kernels import roofline

INCLUDE = [r"\bln_mlp_residual_stage\b"]
EXCLUDE = []


def read(ctx):
    w, c = ctx.work, ctx.config
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_siglip.mlp_fwd(w["batch"], flops_siglip.tokens(c), c["vision"]["width"],
                                         flops_siglip.hidden(c)),
                    w["calls"] * c["vision"]["layers"])
