"""The attention forward core at head width 72: B1's third instance
(``packed_attention_hd72``), SigLIP So400m's 16 heads. Work: one call per
block of every forward the window ran, over its batch of 1,369-row
images."""
from benchmark import flops_siglip
from benchmark.metrics._kernels import roofline

INCLUDE = [r"attention_\w*kernel<[^>]*\bpacked_attention_hd72>"]
EXCLUDE = [r"attention_bwd"]


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_siglip.attn_fwd(w["batch"], flops_siglip.tokens(ctx.config),
                                          v["width"], v["head_width"]),
                    w["calls"] * v["layers"])
