"""The attention forward core at head width 112: B1's second instance
(``packed_attention_hd112``), EVA02-CLIP-E/14+'s 16 heads. Work: one call
per block of every forward the window ran, over its batch."""
from benchmark import flops_eva02e
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"attention_\w*kernel<[^>]*\bpacked_attention_hd112>"]
EXCLUDE = [r"attention_bwd"]


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE,
                    flops_eva02e.attn_fwd(w["batch"], tokens(ctx), v["width"], v["head_width"]),
                    w["calls"] * v["layers"])
