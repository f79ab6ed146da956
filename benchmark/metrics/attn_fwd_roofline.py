"""The attention forward core (QK^T, softmax, PV): B1 (packed qkv, up to
8,192 tokens) and B7 (split heads, above) today. Work: one call per block
of every forward the window ran, over its batch."""
from benchmark import flops
from benchmark.metrics._kernels import roofline, tokens

INCLUDE = [r"attention_\w*kernel<[^>]*\bpacked_attention>", r"attention_\w*kernel<[^>]*\bflash_attention>"]
EXCLUDE = [r"attention_bwd"]


def read(ctx):
    w, v = ctx.work, ctx.config["vision"]
    return roofline(ctx, INCLUDE, EXCLUDE, flops.attn_fwd(w["batch"], tokens(ctx), v["width"]),
                    w["calls"] * v["layers"])
