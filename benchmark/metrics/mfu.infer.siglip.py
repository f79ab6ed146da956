"""The SigLIP So400m/14 predict program's share of the bf16 peak: the
model's operations for the images the window scored
(``flops_siglip.infer_image``) over the window's seconds."""
from benchmark import flops, flops_siglip


def read(ctx):
    return 100.0 * flops_siglip.infer_image(ctx.config) * ctx.work["images"] / (
        ctx.trace.window_s * flops.PEAK_BF16)
