"""The EVA02-CLIP-E/14+ predict program's share of the bf16 peak: the
model's operations for the images the window scored
(``flops_eva02e.infer_image``) over the window's seconds."""
from benchmark import flops, flops_eva02e


def read(ctx):
    return 100.0 * flops_eva02e.infer_image(ctx.config) * ctx.work["images"] / (
        ctx.trace.window_s * flops.PEAK_BF16)
