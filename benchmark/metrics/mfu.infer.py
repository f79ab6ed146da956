"""The predict program's share of the bf16 peak: the model's operations
for the images the window scored (``flops.infer_image``) over the window's
seconds."""
from benchmark import flops


def read(ctx):
    return 100.0 * flops.infer_image(ctx.config) * ctx.work["images"] / (
        ctx.trace.window_s * flops.PEAK_BF16)
