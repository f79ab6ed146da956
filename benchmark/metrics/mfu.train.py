"""The stage-2 step's share of the bf16 peak: the model's operations for
the images the window stepped (``flops.train_image``) over the window's
seconds."""
from benchmark import flops


def read(ctx):
    return 100.0 * flops.train_image(ctx.config) * ctx.work["images"] / (
        ctx.trace.window_s * flops.PEAK_BF16)
