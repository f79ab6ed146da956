"""Operations and bytes of SigLIP So400m/14 under AA-CLIP and of its
kernels, from shapes, as ``benchmark/flops.py`` counts them (a multiply-add
is two operations; the model's mathematics, not what an implementation does
again; any ``img_size``). The tower has no class row, so a 518 px image is
1,369 rows, not ``flops.tokens``' grid^2 + 1; the MLP's hidden width is the
model's ``int(width * mlp_ratio)``, 4,304, never the 4,352 that the kernels
pad it to."""
from __future__ import annotations

from benchmark import flops, flops_eva02e


def tokens(cfg) -> int:
    """The vision tower's rows: the patch grid alone."""
    grid = cfg["img_size"] // cfg["patch_size"]
    return grid * grid


def hidden(cfg) -> int:
    """The MLP's hidden width, ``int(width * mlp_ratio)`` (4,304 at width
    1,152)."""
    v = cfg["vision"]
    return int(v["width"] * v["mlp_ratio"])


#: One block on n rows of width d, hidden h: the qkv and out products, the
#: MLP's two and attention's two (QK^T and PV), as EVA02-CLIP-E/14+'s block
#: counts them (the norms' places move no product).
block_forward = flops_eva02e.block_forward


def map_head(n: int, d: int, h: int) -> float:
    """The attention pool on n rows: the rows' keys and values, the probe's
    query, one query's QK^T and PV, the out-projection and the MLP."""
    return 2 * n * d * 2 * d + 2 * d * d + 4 * n * d + 2 * d * d + 2 * 2 * d * h


def infer_image(cfg) -> float:
    """One image through the predict program: patch embedding, the tower,
    the attention pool, the trained heads, the maps (``flops.py``'s heads
    and maps, less the class row that its adapters count)."""
    g, d, ps = cfg["img_size"] // cfg["patch_size"], cfg["vision"]["width"], cfg["patch_size"]
    n, h = tokens(cfg), hidden(cfg)
    tower = cfg["vision"]["layers"] * block_forward(n, d, h)
    heads = flops._heads(cfg) - cfg["adapter"]["image_adapt_until"] * 2 * d * d
    return 2 * g * g * 3 * ps * ps * d + tower + map_head(n, d, h) + heads + flops._maps(cfg)


# -- kernels: (operations, bytes) of one call over a batch of b images --------

#: Softmax attention over all heads of a head width, as
#: ``flops_eva02e.attn_fwd`` counts it at 112.
attn_fwd = flops_eva02e.attn_fwd


def mlp_fwd(b: int, n: int, d: int, h: int) -> tuple:
    """LayerNorm -> fc1 -> GELU_tanh -> fc2 -> residual at hidden h: two
    products; reads x and both weights (bf16), writes y."""
    return 2 * 2 * b * n * d * h, (2 * b * n * d + 2 * d * h) * 2
