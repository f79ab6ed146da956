"""Operations and bytes of EVA02-CLIP under AA-CLIP and of the kernels that
its block adds, from shapes, as ``benchmark/flops.py`` counts them (a
multiply-add is two operations; the model's mathematics, not what an
implementation does again; any ``img_size``). The trained heads and the
maps are ``flops.py``'s: they do not depend on the vision tower's block."""
from __future__ import annotations

from benchmark import flops


def hidden(cfg) -> int:
    """The SwiGLU MLP's hidden width, ``int(width * mlp_ratio)`` as EVA-CLIP
    takes it (2730 at width 1024)."""
    v = cfg["vision"]
    return int(v["width"] * v["mlp_ratio"])


def block_forward(n: int, d: int, h: int) -> float:
    """One EVA-02 block on n tokens of width d, hidden h: the qkv and out
    products, the MLP's three (W1, W2 and W3) and attention's two (QK^T and
    PV). The rotation, the LayerNorms and SiLU are not products."""
    return 2 * n * d * 3 * d + 2 * n * d * d + 2 * n * d * h * 3 + 4 * n * n * d


def infer_image(cfg) -> float:
    """One image through the predict program: patch embedding, the EVA-02
    tower, the trained heads, the maps."""
    g, d, ps = cfg["img_size"] // cfg["patch_size"], cfg["vision"]["width"], cfg["patch_size"]
    tower = cfg["vision"]["layers"] * block_forward(flops.tokens(cfg), d, hidden(cfg))
    return 2 * g * g * 3 * ps * ps * d + tower + flops._heads(cfg) + flops._maps(cfg)


# -- kernels: (operations, bytes) of one call over a batch of b images --------

def swiglu_fwd(b: int, n: int, d: int, h: int) -> tuple:
    """LN2 -> W1, W2 -> SiLU * -> LN_ffn -> W3 -> residual over the h real
    hidden columns: three products; reads x and the three weights (bf16),
    writes and reads the hidden layer once each (bf16), writes y."""
    m = b * n
    return 2 * m * 3 * d * h, (2 * m * d + 3 * d * h + 2 * m * h) * 2


def rope_fwd(b: int, n: int, d: int, head_dim: int = 64) -> tuple:
    """The rotation of q and k on the n - 1 patch rows: two products and a
    sum an element; reads and writes them (bf16), reads the cos and sin
    table once (float32, (n - 1, head_dim) each)."""
    elems = b * (n - 1) * 2 * d
    return 3 * elems, 2 * elems * 2 + 2 * (n - 1) * head_dim * 4
