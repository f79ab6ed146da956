"""Operations and bytes of EVA02-CLIP-E/14+ under AA-CLIP and of the kernels
of its post-norm block, from shapes, as ``benchmark/flops.py`` counts them (a
multiply-add is two operations; the model's mathematics, not what an
implementation does again; any ``img_size``). The trained heads and the
maps are ``flops.py``'s: they do not depend on the vision tower's block."""
from __future__ import annotations

from benchmark import flops


def hidden(cfg) -> int:
    """The MLP's hidden width, ``int(width * mlp_ratio)`` as EVA-CLIP takes
    it (15,360 at width 1,792)."""
    v = cfg["vision"]
    return int(v["width"] * v["mlp_ratio"])


def block_forward(n: int, d: int, h: int) -> float:
    """One post-norm block on n tokens of width d, hidden h: the qkv and out
    products, the MLP's two and attention's two (QK^T and PV). The
    LayerNorms and GELU are not products."""
    return 2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * h + 4 * n * n * d


def infer_image(cfg) -> float:
    """One image through the predict program: patch embedding, the post-norm
    tower, the trained heads, the maps."""
    g, d, ps = cfg["img_size"] // cfg["patch_size"], cfg["vision"]["width"], cfg["patch_size"]
    tower = cfg["vision"]["layers"] * block_forward(flops.tokens(cfg), d, hidden(cfg))
    return 2 * g * g * 3 * ps * ps * d + tower + flops._heads(cfg) + flops._maps(cfg)


# -- kernels: (operations, bytes) of one call over a batch of b images --------

def attn_fwd(b: int, n: int, d: int, head_width: int) -> tuple:
    """Softmax attention over all heads of ``head_width``: QK^T and PV;
    reads q, k and v (bf16), writes the output (bf16) and the log-sum-exp
    (float32 per head and row), as ``flops.attn_fwd`` counts at 64."""
    heads = d // head_width
    return 4 * b * n * n * d, b * n * (3 * d + d) * 2 + b * heads * n * 4


def postnorm_gemms(b: int, n: int, d: int, h: int) -> tuple:
    """The block's four products on the GEMM core: qkv (reads x and W_qkv,
    writes qkv, bf16), the out-projection (reads o and W_o, writes its
    float32 output), W1 (reads x and W1, writes the hidden layer, bf16) and
    W2 (reads the hidden layer and W2, writes its float32 output)."""
    m = b * n
    ops = 2 * m * d * (3 * d + d + 2 * h)
    nbytes = ((m * d + 3 * d * d + 3 * m * d) * 2 + (m * d + d * d) * 2 + m * d * 4
              + (m * d + d * h + m * h) * 2 + (m * h + h * d) * 2 + m * d * 4)
    return ops, nbytes


def postnorm_rows(b: int, n: int, d: int) -> tuple:
    """One row pass, ``x + LN(z + bias)``: eight operations an element (the
    bias, the two statistics' sums, the centring, the scale and shift, the
    residual); reads z (float32) and x (bf16) and the three float32 vectors,
    writes the new x (bf16)."""
    m = b * n
    return 8 * m * d, m * d * (4 + 2 + 2) + 3 * d * 4
