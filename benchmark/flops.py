"""Operations and bytes of the model and of its kernels, from shapes.

A multiply-add counts two operations. The counts are of the model's
mathematics (what its inputs need), not of what an implementation does
again: a backward pass that recomputes a forward product is counted as the
kernel's inputs require it (the attention backward is given no probability
matrix, so it computes the logits again). Every function takes the
configuration file's dict and works at any ``img_size``.

Peaks of one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16,
3.35 TB/s HBM3.
"""
from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def tokens(cfg) -> int:
    """The vision tower's sequence: the patch grid and the class token."""
    grid = cfg["img_size"] // cfg["patch_size"]
    return grid * grid + 1


def block_forward(n: int, d: int, mlp_ratio: float = 4.0) -> float:
    """One pre-norm block on n tokens of width d: the qkv, out and two MLP
    products and attention's two (QK^T and PV)."""
    h = mlp_ratio * d
    return 2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * h + 4 * n * n * d


def block_backward_dx(n: int, d: int, mlp_ratio: float = 4.0) -> float:
    """The input gradient of one frozen block: each product's dx, and
    attention's dV, dP, dQ and dK."""
    h = mlp_ratio * d
    return 2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * h + 8 * n * n * d


def tower_blocks(cfg) -> float:
    v = cfg["vision"]
    return v["layers"] * block_forward(tokens(cfg), v["width"], v["mlp_ratio"])


def _heads(cfg) -> float:
    """The trained parts on the vision tower's taps: adapters, seg / det
    projections, the IQM branch, per image."""
    n, d = tokens(cfg), cfg["vision"]["width"]
    p = n - 1
    e, h = cfg["embed_dim"], cfg["iqm"]["hidden_size"]
    levels = len(cfg["adapter"]["levels"])
    adapters = cfg["adapter"]["image_adapt_until"] * 2 * n * d * d
    seg = levels * 2 * p * d * e + 2 * p * d * e
    query = levels * 2 * p * d * h + 2 * levels * p * h * h
    iqm_layer = (2 * 2 * levels * p * h * h          # cross-attention keys and values
                 + 2 * 2 * 2 * levels * p * h       # its logits and sum over 4 * p tokens
                 + 2 * 2 * 2 * cfg["iqm"]["text_encoder_hidden_size"] * h)
    return adapters + seg + query + cfg["iqm"]["num_hidden_layers"] * iqm_layer


def _maps(cfg) -> float:
    """Similarities and the separable resizes of the eight maps of an image
    (four text levels, four IQM levels)."""
    p = tokens(cfg) - 1
    g, s = cfg["img_size"] // cfg["patch_size"], cfg["img_size"]
    levels = len(cfg["adapter"]["levels"])
    resize = 2 * s * g * g + 2 * s * g * s
    return levels * (2 * p * cfg["embed_dim"] * 2 + 2 * p * cfg["embed_dim"] * 2) \
        + 2 * levels * resize


def infer_image(cfg) -> float:
    """One image through the predict program: patch embedding, the tower,
    the trained heads, the maps."""
    g, d, ps = cfg["img_size"] // cfg["patch_size"], cfg["vision"]["width"], cfg["patch_size"]
    return 2 * g * g * 3 * ps * ps * d + tower_blocks(cfg) + _heads(cfg) + _maps(cfg)


def train_image(cfg) -> float:
    """One image through the stage-2 step: the forward, the input gradient
    through every block above the first adapted one, twice the heads'
    operations for their weight and input gradients, and the maps' backward
    (the two-channel maps at full size, as many operations again)."""
    v = cfg["vision"]
    frozen_above = v["layers"] - 1
    back = frozen_above * block_backward_dx(tokens(cfg), v["width"], v["mlp_ratio"])
    fwd = infer_image(cfg) + _maps(cfg)
    return fwd + back + 2 * _heads(cfg) + 2 * _maps(cfg)


# -- kernels: (operations, bytes) of one call over a batch of b images --------

def attn_fwd(b: int, n: int, d: int) -> tuple:
    """Softmax attention over all heads of width d: QK^T and PV; reads q, k
    and v (bf16), writes the output (bf16) and the log-sum-exp (float32 per
    head and row, 64-wide heads)."""
    heads = d // 64
    return 4 * b * n * n * d, b * n * (3 * d + d) * 2 + b * heads * n * 4


def mlp_fwd(b: int, n: int, d: int, ratio: float = 4.0) -> tuple:
    """LayerNorm -> c_fc -> GELU -> c_proj -> residual: two products; reads
    x and both weights (bf16), writes y."""
    h = ratio * d
    return 2 * 2 * b * n * d * h, (2 * b * n * d + 2 * d * h) * 2


def attn_bwd(b: int, n: int, d: int) -> tuple:
    """Attention's backward from q, k, v, dO and the log-sum-exp: the logits
    again, dV, dP, dQ, dK; reads q, k, v, dO (bf16) and the log-sum-exp,
    writes dq, dk, dv (bf16)."""
    heads = d // 64
    return 10 * b * n * n * d, b * n * (4 * d + 3 * d) * 2 + b * heads * n * 4


def mlp_bwd(b: int, n: int, d: int, ratio: float = 4.0) -> tuple:
    """The frozen MLP half's input gradient from x and dy: c_fc again (its
    pre-activation is not an input), dy @ c_proj^T, then through GELU' and
    c_fc^T; reads x, dy and both weights, writes dx."""
    h = ratio * d
    return 3 * 2 * b * n * d * h, (3 * b * n * d + 2 * d * h) * 2


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations at the
    bf16 peak and bytes at the HBM peak."""
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)
