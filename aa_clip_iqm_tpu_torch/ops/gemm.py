"""The Hopper GEMM core of B2, B5 and B8, and the plain versions of its stages.

B2 (``csrc/ln_mlp_residual.cu``), B5 (``csrc/ln_mlp_residual_dx.cu``) and B8
(``csrc/ln_attn_residual.cu``) run their products on one hand-written wgmma
GEMM core, ``csrc/gemm_sm90.cuh`` (see its header for the design), after a
row-wise LayerNorm pass. Each stage has a plain version with the kernel's
roundings:

- the LayerNorm pass is :func:`.layers.layer_norm` (fp32 statistics, one
  rounding to x's dtype);
- epilogue (a), :func:`gemm_bias_act_reference`: ``act(a @ w + b)`` in fp32,
  one rounding;
- epilogue (b), :func:`gemm_bias_residual_reference`: ``res + (a @ w + b)``
  in fp32, one rounding;
- the dual mode (c), :func:`gemm_dual_dact_reference`: ``(a2 @ w2t.T) *
  act'(a @ w + b)`` with both products in fp32, one rounding; ``w2t`` is a
  weight stored (out, in) and read K-major;
- epilogue (d), :func:`gemm_f32_reference`: ``(a @ w) * scale`` kept in fp32,
  with ``w`` stored (in, out) or, K-major, (out, in).

The int8 form (B3, ``csrc/ln_mlp_residual_int8.cu``) has its own row pass
and three epilogues on the s32 accumulator, each with a plain version that
follows the twin ``fused_mlp.ln_mlp_residual_int8_reference`` step by step
(exact int32 products, one fp32 rounding per multiply and add):

- the row pass, :func:`ln_quant_rows_reference`: LayerNorm in fp32,
  quantized per row (x_q, sx);
- GEMM 1's two steps: :func:`gemm_s8_amax_reference`, the hidden layer's
  maximum of |hid| per row and hidden chunk, which the kernel's tiles of a
  chunk exchange; :func:`gemm_s8_quant_reference`, h_q and sh from it;
- GEMM 2, :func:`gemm_s8_proj_reference`: the chunk products folded with
  sh, then the residual.

Their weights are the model's, int8 (in, out); the kernels read them
transposed.

The product is computed as :func:`.layers.linear` computes it before its
rounding, so that without an activation stage (a) equals ``linear`` bit for
bit. :func:`gemm_bias_act`, :func:`gemm_bias_residual`, :func:`gemm_f32` and
:func:`gemm_dual_dact` launch one product of the core alone on CUDA tensors
(the plain version on CPU tensors): the card tests and ``chip_smoke.py`` use
them; the model reaches the core through B2, B5 and B8, and through the
post-norm EVA block's own entries (``ops/postnorm.py``).
:func:`gelu_mismatches` holds the core's GELU to CUDA's erff.

The order in which the core's persistent grid takes its tiles is chosen
here, for every launch of the bf16 core: :func:`tile_group` is the rule,
:func:`tile_groups` applies it on a card, :func:`tile_order` is the order's
plain version, and :func:`count_grouped` counts the launches that take
bands as ``gemm.grouped``.
"""
from __future__ import annotations

import functools
import math
from ctypes import c_int, c_long, c_void_p as ptr

import torch

from ..utils.profiling import count
from . import _build
from .layers import gelu, gelu_tanh, layer_norm, quick_gelu
from .quant import int8_matmul

# Epilogue (a)'s activations, as the core numbers them (csrc/gemm_sm90.cuh).
_ACTS = {gelu: 0, quick_gelu: 1, None: 2, gelu_tanh: 3}

_SQRT_HALF = 0.7071067811865476
_INV_SQRT_2PI = 0.3989422804014327


def dgelu(x):
    """d/dx of the exact GELU: Phi(x) + x phi(x)."""
    return (0.5 * (1.0 + torch.erf(x * _SQRT_HALF))
            + x * _INV_SQRT_2PI * torch.exp(-0.5 * x * x))


def dquick_gelu(x):
    s = torch.sigmoid(1.702 * x)
    return s + x * 1.702 * s * (1.0 - s)


#: Each activation's exact derivative, as epilogue (c) takes it.
DACTS = {gelu: dgelu, quick_gelu: dquick_gelu}


def _acc_bias(a, w, b):
    """fp32 ``a @ w + b`` over the rows of ``a``, as ``linear`` takes it."""
    a2 = a.reshape(-1, a.shape[-1])
    w = w.to(a.dtype)
    if a.is_cuda and a.dtype != torch.float32:
        return torch.addmm(b.float(), a2, w, out_dtype=torch.float32)
    return torch.addmm(b.float(), a2.float(), w.float())


def gemm_bias_act_reference(a, w, b, act=None):
    """Epilogue (a): ``act(a @ w + b)`` in fp32, rounded once to a's dtype.
    a (..., K), w (K, N) stored (in, out), b (N,) -> (..., N)."""
    y = _acc_bias(a, w, b)
    if act is not None:
        y = act(y)
    return y.to(a.dtype).reshape(*a.shape[:-1], w.shape[-1])


def gemm_bias_residual_reference(a, w, b, res):
    """Epilogue (b): ``res + (a @ w + b)`` in fp32, rounded once to res's
    dtype. a (..., K), w (K, N), b (N,), res (..., N)."""
    y = res.reshape(-1, res.shape[-1]).float() + _acc_bias(a, w, b)
    return y.to(res.dtype).reshape(res.shape)


def _acc(a, w):
    """fp32 ``a @ w`` over the rows of ``a`` (w (K, N), any strides)."""
    return _acc_bias(a, w, torch.zeros(w.shape[-1], device=a.device))


def gemm_dual_dact_reference(a, w, b, a2, w2t, act):
    """The dual mode (c): ``(a2 @ w2t.T) * act'(a @ w + b)``, both products
    and the bias in fp32, rounded once to a's dtype. a, a2 (..., K); w
    (K, N) stored (in, out); w2t (N, K) stored (out, in), the K-major
    operand; b (N,)."""
    y = _acc(a2, w2t.t()) * DACTS[act](_acc_bias(a, w, b))
    return y.to(a.dtype).reshape(*a.shape[:-1], w.shape[-1])


def gemm_f32_reference(a, w, scale=None, w_kmajor: bool = False):
    """Epilogue (d): ``(a @ W) * scale`` in fp32, not rounded; W is w (K, N),
    or w.T for ``w_kmajor`` (w (N, K)); ``scale`` (N,) or None."""
    wt = w.t() if w_kmajor else w
    y = _acc(a, wt)
    if scale is not None:
        y = y * scale.float()
    return y.reshape(*a.shape[:-1], wt.shape[-1])


def quantize_rows(t):
    """Dynamic per-row symmetric int8 of fp32 ``t``: ``clip(rint(t / s),
    +-127)`` with ``s = max(amax |t|, 1e-6) / 127`` per row, a true division
    and round-half-to-even: (int8 values, fp32 scale (rows, 1))."""
    scale = t.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) * (1.0 / 127.0)
    return torch.clamp(torch.round(t / scale), -127, 127).to(torch.int8), scale


def ln_quant_rows_reference(ln_params, x, eps: float = 1e-5):
    """The int8 row pass: LayerNorm of x (M, d) in fp32, kept in fp32 and
    quantized per row: (x_q (M, d) int8, sx (M,) fp32)."""
    x_q, sx = quantize_rows(layer_norm(ln_params, x.float(), eps=eps))
    return x_q, sx.reshape(-1)


def _hidden_chunks(x_q, w_q, sx, s_fc, b_fc, act, ch):
    """GEMM 1's fp32 epilogue, one hidden chunk of ``ch`` columns at a time:
    ``act(float(x_q @ w_q[:, j]) * (sx * s_fc[j]) + b_fc[j])``."""
    n = w_q.shape[-1]
    sx, s_fc, b_fc = sx.reshape(-1, 1).float(), s_fc.reshape(n).float(), b_fc.float()
    for j in range(0, n, ch):
        hid = int8_matmul(x_q, w_q[:, j:j + ch].contiguous()).float()
        yield act(hid * (sx * s_fc[j:j + ch]) + b_fc[j:j + ch])


def gemm_s8_amax_reference(x_q, w_q, sx, s_fc, b_fc, act, ch):
    """GEMM 1's first step: the maximum of |hid| per row and ``ch``-wide hidden
    chunk, (M, N / ch) fp32. x_q (M, K) int8, w_q (K, N) int8, sx (M,), s_fc
    and b_fc (N,)."""
    return torch.stack([hid.abs().amax(dim=-1)
                        for hid in _hidden_chunks(x_q, w_q, sx, s_fc, b_fc, act, ch)], dim=-1)


def gemm_s8_quant_reference(x_q, w_q, sx, s_fc, b_fc, act, amax, ch):
    """GEMM 1's second step: ``sh = max(amax, 1e-6) / 127`` per (row, chunk) and
    ``h_q = clip(rint(hid / sh), +-127)``: (h_q (M, N) int8, sh (M, N / ch)
    fp32)."""
    sh = amax.clamp_min(1e-6) * (1.0 / 127.0)
    h_q = [torch.clamp(torch.round(hid / sh[:, i:i + 1]), -127, 127).to(torch.int8)
           for i, hid in enumerate(_hidden_chunks(x_q, w_q, sx, s_fc, b_fc, act, ch))]
    return torch.cat(h_q, dim=-1), sh


def gemm_s8_proj_reference(h_q, w_q, sh, s_proj, b_proj, x, ch):
    """GEMM 2: ``f = f + float(h_q[:, j] @ w_q[j]) * sh[:, j]`` over the
    ``ch``-wide chunks j from f = 0, then ``y = (x + f * s_proj) + b_proj``
    in fp32, rounded once to x's dtype. h_q (M, K) int8, w_q (K, N) int8,
    x (M, N)."""
    k, n = w_q.shape
    x32 = x.float()
    f = torch.zeros_like(x32)
    for i, j in enumerate(range(0, k, ch)):
        f = f + int8_matmul(h_q[:, j:j + ch].contiguous(), w_q[j:j + ch]).float() * sh[:, i:i + 1]
    return (x32 + f * s_proj.reshape(n).float() + b_proj.float()).to(x.dtype)


#: Rows of one of the core's tiles (BM in ``csrc/gemm_sm90.cuh``).
TILE_M = 128
#: The counter of the core's launches whose tiles go in bands of M-tiles.
GROUPED = "gemm.grouped"


def tile_group(m: int, n: int, k: int, bn: int, sms: int, l2_bytes: int,
               pairs: int = 1) -> int:
    """The M-tiles a band of the core's tile order holds, for the product
    (m, k) . (k, n) on ``bn``-wide tiles (``pairs`` products over the same
    tiles: 2 in the dual mode) on a card of ``sms`` SMs and ``l2_bytes`` of
    L2. 1 is N-tiles fastest over the whole grid.

    The persistent grid runs a tile an SM, so at each k-slice a wave of
    ``sms`` tiles reads the A rows of the M-tiles it spans and the weight
    columns of its N-tiles. N-tiles fastest, a wave spans every N-tile. That
    costs nothing where the weights stay in L2 from wave to wave (at most
    half of it: A and the output stream through the rest); else every wave
    reads all of them from HBM again. Bands of g M-tiles, M-tiles fastest in
    a band, make a wave g M-tiles by sms / g N-tiles: the band's A rows stay
    in L2 (at most half of it) while the band walks its N-tiles, and the
    weights are read once a band. g = sqrt(sms * bn / TILE_M) makes the A
    and weight bytes of a wave's k-slice equal, which is their least sum.
    No band where a wave would span every N-tile anyway."""
    m_tiles, n_tiles = -(-m // TILE_M), n // bn
    wave = min(sms, m_tiles * n_tiles)
    if 2 * pairs * k * n * 2 <= l2_bytes:
        return 1
    g = min(round(math.sqrt(wave * bn / TILE_M)), m_tiles,
            l2_bytes // (2 * pairs * TILE_M * k * 2))
    return 1 if g < 2 or g * n_tiles <= wave else g


def tile_order(m_tiles: int, n_tiles: int, group: int):
    """The plain version of the core's tile order (``tile_origin`` in
    ``csrc/gemm_sm90.cuh``): the (M-tile, N-tile) of each tile index in
    turn, in bands of ``group`` M-tiles (the last holds what is left),
    M-tiles fastest inside a band, then N-tiles."""
    group = max(1, min(group, m_tiles))
    order = []
    for t in range(m_tiles * n_tiles):
        first = t // (group * n_tiles) * group
        rows = min(group, m_tiles - first)
        r = t - first * n_tiles
        order.append((first + r % rows, r // rows))
    return order


@functools.lru_cache(maxsize=None)
def _card(index: int):
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.L2_cache_size


def tile_groups(device, *products):
    """:func:`tile_group` of each product ``(m, n, k, tile_n[, pairs])`` on
    ``device``'s card, ``tile_n`` 0 for the core's choice (256 where N
    allows, else 128)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms, l2_bytes = _card(index)
    return [tile_group(m, n, k, tile_n or (256 if n % 256 == 0 else 128), sms, l2_bytes, *pairs)
            for m, n, k, tile_n, *pairs in products]


def count_grouped(groups) -> None:
    """Count the launches among ``groups`` that take bands (``gemm.grouped``):
    after the launch, as ``launches.<entry>`` is counted."""
    grouped = sum(g > 1 for g in groups)
    if grouped:
        count(GROUPED, grouped)


def _group(device, m, n, k, tile_n, group, pairs=1):
    """The band for a product of the core alone: ``group`` where given
    (at most the M-tiles), else :func:`tile_group`'s."""
    if group is None:
        return tile_groups(device, (m, n, k, tile_n, pairs))[0]
    if group < 1:
        raise ValueError(f"gemm: group {group} must be at least 1")
    return min(group, -(-m // TILE_M))


# The core's products alone, each counted under its own entry's name.
_GEMM = _build.Entry("ln_mlp_residual", "ln_mlp_residual_gemm",
                     [ptr, c_int, ptr, c_int, ptr, ptr, c_int, ptr] + [c_int] * 7)
_GELU_CHECK = _build.Entry("ln_mlp_residual", "ln_mlp_residual_gelu_check", [c_long, c_long, ptr])
_GEMM_F32 = _build.Entry("ln_mlp_residual_dx", "ln_mlp_residual_dx_gemm_f32",
                         [ptr, c_int, ptr, c_int, c_int, ptr, ptr] + [c_int] * 6)
_GEMM_DUAL = _build.Entry("ln_mlp_residual_dx", "ln_mlp_residual_dx_gemm_dual",
                          [ptr, c_int, ptr, c_int, ptr, ptr, c_int, ptr, c_int, ptr] + [c_int] * 6)


def _launch(a, w, b, res, act, tile_n, group):
    fn = "gemm"
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {a.device}")
    k, n = w.shape
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: a and w must be bfloat16")
    if a.shape[-1] != k or b.shape != (n,) or (res is not None and res.shape[-1] != n):
        raise ValueError(f"{fn}: shapes do not match")
    if n % 128 or k % 64 or tile_n not in (0, 128, 256) or (tile_n and n % tile_n):
        raise ValueError(f"{fn}: N={n}, K={k}, tile_n={tile_n} not supported (N a multiple "
                         "of 128 and of the tile, K of 64)")
    if act not in _ACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    tensors = [a, w, b.float()] + ([res] if res is not None else [])
    for t in tensors:
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be contiguous, 16-byte aligned, on one card")
    m = a.numel() // k
    bias = tensors[2]
    group = _group(a.device, m, n, k, tile_n, group)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.bfloat16, device=a.device)
    _GEMM(a.device, a.data_ptr(), k, w.data_ptr(), n, bias.data_ptr(),
          res.data_ptr() if res is not None else None, n, out.data_ptr(), n, m, n, k,
          _ACTS[act], tile_n, group)
    count_grouped([group])
    return out


def _checked(fn, a, *tensors):
    """The operands the core takes: bf16 a and weights on one card,
    contiguous and 16-byte aligned (fp32 vectors may be None)."""
    if a.device.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {a.device}")
    for t in (a, *tensors):
        if t is None:
            continue
        if t.device != a.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{fn}: operands must be contiguous, 16-byte aligned, on one card")


def gemm_f32(a, w, scale=None, w_kmajor: bool = False, tile_n: int = 0, group=None):
    """:func:`gemm_f32_reference` through the core on a CUDA tensor: bf16 a
    (..., K) and w, N a multiple of 128, K of 64; ``tile_n`` 0, 128 or 256;
    ``group`` the M-tiles a band of the tile order (None: the rule's)."""
    if a.device.type == "cpu":
        return gemm_f32_reference(a, w, scale, w_kmajor)
    fn = "gemm_f32"
    n, k = w.shape if w_kmajor else w.shape[::-1]
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"{fn}: a and w must be bfloat16")
    if a.shape[-1] != k or (scale is not None and scale.shape != (n,)):
        raise ValueError(f"{fn}: shapes do not match")
    if n % 128 or k % 64 or tile_n not in (0, 128, 256) or (tile_n and n % tile_n):
        raise ValueError(f"{fn}: N={n}, K={k}, tile_n={tile_n} not supported (N a multiple "
                         "of 128 and of the tile, K of 64)")
    scale = None if scale is None else scale.float().contiguous()
    _checked(fn, a, w, scale)
    m = a.numel() // k
    group = _group(a.device, m, n, k, tile_n, group)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.float32, device=a.device)
    _GEMM_F32(a.device, a.data_ptr(), k, w.data_ptr(), w.shape[-1], int(w_kmajor),
              None if scale is None else scale.data_ptr(), out.data_ptr(), n, m, n, k, tile_n,
              group)
    count_grouped([group])
    return out


def gemm_dual_dact(a, w, b, a2, w2t, act, group=None):
    """:func:`gemm_dual_dact_reference` through the core on a CUDA tensor:
    bf16 a, a2 (..., K), w (K, N), w2t (N, K), N a multiple of 128, K of
    64; ``act`` GELU or QuickGELU; ``group`` as for :func:`gemm_f32`."""
    if a.device.type == "cpu":
        return gemm_dual_dact_reference(a, w, b, a2, w2t, act)
    fn = "gemm_dual_dact"
    k, n = w.shape
    if any(t.dtype != torch.bfloat16 for t in (a, w, a2, w2t)):
        raise TypeError(f"{fn}: a, a2 and the weights must be bfloat16")
    if a.shape != a2.shape or a.shape[-1] != k or w2t.shape != (n, k) or b.shape != (n,):
        raise ValueError(f"{fn}: shapes do not match")
    if n % 128 or k % 64:
        raise ValueError(f"{fn}: N={n}, K={k} not supported (N a multiple of 128, K of 64)")
    if act not in DACTS:
        raise ValueError(f"{fn}: unsupported activation {act!r}")
    bias = b.float().contiguous()
    _checked(fn, a, w, bias, a2, w2t)
    m = a.numel() // k
    group = _group(a.device, m, n, k, 128, group, 2)
    out = torch.empty((*a.shape[:-1], n), dtype=torch.bfloat16, device=a.device)
    _GEMM_DUAL(a.device, a.data_ptr(), k, w.data_ptr(), n, bias.data_ptr(), a2.data_ptr(), k,
               w2t.data_ptr(), k, out.data_ptr(), n, m, n, k, _ACTS[act], group)
    count_grouped([group])
    return out


def gemm_bias_act(a, w, b, act=None, tile_n: int = 0, group=None):
    """:func:`gemm_bias_act_reference` through the core on a CUDA tensor.
    bf16 a (..., K) and w (K, N), N a multiple of 128, K of 64; ``tile_n``
    0 (the core's choice), 128 or 256; ``group`` the M-tiles a band of the
    tile order (None: :func:`tile_group`'s)."""
    if a.device.type == "cpu":
        return gemm_bias_act_reference(a, w, b, act)
    return _launch(a, w, b, None, act, tile_n, group)


def gemm_bias_residual(a, w, b, res, tile_n: int = 0, group=None):
    """:func:`gemm_bias_residual_reference` through the core on a CUDA
    tensor; as :func:`gemm_bias_act`, res bf16 (..., N)."""
    if a.device.type == "cpu":
        return gemm_bias_residual_reference(a, w, b, res)
    return _launch(a, w, b, res, None, tile_n, group)


def gelu_mismatches(device, base: int = 0, n: int = 1 << 32) -> int:
    """The floats, as the bit patterns ``base`` .. ``base + n - 1`` (by
    default every one), at which the core's exact GELU or its erf differ
    from the same through CUDA's ``erff``, counted on ``device``."""
    if base < 0 or n <= 0 or base + n > 1 << 32:
        raise ValueError(f"gelu_mismatches: base={base}, n={n} is not a range of the 2^32 "
                         "float bit patterns")
    count = torch.zeros(1, dtype=torch.int64, device=device)
    for start in range(base, base + n, 1 << 28):
        _GELU_CHECK(device, start, min(1 << 28, base + n - start), count.data_ptr())
    return int(count.item())
