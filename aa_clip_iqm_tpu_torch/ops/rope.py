"""EVA-02's 2-D rotary embedding of q and k: its table, the kernel that
applies it to a packed projection, and the plain version.

No TPU kernel stands behind it: the JAX package has no EVA-02 tower. The
rotation sits between the packed qkv projection and the attention kernels
(B1 at 518 px, B7 above 8,192 tokens), which take the projection as it is,
so it is a pass of its own over the q and k columns of the patch rows
(``csrc/rope_qk.cu``, in place on the card; a new tensor on the CPU).

The table (:func:`rope_table`) holds, for the P patches of an S x S grid in
row-major order, ``cos`` and ``sin`` of the angles of one head of width hd:
patch (r, c) takes the positions ``tr = r * G / S`` and ``tc = c * G / S``
on the reference grid G (EVA-CLIP's ``pt_hw_seq_len`` with ``intp_freq``),
``w_j = 10000^(-j / (hd / 4))`` for j < hd / 4, and

    theta[2j] = theta[2j + 1] = tr * w_j            (the first hd / 2 dims)
    theta[hd/2 + 2j] = theta[hd/2 + 2j + 1] = tc * w_j   (the second half).

A head's z rotates as ``z * cos(theta) + rot(z) * sin(theta)``, ``rot(z)[2i]
= -z[2i + 1]``, ``rot(z)[2i + 1] = z[2i]``: each pair of neighbouring dims
by its angle. The class row is not rotated.
"""
from __future__ import annotations

from ctypes import c_int, c_long, c_void_p

import numpy as np
import torch

from ..utils.profiling import count, span
from . import _build
from .interp import device_constant

def rope_angles(grid: int, ref_grid: int, head_dim: int) -> np.ndarray:
    """(grid * grid, head_dim) float64 angles theta of the module docstring."""
    if head_dim % 4:
        raise ValueError(f"rotary embedding: head width {head_dim} is no multiple of 4")
    quarter = head_dim // 4
    omega = 10000.0 ** (-np.arange(quarter, dtype=np.float64) / quarter)
    pos = np.arange(grid, dtype=np.float64) * ref_grid / grid
    ang = np.repeat(pos[:, None] * omega[None, :], 2, axis=-1)       # (S, hd / 2)
    rows = np.broadcast_to(ang[:, None, :], (grid, grid, 2 * quarter))
    cols = np.broadcast_to(ang[None, :, :], (grid, grid, 2 * quarter))
    return np.concatenate([rows, cols], axis=-1).reshape(grid * grid, head_dim)


def _build_table(grid, ref_grid, head_dim):
    with span("setup/rope"):
        count("rope.tables")
        theta = rope_angles(grid, ref_grid, head_dim)
        return np.stack([np.cos(theta), np.sin(theta)]).astype(np.float32)


def rope_table(grid: int, ref_grid: int, head_dim: int, device):
    """The (2, grid * grid, head_dim) float32 table [cos; sin] on ``device``,
    made once per (grid, reference grid, head width, device) and kept
    (``interp.device_constant``): a model's set-up makes it (the detector's
    warm-up, before any capture), and a new image size makes another."""
    return device_constant(("rope", grid, ref_grid, head_dim), device,
                           lambda: _build_table(grid, ref_grid, head_dim))


def rotate(z, cos, sin):
    """``z * cos + rot(z) * sin`` in float32, rounded once to z's dtype. z
    (..., hd); cos and sin broadcast against it."""
    zf = z.float()
    pairs = zf.unflatten(-1, (-1, 2))
    rot = torch.stack((-pairs[..., 1], pairs[..., 0]), dim=-1).flatten(-2)
    return (zf * cos + rot * sin).to(z.dtype)


def rope_qk_reference(qkv, table, num_heads: int):
    """The plain version: the packed projection (B, L, 3w) with the q and k
    columns of rows 1.. rotated by ``table`` ((2, L - 1, hd), or per sample
    (2, B, L - 1, hd)), as a new tensor."""
    b, l, three_w = qkv.shape
    w = three_w // 3
    hd = w // num_heads
    cos, sin = table[0], table[1]
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    qk = qkv[:, 1:, :2 * w].unflatten(-1, (2 * num_heads, hd))
    turned = rotate(qk, cos[:, :, None, :], sin[:, :, None, :]).flatten(-2)
    out = qkv.clone()
    out[:, 1:, :2 * w] = turned
    return out


_KERNEL = _build.Entry("rope_qk", "rope_qk", [c_void_p] * 3 + [c_long] + [c_int] * 4)


def rope_qk(qkv, table, num_heads: int):
    """Rotate the q and k columns of the patch rows of ``qkv`` (B, L, 3w):
    on the card in place by the kernel (bf16, contiguous, heads of a width
    that is a multiple of 8), returning ``qkv``; on the CPU the plain
    version, returning a new tensor. ``table`` as in
    :func:`rope_qk_reference`, float32."""
    if qkv.device.type == "cpu":
        return rope_qk_reference(qkv, table, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"rope_qk: unsupported device {qkv.device}")
    b, l, three_w = qkv.shape
    w = three_w // 3
    hd = w // num_heads
    if qkv.dtype != torch.bfloat16 or not qkv.is_contiguous() or three_w % 3 or w % num_heads \
            or hd % 8:
        raise ValueError(f"rope_qk: takes a contiguous bf16 (B, L, 3w) projection with heads "
                         f"of a multiple of 8; got {tuple(qkv.shape)} {qkv.dtype}, "
                         f"{num_heads} heads")
    per_sample = table.dim() == 4
    rows = table.shape[-2]
    if (table.dtype != torch.float32 or not table.is_contiguous() or table.device != qkv.device
            or table.shape[-1] != hd or rows != l - 1 or (per_sample and table.shape[1] != b)):
        raise ValueError(f"rope_qk: table {tuple(table.shape)} {table.dtype} does not fit "
                         f"{tuple(qkv.shape)} with {num_heads} heads")
    stride_b = rows * hd if per_sample else 0
    _KERNEL(qkv.device, qkv.data_ptr(), table[0].data_ptr(), table[1].data_ptr(), stride_b, b,
            l, w, hd)
    return qkv
