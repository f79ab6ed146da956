"""Resize / blur as precomputed linear operators.

Counterpart of ``aa_clip_iqm_tpu/ops/interp.py``: the numpy operator
builders are copied as they are; :func:`apply_separable` runs the two
products in torch. Gaussian blur (reflect padding) at patch resolution
followed by a bilinear upsample collapses into two matmuls with precomputed
matrices: out = (U @ G) @ img @ (G.T @ U.T).
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def bilinear_matrix(src: int, dst: int, align_corners: bool) -> np.ndarray:
    """(dst, src) matrix M with (M @ x) == F.interpolate(x, dst, 'linear')."""
    M = np.zeros((dst, src), dtype=np.float64)
    if src == 1:
        M[:, 0] = 1.0
        return M.astype(np.float32)
    for i in range(dst):
        if align_corners:
            x = i * (src - 1) / (dst - 1) if dst > 1 else 0.0
        else:
            x = max((i + 0.5) * src / dst - 0.5, 0.0)
        x0 = int(np.floor(x))
        x0 = min(x0, src - 1)
        frac = x - x0
        x1 = x0 + 1 if x0 < src - 1 else x0
        M[i, x0] += 1.0 - frac
        M[i, x1] += frac
    return M.astype(np.float32)


def gaussian_kernel1d(kernel_size: int, sigma: float) -> np.ndarray:
    """Discrete Gaussian, normalized — matches kornia get_gaussian_kernel1d."""
    x = np.arange(kernel_size, dtype=np.float64) - kernel_size // 2
    if kernel_size % 2 == 0:
        x = x + 0.5
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _reflect_index(i: int, n: int) -> int:
    """np.pad mode='reflect' index folding (edge not repeated)."""
    if n == 1:
        return 0
    period = 2 * (n - 1)
    i = i % period
    if i < 0:
        i += period
    return i if i < n else period - i


def reflect_blur_matrix(n: int, kernel_size: int, sigma: float) -> np.ndarray:
    """(n, n) matrix equal to reflect-padded 1-D Gaussian convolution."""
    k = gaussian_kernel1d(kernel_size, sigma).astype(np.float64)
    half = kernel_size // 2
    M = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for t in range(kernel_size):
            M[i, _reflect_index(i + t - half, n)] += k[t]
    return M.astype(np.float32)


def blur_upsample_operator(src: int, dst: int, kernel_size: int, sigma: float):
    """Fused [blur -> bilinear align_corners=True upsample] operator (dst, src)."""
    U = bilinear_matrix(src, dst, align_corners=True).astype(np.float64)
    G = reflect_blur_matrix(src, kernel_size, sigma).astype(np.float64)
    return (U @ G).astype(np.float32)


def upsample_operator(src: int, dst: int, align_corners: bool):
    return bilinear_matrix(src, dst, align_corners)


@functools.lru_cache(maxsize=64)
def _device_operator(op_key, device):
    """The operator as a float32 tensor on ``device``, built once. Built
    outside inference mode, whoever asks first: a training step saves the
    cached tensor for its backward, which an inference tensor refuses."""
    kind, args = op_key
    fn = blur_upsample_operator if kind == "blur" else upsample_operator
    with torch.inference_mode(False):
        return torch.from_numpy(fn(*args)).to(device)


def apply_separable(op_h, op_w, img):
    """img (..., H, W) -> (..., H', W') via two full-fp32 matmuls.

    The JAX package runs these at Precision.HIGHEST: the score maps feed
    AUROC ranking, where reduced-precision products cost measurable parity.
    On the card a float32 matmul would run in TF32 if
    ``torch.backends.cuda.matmul.allow_tf32`` were on, so this refuses to run
    then.
    """
    if img.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("apply_separable needs full-fp32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    img = img.float()
    y = torch.matmul(op_h, img)                  # (..., H', W)
    return torch.matmul(y, op_w.transpose(0, 1))  # (..., H', W')


def resize_bilinear(img, dst_h: int, dst_w: int, align_corners: bool):
    """Bilinear resize of (..., H, W), parity with F.interpolate('bilinear')."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    return apply_separable(
        _device_operator(("up", (src_h, dst_h, align_corners)), img.device),
        _device_operator(("up", (src_w, dst_w, align_corners)), img.device),
        img,
    )


def blur_and_upsample(img, dst: int, kernel_size: int, sigma: float):
    """Gaussian blur at source res then align_corners=True upsample, fused."""
    src_h, src_w = img.shape[-2], img.shape[-1]
    return apply_separable(
        _device_operator(("blur", (src_h, dst, kernel_size, sigma)), img.device),
        _device_operator(("blur", (src_w, dst, kernel_size, sigma)), img.device),
        img,
    )
