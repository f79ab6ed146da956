"""Resize / blur as precomputed linear operators.

Counterpart of ``aa_clip_iqm_tpu/ops/interp.py``: the numpy operator
builders, the bicubic one for the positional-embedding resize included, are
copied as they are; :func:`apply_separable` runs the two products in torch. Gaussian blur (reflect padding) at patch resolution
followed by a bilinear upsample collapses into two matmuls with precomputed
matrices: out = (U @ G) @ img @ (G.T @ U.T).
"""
from __future__ import annotations

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


#: Device constants built so far, by (key, device): real tensors only.
_DEVICE_CONSTANTS: dict = {}


def device_constant(key, device, build):
    """``torch.from_numpy(build())`` on ``device``, built once per (key,
    device) and kept. Built outside inference mode, whoever asks first: a
    training step saves the cached tensor for its backward, which an
    inference tensor refuses.

    Only a tensor that holds data is kept: one made under a tracer (a fake
    or functional tensor during ``torch.export``, or any meta tensor) is
    returned and forgotten, so a trace never leaves a stand-in behind for
    the eager calls after it. The first build is a copy from pageable host
    memory, which a CUDA graph capture forbids: it must come before the
    capture (the detector's warm-up run), and during a capture a missing
    constant raises."""
    from torch._subclasses.fake_tensor import is_fake

    device = torch.device(device)
    hit = _DEVICE_CONSTANTS.get((key, device))
    if hit is not None:
        return hit
    if (device.type == "cuda" and torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"device constant {key!r} is first built during a CUDA graph "
                           "capture; run the program once before capturing it")
    with torch.inference_mode(False):
        t = torch.from_numpy(np.ascontiguousarray(build())).to(device)
    if device.type != "meta" and not is_fake(t):
        _DEVICE_CONSTANTS[(key, device)] = t
    return t


def device_constants():
    """Every device constant built so far: what a CUDA graph whose program
    read some of them keeps alive, since the capture recorded their
    addresses."""
    return tuple(_DEVICE_CONSTANTS.values())


def _device_operator(op_key, device):
    """The operator as a float32 tensor on ``device``, built once
    (:func:`device_constant`)."""
    kind, args = op_key
    fn = blur_upsample_operator if kind == "blur" else upsample_operator
    return device_constant(("interp",) + op_key, device, lambda: fn(*args))


# Empties every device constant, as the ``functools.lru_cache`` this replaced did.
_device_operator.cache_clear = _DEVICE_CONSTANTS.clear


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


# --------------------------------------------------------------------------
# Bicubic (for the positional-embedding resize at load time)
# --------------------------------------------------------------------------

def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic kernel (a=-0.75 is torch's bicubic)."""
    ax = np.abs(x)
    w = np.zeros_like(ax)
    m1 = ax <= 1
    m2 = (ax > 1) & (ax < 2)
    w[m1] = (a + 2) * ax[m1] ** 3 - (a + 3) * ax[m1] ** 2 + 1
    w[m2] = a * ax[m2] ** 3 - 5 * a * ax[m2] ** 2 + 8 * a * ax[m2] - 4 * a
    return w


def bicubic_matrix(src: int, dst: int, antialias: bool = True) -> np.ndarray:
    """(dst, src) matrix matching F.interpolate(mode='bicubic',
    align_corners=False, antialias=antialias).

    torch's two bicubic paths differ:
      - antialias=True is the PIL-compatible separable resampler: Keys cubic
        with a=-0.5, kernel stretched by max(scale, 1), and the tap window
        clipped to the valid range then re-normalized (no edge replication);
      - antialias=False is the classic a=-0.75 kernel with out-of-range taps
        clamped to the edge (replicate).
    """
    M = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    if antialias:
        ss = max(scale, 1.0)
        support = 2.0 * ss
        for i in range(dst):
            center = (i + 0.5) * scale
            xmin = max(0, int(center - support + 0.5))
            xmax = min(src, int(center + support + 0.5))
            taps = np.arange(xmin, xmax)
            w = _cubic_weight((taps + 0.5 - center) / ss, a=-0.5)
            s = w.sum()
            if s != 0:
                w = w / s
            M[i, xmin:xmax] = w
    else:
        for i in range(dst):
            x = (i + 0.5) * scale - 0.5
            lo = int(np.floor(x)) - 1
            taps = np.arange(lo, lo + 4)
            w = _cubic_weight(taps - x, a=-0.75)
            for t, wt in zip(taps, w):
                M[i, min(max(t, 0), src - 1)] += wt
    return M.astype(np.float32)


def resize_grid_bicubic(grid: np.ndarray, new_hw, antialias: bool = True) -> np.ndarray:
    """Resize an (H, W, C) numpy grid bicubically (host side, load time)."""
    h, w, _ = grid.shape
    Mh = bicubic_matrix(h, new_hw[0], antialias).astype(np.float64)
    Mw = bicubic_matrix(w, new_hw[1], antialias).astype(np.float64)
    out = np.einsum("ph,hwc->pwc", Mh, grid.astype(np.float64))
    out = np.einsum("qw,pwc->pqc", Mw, out)
    return out.astype(grid.dtype)
