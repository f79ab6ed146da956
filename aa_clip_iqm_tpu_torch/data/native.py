"""ctypes binding of the native C++ image pipeline (``native/image_pipeline.cpp``).

Counterpart of ``aa_clip_iqm_tpu/data/native.py``, with the port's own copy
of the C++ source. At first use the source is compiled with the host's C++
compiler (``g++ -O3 -fPIC -shared -std=c++17``) into
``build/aa_clip_iqm_tpu_torch/libaaclip_data.so`` beside the package, and
rebuilt when the source is newer than the library. Where no compiler
exists (or the build fails) :func:`available` is False and the data layer
takes its PIL / numpy path. Every entry takes and returns numpy arrays. A
ctypes call releases the interpreter lock, so the transforms of the decode
pool's threads (``AACLIP_DATA_WORKERS``) run in parallel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR, PACKAGE_DIR

SOURCE = os.path.join(PACKAGE_DIR, "native", "image_pipeline.cpp")
LIB_PATH = os.path.join(BUILD_DIR, "libaaclip_data.so")
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib: Optional[ctypes.CDLL] = None
_load_failed = False
_lock = threading.Lock()
#: The compiler's output of the last build (empty when none ran).
BUILD_LOG = ""

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_F64 = ctypes.POINTER(ctypes.c_double)
_INT = ctypes.c_int


def _stale() -> bool:
    return (not os.path.isfile(LIB_PATH)
            or os.path.getmtime(SOURCE) > os.path.getmtime(LIB_PATH))


def _build():
    """Compile beside the final name, then rename into place, so that a
    concurrent loader never sees half a library."""
    global BUILD_LOG
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise OSError(f"g++ failed for {SOURCE}:\n{BUILD_LOG}")
    os.replace(tmp, LIB_PATH)


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building first if stale) the native library; None if it cannot
    be built or loaded."""
    global _lib, _load_failed, BUILD_LOG
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if _stale():
                _build()
            lib = ctypes.CDLL(LIB_PATH)
        except OSError as exc:   # no compiler, a failed build, a bad library
            BUILD_LOG = BUILD_LOG or str(exc)
            _load_failed = True
            return None
        lib.resize_bicubic_rgb_u8.argtypes = [_U8, _INT, _INT, _F32, _INT, _INT]
        lib.resize_nearest_mask_u8.argtypes = [_U8, _INT, _INT, _F32, _INT, _INT]
        lib.normalize_chw.argtypes = [_F32, _INT, _INT, _INT, _F32, _F32]
        lib.warp_affine_chw.argtypes = [_F32, _F32, _INT, _INT, _INT, _F64, _INT]
        lib.flip_chw.argtypes = [_F32, _F32, _INT, _INT, _INT, _INT, _INT]
        for fn in (lib.resize_bicubic_rgb_u8, lib.resize_nearest_mask_u8,
                   lib.normalize_chw, lib.warp_affine_chw, lib.flip_chw):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def _ptr(arr: np.ndarray, kind):
    return arr.ctypes.data_as(kind)


def _ndim(arr: np.ndarray, ndim: int, what: str):
    if arr.ndim != ndim:
        raise ValueError(f"{what}: expected {ndim} dimensions, got shape {arr.shape}")


def resize_bicubic_rgb(img_u8: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, 3) -> float32 (3, size, size) in [0, 1], PIL's bicubic
    resize within one level."""
    lib = load_library()
    img_u8 = np.ascontiguousarray(img_u8, np.uint8)
    _ndim(img_u8, 3, "resize_bicubic_rgb")
    if img_u8.shape[2] != 3:
        raise ValueError(f"resize_bicubic_rgb: expected (H, W, 3), got {img_u8.shape}")
    out = np.empty((3, size, size), np.float32)
    lib.resize_bicubic_rgb_u8(_ptr(img_u8, _U8), img_u8.shape[0], img_u8.shape[1],
                              _ptr(out, _F32), size, size)
    return out


def resize_nearest_mask(mask_u8: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W) -> float32 (size, size) in {0, 1}, PIL's nearest
    sampling, nonzero -> 1."""
    lib = load_library()
    mask_u8 = np.ascontiguousarray(mask_u8, np.uint8)
    _ndim(mask_u8, 2, "resize_nearest_mask")
    out = np.empty((size, size), np.float32)
    lib.resize_nearest_mask_u8(_ptr(mask_u8, _U8), mask_u8.shape[0], mask_u8.shape[1],
                               _ptr(out, _F32), size, size)
    return out


def normalize_chw(img: np.ndarray, mean, std) -> np.ndarray:
    """(img - mean) / std per channel of a float32 (C, H, W) image, in place
    when ``img`` is already a contiguous float32 array; returns it."""
    lib = load_library()
    img = np.ascontiguousarray(img, np.float32)
    _ndim(img, 3, "normalize_chw")
    mean = np.ascontiguousarray(mean, np.float32).reshape(-1)
    std = np.ascontiguousarray(std, np.float32).reshape(-1)
    if mean.size != img.shape[0] or std.size != img.shape[0]:
        raise ValueError(f"normalize_chw: {img.shape[0]} channels, {mean.size} means "
                         f"and {std.size} deviations")
    lib.normalize_chw(_ptr(img, _F32), img.shape[0], img.shape[1], img.shape[2],
                      _ptr(mean, _F32), _ptr(std, _F32))
    return img


def warp_affine_chw(stack: np.ndarray, M: np.ndarray,
                    bilinear: bool = False) -> np.ndarray:
    """cv2.warpAffine's warp (zeros outside) of a float32 (C, H, W) stack by
    the 2x3 forward matrix ``M``. Nearest neighbour by default, the
    torchvision default for RandomRotation / RandomAffine, which keeps the
    mask channel binary."""
    lib = load_library()
    stack = np.ascontiguousarray(stack, np.float32)
    _ndim(stack, 3, "warp_affine_chw")
    M = np.ascontiguousarray(M, np.float64)
    if M.shape != (2, 3):
        raise ValueError(f"warp_affine_chw: M must be 2x3, got {M.shape}")
    out = np.empty_like(stack)
    lib.warp_affine_chw(_ptr(stack, _F32), _ptr(out, _F32), stack.shape[0],
                        stack.shape[1], stack.shape[2], _ptr(M, _F64), int(bilinear))
    return out


def flip_chw(stack: np.ndarray, horizontal: bool, vertical: bool) -> np.ndarray:
    """Horizontal and / or vertical flip of a float32 (C, H, W) stack."""
    lib = load_library()
    stack = np.ascontiguousarray(stack, np.float32)
    _ndim(stack, 3, "flip_chw")
    out = np.empty_like(stack)
    lib.flip_chw(_ptr(stack, _F32), _ptr(out, _F32), stack.shape[0], stack.shape[1],
                 stack.shape[2], int(horizontal), int(vertical))
    return out
