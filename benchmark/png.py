"""PNG files of RGB uint8 images, written and read with the standard
library's zlib: every row with the Sub filter (the byte to its left
subtracted), which is how an encoder makes a smooth photograph compress.
The reference reads the request bodies with :func:`decode`, not with the
program's decoder."""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, Sub filter on every row)."""
    h, w, _ = rgb.shape
    rows = rgb.reshape(h, w * 3).astype(np.int16)
    sub = rows.copy()
    sub[:, 3:] -= rows[:, :-3]
    raw = np.empty((h, 1 + w * 3), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = (sub & 0xFF).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + _chunk(b"IEND", b""))


def decode(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, no interlace, filters None, Sub or Up) ->
    (H, W, 3) uint8."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    at, idat, hdr = 8, [], None
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        at += 12 + n
    w, h, depth, color, _, _, interlace = hdr
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"unsupported PNG: depth {depth}, color {color}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * 3)
    out = np.empty((h, w * 3), np.uint8)
    prev = np.zeros(w * 3, np.uint8)
    for y in range(h):
        f, row = raw[y, 0], raw[y, 1:]
        if f == 0:
            cur = row
        elif f == 1:
            cur = (np.cumsum(row.reshape(w, 3).astype(np.int64), axis=0) & 0xFF
                   ).astype(np.uint8).reshape(-1)
        elif f == 2:
            cur = row + prev
        else:
            raise ValueError(f"unsupported PNG filter {f}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, 3)
