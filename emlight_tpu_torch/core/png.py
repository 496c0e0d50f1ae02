"""A stdlib PNG writer for the CLIs' previews (8-bit RGB).

Each scanline carries filter type 0 (none); the image data is one zlib
stream in one IDAT chunk, every chunk's CRC is zlib.crc32 over its type and
data (PNG specification, ISO/IEC 15948). The port writes its previews with
this, so it needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "encode_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 -> the bytes of a PNG file (8-bit truecolor)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 array, got {rgb.dtype} {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = rgb.reshape(h, 3 * w)
    # width, height, bit depth 8, colour type 2 (RGB), deflate, filter
    # method 0, no interlace
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
