"""A small PNG writer for 8-bit grayscale images, from the standard library
alone (``zlib`` + ``struct``): the serving path's mask files, on machines
without Pillow.

The file is a signature, one IHDR (colour type 0, bit depth 8, no
interlace), one IDAT holding every scanline with filter type 0, and IEND.
zlib level 1, as the serving masks are near-binary and level 1 is the
cheapest that still compresses them well.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def png_encode_gray(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 [H, W] -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"png_encode_gray takes a non-empty uint8 [H, W], got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = 0  # filter type 0 (None) on every scanline
    rows[:, 1:] = img
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))
