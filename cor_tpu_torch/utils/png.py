"""PNG files without Pillow: a writer and a reader from the standard library
(``zlib`` + ``struct``) and the port's native data plane.

Writer: a signature, one IHDR (colour type 0, 2, 3 or 6, bit depth 8, no
interlace), a PLTE for a palette image, one IDAT holding every scanline
with one filter type (0 by default; 1-4 for tests of a reader), and IEND.
zlib level 1: the serving
masks are near-binary, and level 1 is the cheapest that still compresses
them well. ``png_encode_gray`` writes the serving path's and the
validator's mask files.

Reader: colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6
(RGBA) at bit depth 8, and gray and palette images at 1, 2 and 4 bits; the
IDAT stream inflated by ``zlib`` and the scanline filters undone by the
``preproc`` library (``png_unfilter_plain`` is the plain Python version the
tests hold it against). Interlaced (Adam7) and 16-bit files are refused by
name. ``mode`` gives what Pillow's ``convert("RGB")`` and ``convert("L")``
give: alpha dropped, a palette looked up, and L from RGB as
``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``.

``read_image`` reads a PNG with this reader and hands every other format
(JPEG) to Pillow, imported only then: where Pillow is not installed, such a
file is refused with an error that says so.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # samples a pixel, by colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(data, zlib.crc32(kind)) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(x: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Scanlines [h, rowbytes] filtered with one type (from the unfiltered
    bytes, so every type is a whole-array expression)."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[filter_type]
    return ((x - pred) & 0xFF).astype(np.uint8)


def png_encode(img: np.ndarray, level: int = 1, filter_type: int = 0,
               palette: np.ndarray = None) -> bytes:
    """uint8 [H, W] (gray, or palette indices with ``palette`` [n <= 256, 3]),
    [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> the bytes of a PNG file whose
    scanlines all use ``filter_type`` (0-4)."""
    img = np.ascontiguousarray(img)
    channels = 1 if img.ndim == 2 else (img.shape[2] if img.ndim == 3 else 0)
    if img.dtype != np.uint8 or channels not in (1, 3, 4) or 0 in img.shape:
        raise ValueError(f"png_encode takes a non-empty uint8 [H, W], [H, W, 3] or [H, W, 4], "
                         f"got {img.dtype} {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"png filter types are 0-4, got {filter_type}")
    plte = b""
    if palette is not None:
        palette = np.ascontiguousarray(palette, np.uint8)
        if channels != 1 or palette.ndim != 2 or palette.shape[1] != 3 or not (
                0 < len(palette) <= 256) or int(img.max()) >= len(palette):
            raise ValueError(f"a palette image is uint8 indices [H, W] below the palette's "
                             f"length, the palette [n <= 256, 3]; got {img.shape}, "
                             f"{palette.shape}")
        plte = _chunk(b"PLTE", palette.tobytes())
    h, w = img.shape[:2]
    rows = np.empty((h, w * channels + 1), np.uint8)
    rows[:, 0] = filter_type
    flat = img.reshape(h, w * channels)
    rows[:, 1:] = flat if filter_type == 0 else _filter_rows(flat, channels, filter_type)
    ctype = 3 if plte else {1: 0, 3: 2, 4: 6}[channels]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr) + plte
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def png_encode_gray(img: np.ndarray, level: int = 1) -> bytes:
    """uint8 [H, W] -> the bytes of a PNG file (filter type 0)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2 or 0 in img.shape:
        raise ValueError(f"png_encode_gray takes a non-empty uint8 [H, W], got "
                         f"{img.dtype} {img.shape}")
    return png_encode(img, level)


def png_unfilter_plain(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The plain Python version of ``native.preproc.png_unfilter``: row by
    row, Sub by a wrapping cumulative sum, Average and Paeth pixel by pixel
    (vectorized over the pixel's bytes)."""
    buf = np.frombuffer(raw, np.uint8)[:h * (rowbytes + 1)].reshape(h, rowbytes + 1)
    out = np.zeros((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int32)
    for y in range(h):
        t, line = int(buf[y, 0]), buf[y, 1:].astype(np.int32)
        if t == 0:
            cur = line
        elif t == 1:
            cur = np.zeros(rowbytes, np.int32)
            for k in range(min(bpp, rowbytes)):  # each byte lane: a cumulative sum
                cur[k::bpp] = np.cumsum(line[k::bpp]) & 0xFF
        elif t == 2:
            cur = (line + prev) & 0xFF
        elif t in (3, 4):
            cur = np.zeros(rowbytes, np.int32)
            for x in range(0, rowbytes, bpp):
                s = slice(x, x + bpp)
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prev[s]
                c = prev[x - bpp:x] if x else np.zeros(bpp, np.int32)
                pred = (a + b) >> 1 if t == 3 else _paeth(a, b, c)
                cur[s] = (line[s] + pred) & 0xFF
        else:
            raise ValueError(f"png: scanline {y} has filter type {t}, not 0-4")
        out[y] = cur
        prev = cur
    return out


def _gray_l(rgb: np.ndarray) -> np.ndarray:
    """Pillow's L from RGB: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def png_decode(data: bytes, mode: str, unfilter=None) -> np.ndarray:
    """A PNG file's pixels as Pillow's ``convert(mode)`` gives them: uint8
    [H, W, 3] for ``"RGB"``, [H, W] for ``"L"``. ``unfilter``: the scanline
    unfilter (default: the ``preproc`` library's)."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"png_decode gives mode 'RGB' or 'L', not {mode!r}")
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos, idat, palette, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"png: chunk {kind!r} is cut short")
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if ihdr is None or not idat:
        raise ValueError("png: no IHDR or no IDAT chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError("png: interlaced (Adam7) files are not read (cor_tpu_torch's reader "
                         "takes non-interlaced PNGs)")
    if depth == 16:
        raise ValueError("png: 16-bit files are not read (cor_tpu_torch's reader takes 8-bit "
                         "samples, and 1, 2 or 4 bits for gray and palette images)")
    if ctype not in _CHANNELS or (depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4))):
        raise ValueError(f"png: colour type {ctype} at bit depth {depth} is not a valid PNG")
    channels = _CHANNELS[ctype]
    rowbytes = (w * channels * depth + 7) // 8
    if unfilter is None:
        from cor_tpu_torch.native.preproc import png_unfilter as unfilter
    rows = unfilter(zlib.decompress(b"".join(idat)), h, rowbytes, max(1, channels * depth // 8))
    if depth < 8:
        px = np.unpackbits(rows, axis=1).reshape(h, rowbytes * 8 // depth, depth)[:, :w]
        px = (px * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(2, dtype=np.uint8)
        if ctype == 0:  # Pillow scales gray samples to 0-255
            px = px * np.uint8(255 // ((1 << depth) - 1))
        pixels = px
    else:
        pixels = rows.reshape(h, w, channels) if channels > 1 else rows
    if ctype == 3:
        if palette is None:
            raise ValueError("png: a palette image without a PLTE chunk")
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        rgb = lut[pixels]
        return rgb if mode == "RGB" else _gray_l(lut)[pixels]
    if ctype in (0, 4):
        gray = pixels if ctype == 0 else pixels[..., 0]
        return np.repeat(gray[..., None], 3, axis=2) if mode == "RGB" else np.ascontiguousarray(
            gray)
    rgb = pixels[..., :3]
    return np.ascontiguousarray(rgb) if mode == "RGB" else _gray_l(rgb)


def read_image(path, mode: str) -> np.ndarray:
    """An image file's pixels as Pillow's ``Image.open(path).convert(mode)``
    gives them (``"RGB"``: uint8 [H, W, 3]; ``"L"``: [H, W]). A PNG is read by
    ``png_decode``; any other format (JPEG) by Pillow, imported here only."""
    data = Path(path).read_bytes()
    if data[:8] == _SIGNATURE:
        return png_decode(data, mode)
    try:
        from PIL import Image
    except ImportError as e:
        kind = "JPEG" if data[:3] == b"\xff\xd8\xff" else "this format"
        raise RuntimeError(f"{path}: {kind} needs Pillow (PIL), which is not installed; "
                           "cor_tpu_torch reads PNG files without it") from e
    with Image.open(path) as im:
        return np.asarray(im.convert(mode))
