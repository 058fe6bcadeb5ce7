"""ctypes binding of the port's native data plane (``preproc.cpp``).

The library is built from ``preproc.cpp`` by the host's C++ compiler (g++,
which nvcc needs anyway) at its first use, into ``cor_tpu_torch/_build/``
(git-ignored) under a name that carries a hash of the source, the flags and
the machine, so an edited source is rebuilt and an unchanged one loaded as
it is: ``ops/kernels/_build.py``'s cache rules. A build writes a temporary
name and renames it into place, so processes that build at once all load a
whole library. A failed build raises; there is no fallback.

- ``resize_bilinear_u8``: Pillow's ``resize(BILINEAR)`` of a uint8 HWC (or
  HW) image, bit for bit;
- ``resize_normalize_f32``: the same resize, then ``(x / 255 - mean) / std``
  as float32 HWC (``cor_tpu.native.resize_normalize_f32``'s bits);
- ``png_unfilter``: a PNG's scanlines with their filters (types 0-4)
  undone;
- ``color_enhance_u8``: Pillow's ``ImageEnhance`` Brightness -> Contrast ->
  Color -> Sharpness chain on an RGB image, bit for bit
  (``cor_tpu.native.color_enhance_u8``'s bits);
- ``rotate_bicubic_u8``: Pillow's ``Image.rotate(angle, BICUBIC)``
  (``expand=False``, black fill) of an RGB or gray image, bit for bit.

Every call releases the GIL (ctypes), so the loader's threads scale.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("preproc.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# -ffp-contract=off: the normalize rounds its product and difference
# separately, as cor_tpu's build does; no -march=native, so a library built
# on one x86-64 host runs on another
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)


def _cxx() -> str:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler found ($CXX, g++, c++): cor_tpu_torch's preproc "
                       "library is built from cor_tpu_torch/native/preproc.cpp at first use")


def library_path() -> Path:
    """Where the library for the current source lives (built or not)."""
    h = hashlib.sha256(" ".join((*CXX_FLAGS, platform.machine())).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcor_preproc_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``preproc.cpp`` unless a library for it already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the preproc library failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


_LOCK = threading.Lock()
_LIB = []  # the loaded library, once


def library() -> ctypes.CDLL:
    """Build if needed, load once per process (the loader's threads that ask
    at once wait for one build), and declare the signatures."""
    if not _LIB:
        with _LOCK:
            if not _LIB:
                _LIB.append(_load(build()))
    return _LIB[0]


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    i = ctypes.c_int
    lib.cor_resize_bilinear_u8.argtypes = [_u8p, i, i, i, _u8p, i, i]
    lib.cor_resize_bilinear_u8.restype = None
    lib.cor_resize_normalize_f32.argtypes = [_u8p, i, i, i, _f32p, i, i, _f32p, _f32p]
    lib.cor_resize_normalize_f32.restype = None
    lib.cor_png_unfilter.argtypes = [_u8p, i, ctypes.c_longlong, i, _u8p]
    lib.cor_png_unfilter.restype = i
    f = ctypes.c_float
    lib.cor_color_enhance_u8.argtypes = [_u8p, i, i, f, f, f, f, _u8p]
    lib.cor_color_enhance_u8.restype = None
    lib.cor_affine_bicubic_u8.argtypes = [_u8p, i, i, i, ctypes.POINTER(ctypes.c_double), _u8p]
    lib.cor_affine_bicubic_u8.restype = None
    return lib


def _u8_hwc(img: np.ndarray, what: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"{what} takes a non-empty uint8 [H, W] or [H, W, C] image, got "
                         f"{img.dtype} {img.shape}")
    return img[:, :, None] if img.ndim == 2 else img


def _out_size(oh: int, ow: int, what: str) -> None:
    if int(oh) < 1 or int(ow) < 1:
        raise ValueError(f"{what}: the output size must be positive, got {oh} x {ow}")


def resize_bilinear_u8(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Pillow-BILINEAR-parity resize of a uint8 HWC (or HW) image -> uint8
    [oh, ow, C]."""
    src = _u8_hwc(img, "resize_bilinear_u8")
    _out_size(oh, ow, "resize_bilinear_u8")
    h, w, c = src.shape
    dst = np.empty((oh, ow, c), np.uint8)
    library().cor_resize_bilinear_u8(src.ctypes.data_as(_u8p), h, w, c,
                                     dst.ctypes.data_as(_u8p), oh, ow)
    return dst


def resize_normalize_f32(img: np.ndarray, oh: int, ow: int, mean: Optional[np.ndarray] = None,
                         std: Optional[np.ndarray] = None) -> np.ndarray:
    """Resize as ``resize_bilinear_u8``, then ``(x / 255 - mean) / std`` ->
    float32 [oh, ow, C] (mean 0 and std 1 where not given)."""
    src = _u8_hwc(img, "resize_normalize_f32")
    _out_size(oh, ow, "resize_normalize_f32")
    h, w, c = src.shape
    mean = np.zeros(c, np.float32) if mean is None else np.ascontiguousarray(mean, np.float32)
    std = np.ones(c, np.float32) if std is None else np.ascontiguousarray(std, np.float32)
    if mean.shape != (c,) or std.shape != (c,):
        raise ValueError(f"resize_normalize_f32: mean and std must have one value a channel "
                         f"({c}), got {mean.shape} and {std.shape}")
    dst = np.empty((oh, ow, c), np.float32)
    library().cor_resize_normalize_f32(src.ctypes.data_as(_u8p), h, w, c,
                                       dst.ctypes.data_as(_f32p), oh, ow,
                                       mean.ctypes.data_as(_f32p), std.ctypes.data_as(_f32p))
    return dst


def png_unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """The ``h`` scanlines of an inflated, non-interlaced PNG image (each a
    filter-type byte and ``rowbytes`` bytes) with their filters undone ->
    uint8 [h, rowbytes]. ``bpp``: the bytes of one pixel (1 below 8 bits)."""
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < h * (rowbytes + 1):
        raise ValueError(f"png: the image data holds {buf.size} bytes, {h} rows of "
                         f"{rowbytes + 1} need {h * (rowbytes + 1)}")
    out = np.empty((h, rowbytes), np.uint8)
    bad = library().cor_png_unfilter(buf.ctypes.data_as(_u8p), h, rowbytes, bpp,
                                     out.ctypes.data_as(_u8p))
    if bad:
        raise ValueError(f"png: scanline {bad - 1} has filter type "
                         f"{buf[(bad - 1) * (rowbytes + 1)]}, not 0-4")
    return out


def color_enhance_u8(img: np.ndarray, f_bright: float, f_contrast: float, f_color: float,
                     f_sharp: float) -> np.ndarray:
    """Pillow's ``ImageEnhance`` chain on a uint8 [H, W, 3] RGB image:
    Brightness, Contrast, Color, then Sharpness, each ``enhance(factor)``
    (the factors rounded to float32, as Pillow's ``blend`` takes them)."""
    src = np.ascontiguousarray(img)
    if src.dtype != np.uint8 or src.ndim != 3 or src.shape[2] != 3 or 0 in src.shape:
        raise ValueError(f"color_enhance_u8 takes a non-empty uint8 [H, W, 3] image, got "
                         f"{src.dtype} {src.shape}")
    h, w, _ = src.shape
    dst = np.empty_like(src)
    library().cor_color_enhance_u8(src.ctypes.data_as(_u8p), h, w, f_bright, f_contrast,
                                   f_color, f_sharp, dst.ctypes.data_as(_u8p))
    return dst


def rotation_matrix(angle: float, w: int, h: int):
    """The six entries of the affine matrix with which Pillow's
    ``Image.rotate(angle)`` (no ``center``, no ``translate``) samples its
    source: the rotation by ``-angle`` degrees, entries rounded to 15
    places, about (w / 2, h / 2); Python floats as Pillow computes them."""
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle % 360.0)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2], m[5] = m[0] * -cx + m[1] * -cy + m[2], m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return m


def rotate_bicubic_u8(img: np.ndarray, angle: float) -> np.ndarray:
    """Pillow's ``Image.rotate(angle, Image.BICUBIC)`` with ``expand=False``
    of a uint8 [H, W] ("L") or [H, W, 3] ("RGB") image: the same size, black
    where the rotated source does not reach. An angle of 0 (mod 360)
    returns a copy, as Pillow does; 90, 180 and 270, which Pillow turns into
    transposes, are refused."""
    src = np.ascontiguousarray(img)
    if src.dtype != np.uint8 or src.ndim not in (2, 3) or 0 in src.shape or (
            src.ndim == 3 and src.shape[2] != 3):
        raise ValueError(f"rotate_bicubic_u8 takes a non-empty uint8 [H, W] or [H, W, 3] "
                         f"image, got {src.dtype} {src.shape}")
    turn = float(angle) % 360.0
    if turn == 0.0:
        return src.copy()
    if turn in (90.0, 180.0, 270.0):
        raise ValueError(f"rotate_bicubic_u8: Pillow transposes at {angle} degrees; only "
                         f"other angles are ported")
    h, w = src.shape[:2]
    ch = 1 if src.ndim == 2 else 3
    m = (ctypes.c_double * 6)(*rotation_matrix(angle, w, h))
    dst = np.empty_like(src)
    library().cor_affine_bicubic_u8(src.ctypes.data_as(_u8p), h, w, ch, m,
                                    dst.ctypes.data_as(_u8p))
    return dst
