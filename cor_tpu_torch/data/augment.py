"""The training augmentation, the PyTorch port's counterpart of
``cor_tpu.data.augment``, on uint8 numpy images (HWC RGB, HW masks).

Every function draws from its ``np.random.Generator`` exactly as
``cor_tpu``'s does: the same calls, in the same order, with the same
arguments, so that a sample seeded by ``(seed, epoch, idx)`` is augmented
alike in both packages. The image operations are the ``preproc`` library's
(``native/preproc.cpp``), which reproduce Pillow's bits: there is no Pillow
path, so the card's machine (which has no Pillow) and a host with Pillow
augment alike.

- ``random_crop``: one crop of image and mask, centred, up to 30 px smaller
  on each axis;
- ``random_rotation``: with probability 0.2, both rotated by an integer
  angle in [-15, 15) degrees (Pillow's ``rotate(BICUBIC)``);
- ``color_enhance``: brightness, contrast, colour and sharpness factors
  drawn up front, then Pillow's ``ImageEnhance`` chain;
- ``random_pepper``: 0.15% of the mask's pixels set to 0 or 255;
- ``random_gaussian``: additive noise, defined but not in the chain (as in
  ``cor_tpu``);
- ``train_augment``: crop, rotation, colour, pepper.
"""

from __future__ import annotations

import numpy as np

from cor_tpu_torch.native.preproc import color_enhance_u8, rotate_bicubic_u8

CROP_BORDER = 30


def random_crop(img: np.ndarray, gt: np.ndarray, rng: np.random.Generator):
    h, w = img.shape[:2]
    cw = int(rng.integers(w - CROP_BORDER, w))
    ch = int(rng.integers(h - CROP_BORDER, h))
    if cw < 1 or ch < 1:
        raise ValueError(f"random_crop: a {h} x {w} image leaves a {ch} x {cw} crop")
    x0, y0, x1, y1 = (w - cw) >> 1, (h - ch) >> 1, (w + cw) >> 1, (h + ch) >> 1
    return img[y0:y1, x0:x1], gt[y0:y1, x0:x1]


def random_rotation(img: np.ndarray, gt: np.ndarray, rng: np.random.Generator):
    if rng.random() > 0.8:
        angle = int(rng.integers(-15, 15))
        img = rotate_bicubic_u8(img, angle)
        gt = rotate_bicubic_u8(gt, angle)
    return img, gt


def color_enhance(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    fb = int(rng.integers(5, 16)) / 10.0
    fc = int(rng.integers(5, 16)) / 10.0
    fcol = int(rng.integers(0, 21)) / 10.0
    fs = int(rng.integers(0, 31)) / 10.0
    return color_enhance_u8(img, fb, fc, fcol, fs)


def random_pepper(gt: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    arr = np.array(gt)
    noise_num = int(0.0015 * arr.shape[0] * arr.shape[1])
    if noise_num > 0:
        xs = rng.integers(0, arr.shape[0], noise_num)
        ys = rng.integers(0, arr.shape[1], noise_num)
        vals = rng.integers(0, 2, noise_num) * 255
        arr[xs, ys] = vals.astype(arr.dtype)
    return arr


def random_gaussian(img: np.ndarray, rng: np.random.Generator, mean: float = 0.1,
                    sigma: float = 0.35) -> np.ndarray:
    arr = np.asarray(img, dtype=np.float32)
    arr = arr + rng.normal(mean, sigma, arr.shape)
    return np.uint8(np.clip(arr, 0, 255))


def train_augment(img: np.ndarray, gt: np.ndarray, rng: np.random.Generator):
    """The training chain: crop, rotation, colour jitter (image), pepper
    (mask). ``img`` uint8 [H, W, 3], ``gt`` uint8 [H, W]."""
    img, gt = random_crop(img, gt, rng)
    img, gt = random_rotation(img, gt, rng)
    img = color_enhance(img, rng)
    gt = random_pepper(gt, rng)
    return img, gt
