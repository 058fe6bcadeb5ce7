"""Side-by-side comparison panels, the PyTorch port's counterpart of
``cor_tpu.eval.visualize``.

One PNG a triplet, ``{save_path}/visualizations/{pair_id}.png``: a canvas of
five equal panels with ``padding`` px gutters (query image | query GT mask |
prediction | support image | support mask, each resized to
``target_size``), and a caption below them (Sample ID, and the manifest's
Text, Compose, Dataset and Target joined by pair Id). The canvas is
``cor_tpu``'s, pixel for pixel outside the caption band:

- the images arrive ImageNet-normalised from the loader and are
  de-normalised as ``cor_tpu`` does, then resized with the ``preproc``
  library's Pillow-BILINEAR (``resize_bilinear_u8``, bit for bit);
- the masks and the prediction are binarised at 0.5, made 0/255 RGB and
  resized with Pillow's NEAREST mapping (``resize_nearest``);
- the canvas is white, ``5 w + 6 padding`` wide and ``h + 2 padding +
  lines x 12 + 2 padding`` high (``LINE_H``, the line height of Pillow's
  default bitmap font).

The caption is drawn in one way everywhere, with the port's own 5 x 8
bitmap font (``FONT``; printable ASCII, others drawn as ``?``), not Pillow's
``ImageDraw``: the card's machine has no Pillow, so every host writes the
same bytes. The PNG goes through ``utils/png.py``'s writer.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from cor_tpu_torch.data.pipeline import IMAGENET_MEAN, IMAGENET_STD

log = logging.getLogger("cor_tpu_torch.eval")

_TEXT_META = ("Text", "Compose", "Dataset", "Target")
LINE_H = 12  # the caption's line height, cor_tpu's (Pillow's default bitmap font)
GLYPH_W, GLYPH_ADVANCE = 5, 6
# printable ASCII (32-126), 5 columns a glyph, bit 0 of a column its top row
FONT = bytes.fromhex(
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 3649562050 0008070300 "
    "001c224100 0041221c00 2a1c7f1c2a 08083e0808 0080703000 0808080808 0000606000 2010080402 "
    "3e5149453e 00427f4000 7249494946 2141494d33 1814127f10 2745454539 3c4a494931 4121110907 "
    "3649494936 464949291e 0000140000 0040340000 0008142241 1414141414 0041221408 0201590906 "
    "3e415d594e 7c1211127c 7f49494936 3e41414122 7f4141413e 7f49494941 7f09090901 3e41415173 "
    "7f0808087f 00417f4100 2040413f01 7f08142241 7f40404040 7f021c027f 7f0408107f 3e4141413e "
    "7f09090906 3e4151215e 7f09192946 2649494932 03017f0103 3f4040403f 1f2040201f 3f4038403f "
    "6314081463 0304780403 6159494d43 007f414141 0204081020 004141417f 0402010204 4040404040 "
    "0003070800 2054547840 7f28444438 3844444428 384444287f 3854545418 00087e0902 18a4a49c78 "
    "7f08040478 00447d4000 2040403d00 7f10284400 00417f4000 7c0478047c 7c08040478 3844444438 "
    "fc18242418 182424187c 7c08040408 4854545424 04043f4424 3c4040207c 1c2040201c 3c4030403c "
    "4428102844 4c9090907c 4464544c44 0008364100 0000770000 0041360800 0201020402")


def denorm_u8(img: np.ndarray) -> np.ndarray:
    """[H, W, 3] ImageNet-normalised float -> uint8 RGB, as ``cor_tpu``."""
    x = img * IMAGENET_STD + IMAGENET_MEAN
    return np.clip(x * 255.0, 0, 255).astype(np.uint8)


def mask_u8(mask: np.ndarray, binarize: bool) -> np.ndarray:
    """[H, W] (or [H, W, 1]) float in [0, 1] -> uint8 [H, W, 3], 0/255."""
    m = np.asarray(mask, np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    if binarize:
        m = (m > 0.5).astype(np.float32)
    g = np.clip(m * 255.0, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _nearest_taps(n_in: int, n_out: int) -> np.ndarray:
    """Pillow's NEAREST source index of each output pixel along one axis:
    the position starts at half a step and grows by one step (n_in / n_out,
    in double) a pixel, truncated."""
    step = n_in / n_out
    pos = step * 0.5
    taps = np.empty(n_out, np.int64)
    for i in range(n_out):
        taps[i] = int(pos)
        pos += step
    return np.minimum(taps, n_in - 1)


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's ``resize(size, NEAREST)`` of an [H, W(, C)] array; ``size``
    is (width, height), as Pillow's."""
    tw, th = size
    return img[_nearest_taps(img.shape[0], th)][:, _nearest_taps(img.shape[1], tw)]


def draw_text(canvas: np.ndarray, xy: Tuple[int, int], text: str,
              color=(0, 0, 0)) -> None:
    """Draw ``text`` (lines split at newlines, ``LINE_H`` apart) into the
    uint8 [H, W, 3] ``canvas`` with ``FONT``, its top left at ``xy``;
    clipped at the canvas' edges."""
    h, w = canvas.shape[:2]
    x0, y0 = xy
    for li, line in enumerate(text.split("\n")):
        top = y0 + li * LINE_H
        for ci, ch in enumerate(line):
            code = ord(ch) if 32 <= ord(ch) <= 126 else ord("?")
            cols = FONT[(code - 32) * GLYPH_W:(code - 31) * GLYPH_W]
            left = x0 + ci * GLYPH_ADVANCE
            for dx, bits in enumerate(cols):
                for dy in range(8):
                    x, y = left + dx, top + dy
                    if bits >> dy & 1 and 0 <= x < w and 0 <= y < h:
                        canvas[y, x] = color


def sample_text(pair_id: int, meta) -> str:
    lines = [f"Sample ID: {pair_id}"]
    if meta is not None:
        for col, label in zip(_TEXT_META, ("Text", "Compose", "Dataset", "Target Class")):
            if col in meta:
                lines.append(f"{label}: {meta[col]}")
    return "\n".join(lines)


def render_panel(probs_i: np.ndarray, batch, i: int, meta_lookup, out_dir,
                 target_size: Tuple[int, int] = (256, 256), padding: int = 10) -> Path:
    """Write sample ``i``'s comparison canvas to ``{out_dir}/{pair_id}.png``."""
    from cor_tpu_torch.native.preproc import resize_bilinear_u8
    from cor_tpu_torch.utils.png import png_encode

    tw, th = target_size
    pair_id = int(batch["pair_id"][i])
    panels = [
        resize_bilinear_u8(denorm_u8(np.asarray(batch["query_img"][i])), th, tw),
        resize_nearest(mask_u8(np.asarray(batch["query_mask"][i]), True), target_size),
        resize_nearest(mask_u8(probs_i, True), target_size),
        resize_bilinear_u8(denorm_u8(np.asarray(batch["support_img"][i])), th, tw),
        resize_nearest(mask_u8(np.asarray(batch["support_mask"][i]), True), target_size),
    ]
    text = sample_text(pair_id, meta_lookup(pair_id))
    n_lines = text.count("\n") + 1
    height = th + 2 * padding + n_lines * LINE_H + 2 * padding
    canvas = np.full((height, 5 * tw + 6 * padding, 3), 255, np.uint8)
    for k, panel in enumerate(panels):
        x = padding + k * (tw + padding)
        canvas[padding:padding + th, x:x + tw] = panel
    draw_text(canvas, (padding, th + 2 * padding), text)
    path = Path(out_dir) / f"{pair_id}.png"
    path.write_bytes(png_encode(canvas))
    return path


def val_visual_for_compare(predict_fn, model, loader: Iterable[Dict[str, np.ndarray]],
                           save_path, vis_save_dir: str = "visualizations", manifest=None,
                           target_size: Tuple[int, int] = (256, 256), padding: int = 10,
                           max_samples: Optional[int] = None) -> List[Path]:
    """One comparison panel PNG a triplet (the first ``max_samples``);
    returns the paths written. ``predict_fn(model, batch)`` gives normalised
    probabilities [B, H, W, 1] (``train/step.make_predict_step``);
    ``manifest`` (a ``data.pipeline.Manifest``) gives the captions'
    metadata, joined by pair Id. A sample that fails is logged and
    skipped."""
    from cor_tpu_torch.eval.validator import manifest_meta_lookup, predict_stream

    out_dir = Path(save_path) / vis_save_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    meta_lookup = manifest_meta_lookup(manifest)
    written: List[Path] = []
    sample_idx = 0
    for batch, probs in predict_stream(predict_fn, model, loader):
        for i in range(probs.shape[0]):
            if max_samples is not None and sample_idx >= max_samples:
                break
            try:
                written.append(render_panel(probs[i], batch, i, meta_lookup, out_dir,
                                            target_size, padding))
            except Exception as e:  # one bad sample must not end the split
                log.warning(f"visualize: skipping sample {sample_idx} ({e})")
            sample_idx += 1
        if max_samples is not None and sample_idx >= max_samples:
            break
    log.info(f"Visualizations saved to {out_dir} ({len(written)} panels)")
    return written
