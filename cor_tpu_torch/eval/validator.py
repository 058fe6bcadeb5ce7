"""Offline evaluation: prediction-mask dumps and per-sample CSV metrics, the
PyTorch counterpart of ``cor_tpu.eval.validator``.

- ``save_hard_pred_masks``: one forward per batch, the normalised
  probabilities resized to each sample's native GT size, binarised > 0.5
  and written as 0/255 PNGs named ``{pair_id}_{query_mask_name}``;
  ``save_soft_pred_masks`` writes ``prob * 255`` unthresholded.
- ``val_metric``: per-sample metrics at the native GT resolution, the
  binarised set {Dice, MAE, IoU, mDice, mIoU} with the all-zero-mask =>
  1.0 convention, written to a CSV with the manifest's metadata columns
  joined by pair Id, and their means.
- ``run_eval_split``: one forward per batch feeding the hard and soft
  dumps, the metric CSV and the first N comparison panels
  (``eval/visualize.py``).

The forward runs batched on the model's device (``predict_stream``); the
per-sample resizes, metrics and PNG writes stay on the host in numpy. The
resize is the port's own bilinear (``resize_bilinear_f32``: OpenCV's
``INTER_LINEAR`` on float32: half-pixel centres, borders clamped, no
antialias), the masks are written by ``utils/png.py``, and the native GT is
read by its reader: no cv2 and no PIL. Each sample's writes and metrics sit
in a try/continue as in the reference, so one bad sample never ends a
split; the forward is outside it, and the result counts the skipped samples.
"""

from __future__ import annotations

import csv
import logging
import os
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from cor_tpu_torch.utils.png import png_encode_gray, read_image

log = logging.getLogger("cor_tpu_torch.eval")

_PRED_KEYS = ("query_img", "support_img", "support_mask", "text")
METRIC_KEYS = ("Dice", "MAE", "IoU", "mDice", "mIoU")


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR taps along one axis: (left index, right index,
    left weight, right weight), the weights float32."""
    scale = 1.0 / (n_out / n_in)  # cv2: 1 / inv_scale, in double
    pos = (np.arange(n_out) + 0.5) * scale - 0.5
    s = np.floor(pos).astype(np.int64)
    f = (pos - s).astype(np.float32)  # the fraction in double, then float32
    low, high = s < 0, s >= n_in - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), np.float32(1.0) - f, f


def resize_bilinear_f32(x: np.ndarray, hw) -> np.ndarray:
    """A float32 [H, W] map resized to ``hw`` as OpenCV's ``cv2.resize(x,
    (w, h), interpolation=INTER_LINEAR)`` computes it: half-pixel centres,
    the borders clamped, no antialias on a downscale; the horizontal pass
    first, then the vertical, each in float32."""
    x = np.asarray(x, np.float32)
    h, w = int(hw[0]), int(hw[1])
    x0, x1, a0, a1 = _linear_taps(x.shape[1], w)
    rows = x[:, x0] * a0 + x[:, x1] * a1
    y0, y1, b0, b1 = _linear_taps(x.shape[0], h)
    return rows[y0] * b0[:, None] + rows[y1] * b1[:, None]


def _resize_to_native(prob: np.ndarray, hw) -> np.ndarray:
    h, w = int(hw[0]), int(hw[1])
    if prob.shape == (h, w):
        return prob
    return resize_bilinear_f32(prob, (h, w))


# ---------------------------------------------------------------------------
# per-sample numpy metrics (the binarised set)
# ---------------------------------------------------------------------------


def _np_dice(pred_soft: np.ndarray, gt_bin: np.ndarray, smooth=1e-5, threshold=0.5) -> float:
    p = (pred_soft > threshold).astype(np.float64)
    g = gt_bin.astype(np.float64)
    inter, ps, gs = float((p * g).sum()), float(p.sum()), float(g.sum())
    if ps == 0.0 and gs == 0.0:
        return 1.0  # the all-zero convention
    return (2.0 * inter + smooth) / (ps + gs + smooth)


def _np_iou(pred_soft: np.ndarray, gt_bin: np.ndarray, smooth=1e-5, threshold=0.5) -> float:
    p = (pred_soft > threshold).astype(np.float64)
    g = gt_bin.astype(np.float64)
    inter, ps, gs = float((p * g).sum()), float(p.sum()), float(g.sum())
    if ps == 0.0 and gs == 0.0:
        return 1.0
    return (inter + smooth) / (ps + gs - inter + smooth)


def sample_metrics(pred_soft: np.ndarray, gt_bin: np.ndarray) -> Dict[str, float]:
    """Binarised Dice and IoU, soft MAE, and mDice/mIoU as the mean of the
    foreground's and the background's (the soft complement re-binarised)."""
    dice = _np_dice(pred_soft, gt_bin)
    iou = _np_iou(pred_soft, gt_bin)
    bg_dice = _np_dice(1.0 - pred_soft, 1.0 - gt_bin)
    bg_iou = _np_iou(1.0 - pred_soft, 1.0 - gt_bin)
    return {
        "Dice": dice,
        "MAE": float(np.abs(pred_soft - gt_bin).mean()),
        "IoU": iou,
        "mDice": 0.5 * (dice + bg_dice),
        "mIoU": 0.5 * (iou + bg_iou),
    }


# ---------------------------------------------------------------------------
# the forward, and the mask dumps
# ---------------------------------------------------------------------------


def predict_stream(predict_fn, model, loader, stats: Optional[dict] = None):
    """One forward per batch on the model's device -> (batch, probs
    [B, H, W] float32 numpy) pairs. ``stats`` (a dict) gathers the host
    seconds spent waiting for the loader (``load_s``), the forward's device
    milliseconds by CUDA events on a card (``forward_ms``, one a batch) or
    its wall milliseconds on the CPU, and the batches and samples."""
    device = next(model.parameters()).device
    stats = {} if stats is None else stats
    for k in ("load_s", "batches", "samples"):
        stats.setdefault(k, 0)
    stats.setdefault("forward_ms", [])
    it = iter(loader)
    while True:
        t0 = time.perf_counter()
        batch = next(it, None)
        stats["load_s"] += time.perf_counter() - t0
        if batch is None:
            return
        dev = {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in _PRED_KEYS}
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            probs = predict_fn(model, dev)
            end.record()
            probs = probs[..., 0].float().cpu().numpy()
            stats["forward_ms"].append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            probs = predict_fn(model, dev)[..., 0].float().cpu().numpy()
            stats["forward_ms"].append(1e3 * (time.perf_counter() - t0))
        stats["batches"] += 1
        stats["samples"] += probs.shape[0]
        yield batch, probs


def dump_sample(probs_i: np.ndarray, batch, i: int, sample_idx: int, out_dir: Path, hard: bool,
                mask_names: Optional[List[str]]) -> Path:
    """Write one prediction PNG at the GT's native resolution, named
    ``{pair_id}_{query_mask_name}``."""
    native = batch.get("native_hw")
    hw = native[i] if native is not None else probs_i.shape[:2]
    p = _resize_to_native(probs_i, hw)
    if hard:
        img = (p > 0.5).astype(np.uint8) * 255
    else:
        img = np.clip(p * 255.0, 0, 255).astype(np.uint8)
    pair_id = int(batch["pair_id"][i])
    name = mask_names[sample_idx] if mask_names is not None else f"mask_{sample_idx:06d}.png"
    path = Path(out_dir) / f"{pair_id}_{name}"
    path.write_bytes(png_encode_gray(img))
    return path


def save_pred_masks(predict_fn, model, loader: Iterable[Dict[str, np.ndarray]], save_path,
                    pred_save_dir: str = "pred_masks", hard: bool = True,
                    mask_names: Optional[List[str]] = None) -> List[Path]:
    """Run ``predict_fn`` (``train/step.make_predict_step``: normalised
    probabilities [B, H, W, 1]) batch by batch and write one PNG a sample;
    a sample that fails is logged and skipped."""
    out_dir = Path(save_path) / pred_save_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    written: List[Path] = []
    sample_idx = 0
    for batch, probs in predict_stream(predict_fn, model, loader):
        for i in range(probs.shape[0]):
            try:
                written.append(dump_sample(probs[i], batch, i, sample_idx, out_dir, hard,
                                           mask_names))
            except Exception as e:  # one bad sample must not end the split
                log.warning(f"skipping sample {sample_idx} ({e})")
            sample_idx += 1
    return written


def save_hard_pred_masks(predict_fn, model, loader, save_path, pred_save_dir="pred_masks",
                         mask_names=None):
    return save_pred_masks(predict_fn, model, loader, save_path, pred_save_dir, hard=True,
                           mask_names=mask_names)


def save_soft_pred_masks(predict_fn, model, loader, save_path, pred_save_dir="soft_pred_masks",
                         mask_names=None):
    return save_pred_masks(predict_fn, model, loader, save_path, pred_save_dir, hard=False,
                           mask_names=mask_names)


# ---------------------------------------------------------------------------
# per-sample CSV metrics at the native GT resolution
# ---------------------------------------------------------------------------

_META_COLUMNS = ("Query_img", "Query_mask", "Support_img", "Support_mask", "Text", "Compose",
                 "Dataset", "Target", "query_cat")


def _numeric(v):
    """pandas' ``to_numeric`` of one Id cell (raises on text)."""
    if isinstance(v, (int, float, np.integer, np.floating)):
        return v
    text = str(v).strip()
    try:
        return int(text)
    except ValueError:
        return float(text)


def manifest_meta_lookup(manifest):
    """lookup(pair id) -> the manifest's row (a dict) or None, joined by the
    ``Id`` column (never by row position); duplicate Ids take the first
    row, and text Ids are matched as numbers where they all are."""
    if manifest is None or "Id" not in getattr(manifest, "columns", ()):
        return lambda pid: None
    ids = manifest.column("Id")
    try:
        ids = [_numeric(v) for v in ids]
    except (ValueError, TypeError):
        pass  # ids that are text: matched as they are
    table: Dict = {}
    for pid, row in zip(ids, manifest.rows):
        table.setdefault(pid, row)
    return table.get


def _native_gt(batch, i, hw) -> Optional[np.ndarray]:
    """The binary GT at the native resolution: from disk where the loader
    carries ``query_mask_path``, else the batched GT resized back."""
    paths = batch.get("query_mask_path")
    if paths is not None:
        path = str(paths[i])
        if path and os.path.exists(path):
            gt = read_image(path, "L").astype(np.float32) / 255.0
            return (gt > 0.5).astype(np.float32)
    gt = batch.get("query_mask")
    if gt is None:
        return None
    g = _resize_to_native(np.asarray(gt[i], np.float32)[..., 0], hw)
    return (g > 0.5).astype(np.float32)


def metric_row(probs_i: np.ndarray, batch, i: int, meta_lookup) -> Dict:
    """One sample's CSV row at the native GT resolution: the prediction
    resized, re-stretched to [0, 1], the binarised metrics against the
    native GT, and the manifest's metadata columns joined by pair Id."""
    native = batch.get("native_hw")
    hw = native[i] if native is not None else probs_i.shape[:2]
    p = _resize_to_native(probs_i.astype(np.float32), hw)
    p = (p - p.min()) / (p.max() - p.min() + 1e-8)
    gt = _native_gt(batch, i, hw)
    if gt is None:
        raise ValueError("no GT available for sample")
    pid = int(batch["pair_id"][i])
    row = {"Id": pid}
    m = meta_lookup(pid)
    if m is not None:
        for c in _META_COLUMNS:
            if c in m:
                row[c] = m[c]
    row.update(sample_metrics(p, gt))
    return row


def write_metric_csv(rows: List[Dict], csv_path) -> Dict[str, float]:
    """Write the per-sample CSV (fieldnames: the ordered union of the rows'
    keys) and return the metrics' means."""
    csv_path = Path(csv_path)
    csv_path.parent.mkdir(parents=True, exist_ok=True)
    fields = list(dict.fromkeys(k for r in rows for k in r)) if rows else ["Id"]
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields, restval="")
        writer.writeheader()
        writer.writerows(rows)
    return {k: (float(np.mean([r[k] for r in rows])) if rows else 0.0) for k in METRIC_KEYS}


def val_metric(predict_fn, model, loader, csv_path, manifest=None) -> Dict[str, float]:
    """The per-sample metric CSV and the summary means (see ``metric_row``);
    ``manifest`` (a ``data.pipeline.Manifest``) joins its metadata columns by
    pair Id."""
    meta_lookup = manifest_meta_lookup(manifest)
    rows = []
    sample_idx = 0
    for batch, probs in predict_stream(predict_fn, model, loader):
        for i in range(probs.shape[0]):
            try:
                rows.append(metric_row(probs[i], batch, i, meta_lookup))
            except Exception as e:
                log.warning(f"val_metric: skipping sample {sample_idx} ({e})")
            sample_idx += 1
    return write_metric_csv(rows, csv_path)


def run_eval_split(predict_fn, model, loader, out_dir, manifest=None,
                   mask_names: Optional[List[str]] = None, soft: bool = False,
                   visualize_n: int = 0, csv_name: str = "val_metric.csv") -> Dict:
    """One forward per batch feeding every consumer: the hard (and, with
    ``soft``, the soft) mask dumps under ``out_dir/pred_masks`` and
    ``out_dir/soft_pred_masks``, the metric CSV, and the comparison panels
    of the first ``visualize_n`` samples under ``out_dir/visualizations``.

    Returns {"hard": [paths], "soft": [paths], "panels": [paths], "summary":
    {metric: mean}, "skipped": samples one of whose consumers failed,
    "timing": ``predict_stream``'s stats, the host seconds of the
    per-sample work (``post_s``) and of the whole sweep (``wall_s``)}."""
    from cor_tpu_torch.eval.visualize import render_panel

    out_dir = Path(out_dir)
    hard_dir = out_dir / "pred_masks"
    hard_dir.mkdir(parents=True, exist_ok=True)
    soft_dir = out_dir / "soft_pred_masks"
    if soft:
        soft_dir.mkdir(parents=True, exist_ok=True)
    vis_dir = out_dir / "visualizations"
    if visualize_n > 0:
        vis_dir.mkdir(parents=True, exist_ok=True)
    meta_lookup = manifest_meta_lookup(manifest)
    hard_written: List[Path] = []
    soft_written: List[Path] = []
    panels: List[Path] = []
    rows: List[Dict] = []
    skipped: set = set()
    stats: dict = {"post_s": 0.0}
    t_start = time.perf_counter()
    sample_idx = 0
    for batch, probs in predict_stream(predict_fn, model, loader, stats):
        t0 = time.perf_counter()
        for i in range(probs.shape[0]):
            try:
                hard_written.append(dump_sample(probs[i], batch, i, sample_idx, hard_dir, True,
                                                mask_names))
            except Exception as e:
                skipped.add(sample_idx)
                log.warning(f"skipping sample {sample_idx} ({e})")
            if soft:
                try:
                    soft_written.append(dump_sample(probs[i], batch, i, sample_idx, soft_dir,
                                                    False, mask_names))
                except Exception as e:
                    skipped.add(sample_idx)
                    log.warning(f"soft dump: skipping sample {sample_idx} ({e})")
            try:
                rows.append(metric_row(probs[i], batch, i, meta_lookup))
            except Exception as e:
                skipped.add(sample_idx)
                log.warning(f"val_metric: skipping sample {sample_idx} ({e})")
            if len(panels) < visualize_n:
                try:
                    panels.append(render_panel(probs[i], batch, i, meta_lookup, vis_dir))
                except Exception as e:
                    skipped.add(sample_idx)
                    log.warning(f"visualize: skipping sample {sample_idx} ({e})")
            sample_idx += 1
        stats["post_s"] += time.perf_counter() - t0
    summary = write_metric_csv(rows, out_dir / csv_name)
    stats["wall_s"] = time.perf_counter() - t_start
    return {"hard": hard_written, "soft": soft_written, "panels": panels, "summary": summary,
            "skipped": len(skipped), "timing": stats}
