"""Evaluation metrics, the PyTorch counterpart of ``cor_tpu.train.metrics``:
the validation preprocessing (sigmoid, per-sample min-max renormalisation)
and the reference's five soft per-sample metrics, plus the binarized Dice and
IoU with the all-empty => 1.0 convention.
"""

from __future__ import annotations

from typing import Dict

import torch


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).float()


def normalize_prediction(pred_logits: torch.Tensor) -> torch.Tensor:
    """sigmoid + per-sample min-max renormalisation."""
    p = torch.sigmoid(pred_logits.float())
    axes = tuple(range(1, p.dim()))
    pmin = p.amin(dim=axes, keepdim=True)
    pmax = p.amax(dim=axes, keepdim=True)
    return (p - pmin) / (pmax - pmin + 1e-8)


def compute_dice(pred, gt, smooth: float = 1e-5) -> torch.Tensor:
    p, g = _flat(pred), _flat(gt)
    inter = (p * g).sum(dim=1)
    return (2.0 * inter + smooth) / (p.sum(dim=1) + g.sum(dim=1) + smooth)


def compute_mae(pred, gt) -> torch.Tensor:
    return (_flat(pred) - _flat(gt)).abs().mean(dim=1)


def compute_iou(pred, gt, smooth: float = 1e-5) -> torch.Tensor:
    p, g = _flat(pred), _flat(gt)
    inter = (p * g).sum(dim=1)
    union = p.sum(dim=1) + g.sum(dim=1) - inter
    return (inter + smooth) / (union + smooth)


def compute_mdice(pred, gt, smooth: float = 1e-5) -> torch.Tensor:
    return 0.5 * (compute_dice(pred, gt, smooth) + compute_dice(1 - pred, 1 - gt, smooth))


def compute_miou(pred, gt, smooth: float = 1e-5) -> torch.Tensor:
    return 0.5 * (compute_iou(pred, gt, smooth) + compute_iou(1 - pred, 1 - gt, smooth))


def all_soft_metrics(pred, gt) -> Dict[str, torch.Tensor]:
    """The per-sample metric vectors of the val stage."""
    return {
        "dice": compute_dice(pred, gt),
        "mae": compute_mae(pred, gt),
        "iou": compute_iou(pred, gt),
        "mdice": compute_mdice(pred, gt),
        "miou": compute_miou(pred, gt),
    }


def binarized_dice_iou(pred, gt, threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """Per-sample Dice and IoU of the thresholded masks: 1.0 where both are
    empty, 0.0 where exactly one is."""
    p = (_flat(pred) > threshold).float()
    g = (_flat(gt) > threshold).float()
    p_sum, g_sum = p.sum(dim=1), g.sum(dim=1)
    inter = (p * g).sum(dim=1)
    union = p_sum + g_sum - inter
    both_empty = (p_sum == 0) & (g_sum == 0)
    one_empty = ((p_sum == 0) | (g_sum == 0)) & ~both_empty
    dice = torch.where(both_empty, 1.0, torch.where(
        one_empty, 0.0, 2.0 * inter / (p_sum + g_sum).clamp_min(1.0)))
    iou = torch.where(both_empty, 1.0, torch.where(one_empty, 0.0, inter / union.clamp_min(1.0)))
    return {"dice_bin": dice, "iou_bin": iou}
