"""Training losses, the PyTorch counterpart of ``cor_tpu.train.losses``:

- ``wbce_with_wiou_loss``: the edge-weight map ``1 + 5 |avg_pool31(mask) -
  mask|``, weighted BCE-with-logits normalised by the weight sum, weighted
  IoU on the sigmoid probabilities, mean over the batch;
- ``fg_feat_similarity_loss``: 1 - cos(mask-pooled query feature, support
  feature) over the samples with a non-empty mask;
- ``bg_feat_similarity_loss``: the reference's background term with its
  broadcast quirk (see its docstring), over the samples with a non-empty
  background;
- ``core_total_loss``: seg + 5 fg + 5 bg.

Where the reference indexes the valid samples, the means here are masked
means over an indicator (``_masked_mean``), as in ``cor_tpu``: the same
value, and rows a padded batch carries (``valid`` 0) change nothing. All
losses compute in fp32. ``mask_pool_normalized`` also embeds the gallery
candidates of the index build.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from cor_tpu_torch.ops.common import l2_normalize
from cor_tpu_torch.ops.resize import avg_pool_same, resize_bilinear


def _masked_mean(per_sample: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over the samples, restricted to the valid rows (0 if none is)."""
    if valid is None:
        return per_sample.mean()
    v = valid.float()
    n = v.sum()
    return torch.where(n > 0, (per_sample * v).sum() / n.clamp_min(1.0), 0.0)


def wbce_with_wiou_loss(
    pred: torch.Tensor,  # [B, H, W, 1] logits (NHWC)
    mask: torch.Tensor,  # [B, H, W, 1] in [0, 1]
    w1: float = 1.0,
    w2: float = 1.0,
    valid: Optional[torch.Tensor] = None,  # [B] 1 = real row, 0 = padding
) -> torch.Tensor:
    pred, mask = pred.float(), mask.float()
    weit = 1.0 + 5.0 * (avg_pool_same(mask, kernel=31, padding=15) - mask).abs()
    # BCE with logits: max(x, 0) - x y + log(1 + exp(-|x|))
    wbce = pred.clamp_min(0.0) - pred * mask + torch.log1p(torch.exp(-pred.abs()))
    axes = (1, 2, 3)
    wbce = (weit * wbce).sum(dim=axes) / weit.sum(dim=axes)
    prob = torch.sigmoid(pred)
    inter = (prob * mask * weit).sum(dim=axes)
    union = ((prob + mask) * weit).sum(dim=axes) - inter
    wiou = 1.0 - (inter + 1e-6) / (union + 1e-6)
    return _masked_mean(w1 * wbce + w2 * wiou, valid)


def mask_pool_normalized(embeddings: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked average pool + L2 norm: embeddings [B, H, W, C], mask
    [B, h, w, 1] -> fp32 [B, C]. The mask is resized bilinearly to the
    embedding grid (no antialiasing: a 1024 -> 64 resize samples 2 x 2 of
    every 16 x 16 block) and clipped to [0, 1]."""
    embeddings = embeddings.float()
    mask = resize_bilinear(mask.float(), tuple(embeddings.shape[1:3])).clamp(0.0, 1.0)
    pooled = (embeddings * mask).sum(dim=(1, 2))
    denom = mask.sum(dim=(1, 2)) + 1e-8
    return l2_normalize(pooled / denom)


def fg_feat_similarity_loss(
    query_embeddings: torch.Tensor,  # [B, H, W, C]
    support_feat: torch.Tensor,  # [B, 1, C] L2-normed
    query_mask: torch.Tensor,  # [B, h, w, 1]
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    qm = query_mask.float()
    nonempty = (qm.sum(dim=(1, 2, 3)) > 0).float()
    if valid is not None:
        nonempty = nonempty * valid.float()
    qf = mask_pool_normalized(query_embeddings, qm)
    sf = l2_normalize(support_feat.float()[:, 0, :])
    return _masked_mean(1.0 - (qf * sf).sum(dim=-1), nonempty)


def bg_feat_similarity_loss(
    query_embeddings: torch.Tensor,
    support_feat: torch.Tensor,
    query_mask: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The reference's background term bit for bit, its broadcast quirk
    included: ``F.cosine_similarity(bg_feat [n, 1, C], support [n, C],
    dim=1)`` broadcasts to [n, n, C] and reduces over the SAMPLE axis, so
    the per-(i, c) value is

        s[i, c] = bg[i, c] colsum(sup)[c] / max(|bg[i, c]| sqrt(n) colnorm(sup)[c], 1e-8)

    then ``(s + 1).mean()`` over [n, C] (cor_tpu ``bg_feat_similarity_loss``;
    the masked form is padding-invariant)."""
    bg = 1.0 - query_mask.float()
    m = (bg.sum(dim=(1, 2, 3)) > 0).float()
    if valid is not None:
        m = m * valid.float()
    n = m.sum()
    bf = mask_pool_normalized(query_embeddings, bg)  # [B, C], row-normalised
    sup = support_feat.float()[:, 0, :]  # [B, C], raw as the reference's
    colsum = (sup * m[:, None]).sum(dim=0)
    # the square root of a clamped sum: a zero channel (dropout 0.8 makes
    # them) has a zero gradient, as torch's norm subgradient
    colnorm = torch.sqrt(((sup * sup) * m[:, None]).sum(dim=0).clamp_min(1e-24))
    num = bf * colsum[None, :]
    den = (bf.abs() * torch.sqrt(n.clamp_min(1.0)) * colnorm[None, :]).clamp_min(1e-8)
    s = num / den
    total = ((s + 1.0) * m[:, None]).sum()
    count = n * s.shape[1]
    return torch.where(n > 0, total / count.clamp_min(1.0), 0.0)


def core_total_loss(
    pred_mask: torch.Tensor,  # [B, Hm, Wm, 1] logits
    query_mask_full: torch.Tensor,  # [B, H, W, 1] GT at data resolution
    query_embeddings: torch.Tensor,  # [B, He, We, C]
    support_feat: torch.Tensor,  # [B, 1, C]
    feat_weight: float = 5.0,
    valid: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """seg + 5 fg + 5 bg: the GT mask resized bilinearly to the prediction
    grid for the segmentation term, at full resolution for the feature
    terms. Returns (total, {seg_loss, fg_loss, bg_loss, total_loss})."""
    target = resize_bilinear(query_mask_full.float(), tuple(pred_mask.shape[1:3]))
    seg = wbce_with_wiou_loss(pred_mask, target, valid=valid)
    fg = fg_feat_similarity_loss(query_embeddings, support_feat, query_mask_full, valid=valid)
    bg = bg_feat_similarity_loss(query_embeddings, support_feat, query_mask_full, valid=valid)
    total = seg + feat_weight * fg + feat_weight * bg
    return total, {"seg_loss": seg, "fg_loss": fg, "bg_loss": bg, "total_loss": total}
