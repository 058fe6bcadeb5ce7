"""Losses, the PyTorch counterpart of ``cor_tpu.train.losses``. For now only
``mask_pool_normalized``, which the gallery build embeds candidates with;
the training slice (ROADMAP Queue 1, item 7) ports the rest into this file.
"""

from __future__ import annotations

import torch

from cor_tpu_torch.ops.common import l2_normalize
from cor_tpu_torch.ops.resize import resize_bilinear


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
