"""Bilinear resize, the PyTorch counterpart of ``cor_tpu.ops.resize``.

``cor_tpu`` calls ``jax.image.resize(method="linear", antialias=False)``,
which uses half-pixel centres and no antialiasing on downscale; that is
``F.interpolate(mode="bilinear", align_corners=False, antialias=False)``.
The slice runs it both ways: down (384 -> 24, the support mask onto the
patch grid) and up (24 -> 96, inside MaskAdapterPooling).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to spatial ``size``."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=False, antialias=False,
    )
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)
