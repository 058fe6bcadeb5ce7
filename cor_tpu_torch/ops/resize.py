"""Bilinear resize and the loss's average pooling, the PyTorch counterpart
of ``cor_tpu.ops.resize``.

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


def avg_pool_same(x: torch.Tensor, kernel: int, padding: int) -> torch.Tensor:
    """Stride-1 average pooling of an NHWC tensor, zero padding counted in
    the mean (``count_include_pad``, torch's default; cor_tpu sums the window
    separably in fp32 and divides by kernel^2). Output in x.dtype."""
    y = F.avg_pool2d(x.float().permute(0, 3, 1, 2), kernel, stride=1, padding=padding,
                     count_include_pad=True)
    return y.permute(0, 2, 3, 1).contiguous().to(x.dtype)
