"""Mask-conditioned pooling of the SigLIP patch grid, the PyTorch counterpart
of ``cor_tpu.models.pooling``.

- ``masked_pooling``: bilinear-resize the mask onto the feature grid, masked
  average pool.
- ``MaskAdapterPooling``: channel reduction, a mask-downscaling CNN added to
  the features, three ConvNeXt blocks, a 1x1 head producing
  ``num_output_maps`` maps, softmax(log_sigmoid(maps)) over pixels in fp32 as
  weights, weighted pooling of the original features, mean over maps.

All tensors NHWC. The ConvNeXt 7x7 convolution is depthwise: ``groups=dim``
with an OIHW weight [dim, 1, 7, 7] (``cor_tpu``: HWIO [7, 7, 1, dim]).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cor_tpu_torch.ops.common import Conv2d, Dense, LayerNorm, gelu
from cor_tpu_torch.ops.resize import resize_bilinear


@dataclass(frozen=True)
class MaskAdapterConfig:
    x_in_channel: int = 768  # SigLIP width
    adapter_in_channel: int = 512
    mask_downscaling_mid_channel: int = 16
    adapter_mid_channel: int = 256
    num_output_maps: int = 8
    drop_path_rate: float = 0.0
    layer_scale_init: float = 1e-6


def masked_pooling(features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """features [B, H, W, C], mask [B, h, w, 1] -> [B, 1, C] (1e-8 stabiliser)."""
    mask = resize_bilinear(mask, tuple(features.shape[1:3])).to(features.dtype)
    num = (features * mask).sum(dim=(1, 2))
    den = mask.sum(dim=(1, 2)) + 1e-8
    return (num / den)[:, None, :]


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, kernel: int = 7, layer_scale_init: float = 1e-6):
        super().__init__()
        self.kernel = kernel
        self.layer_scale_init = layer_scale_init
        self.dwconv = Conv2d(dim, dim, kernel, groups=dim)
        self.norm = LayerNorm(dim)
        self.pwconv1 = Dense(dim, 4 * dim)
        self.pwconv2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.empty(dim)) if layer_scale_init > 0 else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.gamma is not None:
            self.gamma.fill_(self.layer_scale_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inp = x
        x = self.dwconv(x, padding=self.kernel // 2)
        x = self.norm(x)
        x = self.pwconv2(gelu(self.pwconv1(x)))
        if self.gamma is not None:
            x = self.gamma.to(x.dtype) * x
        return inp + x  # drop_path is the identity: the adapter never enables it


class MaskAdapterPooling(nn.Module):
    def __init__(self, cfg: MaskAdapterConfig):
        super().__init__()
        if cfg.drop_path_rate > 0.0:
            raise ValueError(
                "MaskAdapterConfig.drop_path_rate > 0 is not wired into the "
                "adapter's ConvNeXt blocks (the reference never enables it); set it to 0.0"
            )
        self.cfg = cfg
        mdc = cfg.mask_downscaling_mid_channel
        self.channel_reduction = nn.ModuleDict({
            "conv": Conv2d(cfg.x_in_channel, cfg.adapter_in_channel, 1),
            "norm": LayerNorm(cfg.adapter_in_channel),
        })
        self.mask_downscaling = nn.ModuleDict({
            "conv1": Conv2d(1, mdc // 4, 3),
            "ln1": LayerNorm(mdc // 4),
            "conv2": Conv2d(mdc // 4, mdc, 3),
            "ln2": LayerNorm(mdc),
            "conv3": Conv2d(mdc, cfg.adapter_in_channel, 1),
        })
        self.fuse = Conv2d(cfg.adapter_in_channel, cfg.adapter_mid_channel, 1)
        self.cnext1 = ConvNextBlock(cfg.adapter_mid_channel, 7, cfg.layer_scale_init)
        self.cnext2 = ConvNextBlock(cfg.adapter_mid_channel, 7, cfg.layer_scale_init)
        self.cnext3 = ConvNextBlock(cfg.adapter_mid_channel, 7, cfg.layer_scale_init)
        self.norm = LayerNorm(cfg.adapter_mid_channel)
        self.final = Conv2d(cfg.adapter_mid_channel, cfg.num_output_maps, 1)

    def _maps(self, clip_feature: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """cor_tpu ``_generate_mask_adapter_map``: [B, H, W, Cin] features and a
        [B, H, W, 1] mask -> maps [B, H, W, M]."""
        H, W = clip_feature.shape[1:3]
        md = self.mask_downscaling
        m = resize_bilinear(mask.to(clip_feature.dtype), (H * 4, W * 4))
        m = gelu(md["ln1"](md["conv1"](m, stride=2, padding=1)))
        m = gelu(md["ln2"](md["conv2"](m, stride=2, padding=1)))
        m = md["conv3"](m)
        x = self.fuse(clip_feature + m)
        x = self.cnext3(self.cnext2(self.cnext1(x)))
        return self.final(self.norm(x))

    def forward(self, features: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """features [B, H, W, C], mask [B, h, w, 1] -> pooled [B, 1, C]."""
        B, H, W, C = features.shape
        # the mask goes DOWN to the feature grid here and back UP 4x inside
        # _maps: that double resize is the reference's behaviour (cor_tpu
        # models/pooling.py keeps it for parity) and must stay
        mask = resize_bilinear(mask, (H, W)).to(features.dtype)
        cr = self.channel_reduction
        vis = gelu(cr["norm"](cr["conv"](features)))
        maps = self._maps(vis, mask).reshape(B, H * W, self.cfg.num_output_maps)
        w = torch.softmax(F.logsigmoid(maps.float()), dim=1).to(features.dtype)  # [B, P, M]
        pooled = torch.einsum(
            "bpm,bpc->bmc", w.float(), features.reshape(B, H * W, C).float()
        ).to(features.dtype)  # [B, M, C]
        return pooled.mean(dim=1, keepdim=True)
