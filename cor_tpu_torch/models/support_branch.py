"""Support branch: (support image, change text, support mask) -> one 256-d
L2-normed query, the PyTorch counterpart of ``cor_tpu.models.support_branch``.

SigLIP(support image, text) -> LN on the patch grid -> mask pooling -> LN ->
fusion -> dim_proj (Linear D->512, GELU, Dropout 0.8, Linear 512->256, GELU,
Dropout 0.8) -> L2 normalize -> [B, 1, prompt_dim]. The dropouts (these and
CirFuse's 0.5) draw from the given ``torch.Generator`` at ``train=True`` and
are the identity at ``train=False``, the mode serving uses.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from cor_tpu_torch.models.fusion import CirFuse
from cor_tpu_torch.models.pooling import MaskAdapterConfig, MaskAdapterPooling, masked_pooling
from cor_tpu_torch.models.siglip import SIGLIP_MODELS, SigLIP, SigLIPConfig
from cor_tpu_torch.ops.common import Dense, LayerNorm, dropout, gelu, l2_normalize

FUSIONS = ("combiner", "add", "image_only", "no_mask", "global_image", "text_only")


@dataclass(frozen=True)
class SupportBranchConfig:
    siglip_model: str = "ViT-B-16-SigLIP-384"
    mask_pooling: str = "MaskAdapterPooling"  # or "MaskedPooling"
    fusion: str = "combiner"  # combiner | add | image_only | no_mask | global_image | text_only
    prompt_dim: int = 256
    proj_hidden: int = 512
    proj_dropout: float = 0.8
    freeze_siglip: bool = True
    siglip_override: Optional[SigLIPConfig] = None
    adapter_override: Optional[MaskAdapterConfig] = None

    @property
    def siglip(self) -> SigLIPConfig:
        if self.siglip_override is not None:
            return self.siglip_override
        if self.siglip_model not in SIGLIP_MODELS:
            raise ValueError(f"Invalid SigLIP model: {self.siglip_model}")
        return SIGLIP_MODELS[self.siglip_model]

    @property
    def siglip_dim(self) -> int:
        return self.siglip.embed_dim

    @property
    def adapter(self) -> MaskAdapterConfig:
        if self.adapter_override is not None:
            return self.adapter_override
        return MaskAdapterConfig(
            x_in_channel=self.siglip_dim,
            adapter_in_channel=512,
            mask_downscaling_mid_channel=16,
            adapter_mid_channel=256,
            num_output_maps=8,
        )


class SupportBranch(nn.Module):
    def __init__(self, cfg: SupportBranchConfig):
        super().__init__()
        if cfg.fusion not in FUSIONS:
            raise ValueError(f"Invalid fusion: {cfg.fusion}")
        if cfg.mask_pooling not in ("MaskAdapterPooling", "MaskedPooling"):
            raise ValueError(f"Invalid mask pooling method: {cfg.mask_pooling}")
        self.cfg = cfg
        d = cfg.siglip_dim
        self.siglip = SigLIP(cfg.siglip)
        self.cir_fuse = CirFuse(d, d)
        self.ln_channel_first = LayerNorm(d)
        self.ln_channel_last = LayerNorm(d)
        self.dim_proj = nn.ModuleDict({
            "lin1": Dense(d, cfg.proj_hidden),
            "lin2": Dense(cfg.proj_hidden, cfg.prompt_dim),
        })
        self.mask_pooling = (
            MaskAdapterPooling(cfg.adapter) if cfg.mask_pooling == "MaskAdapterPooling" else None
        )

    def forward(
        self,
        support_images: torch.Tensor,  # [B, S, S, 3]
        text_tokens: torch.Tensor,  # [B, L] int
        support_masks: torch.Tensor,  # [B, S, S, 1]
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ) -> torch.Tensor:
        """cor_tpu ``support_branch``: the L2-normed query [B, 1, prompt_dim]."""
        cfg = self.cfg
        # the towers are frozen: no graph is built through them
        with torch.set_grad_enabled(torch.is_grad_enabled() and not cfg.freeze_siglip):
            image_feat, text_feat, grid = self.siglip(support_images, text_tokens)

        grid = self.ln_channel_first(grid)
        if self.mask_pooling is not None:
            support_feat = self.mask_pooling(grid, support_masks)
        else:
            support_feat = masked_pooling(grid, support_masks)
        support_feat = self.ln_channel_last(support_feat)[:, 0, :]  # [B, D]

        if cfg.fusion == "combiner":
            fused = self.cir_fuse(support_feat, text_feat, generator, train)["repres"]
        elif cfg.fusion == "add":
            fused = support_feat + text_feat
        elif cfg.fusion == "image_only":
            fused = support_feat
        elif cfg.fusion == "no_mask":
            fused = self.cir_fuse(image_feat, text_feat, generator, train)["repres"]
        elif cfg.fusion == "global_image":
            fused = image_feat
        else:  # text_only
            fused = text_feat

        x = dropout(gelu(self.dim_proj["lin1"](fused)), cfg.proj_dropout, generator, train)
        x = dropout(gelu(self.dim_proj["lin2"](x)), cfg.proj_dropout, generator, train)
        return l2_normalize(x)[:, None, :]
