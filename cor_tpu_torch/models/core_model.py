"""The CORE model's configuration, the PyTorch counterpart of the part of
``cor_tpu.models.core_model`` that the retrieval-only serving path reads.

``CoreConfig`` mirrors ``cor_tpu``'s field for field with equal defaults. The
SAM encoder, prompt encoder and mask decoder are not ported yet, so their
override fields are carried as opaque values; only ``encoder_override``'s
``img_size`` is read (the size of a synthetic query image, for
``SyntheticDataset`` stream parity).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from cor_tpu_torch.models.support_branch import SupportBranch, SupportBranchConfig
from cor_tpu_torch.ops.common import reset_all

# SAM image-encoder input size by model name (cor_tpu sam_encoder.SAM_SIZES:
# every SAM size takes 1024 x 1024)
SAM_IMG_SIZE = {"sam_base": 1024, "sam_large": 1024, "sam_huge": 1024}


@dataclass(frozen=True)
class CoreConfig:
    sam_model: str = "sam_base"
    siglip_model: str = "ViT-B-16-SigLIP-384"
    mask_pooling: str = "MaskAdapterPooling"
    fusion: str = "combiner"
    multimask_output: bool = False
    compute_dtype: str = "bfloat16"
    freeze_towers: bool = True
    encoder_override: Optional[Any] = None
    decoder_override: Optional[Any] = None
    prompt_override: Optional[Any] = None
    support_override: Optional[SupportBranchConfig] = None

    @property
    def query_img_size(self) -> int:
        if self.encoder_override is not None:
            return int(self.encoder_override.img_size)
        if self.sam_model not in SAM_IMG_SIZE:
            raise ValueError(f"Invalid SAM model: {self.sam_model}")
        return SAM_IMG_SIZE[self.sam_model]

    @property
    def support(self) -> SupportBranchConfig:
        if self.support_override is not None:
            if not self.freeze_towers and self.support_override.freeze_siglip:
                from dataclasses import replace

                return replace(self.support_override, freeze_siglip=False)
            return self.support_override
        return SupportBranchConfig(
            siglip_model=self.siglip_model,
            mask_pooling=self.mask_pooling,
            fusion=self.fusion,
            freeze_siglip=self.freeze_towers,
        )

    @property
    def dtype(self) -> torch.dtype:
        dt = getattr(torch, self.compute_dtype, None)
        if not isinstance(dt, torch.dtype) or not dt.is_floating_point:
            raise ValueError(f"Invalid compute_dtype: {self.compute_dtype}")
        return dt


def init_support_branch(cfg: CoreConfig, seed: int) -> SupportBranch:
    """The support branch with the port's own seeded init (fp32 master
    weights): the distributions and shapes of ``cor_tpu``'s init functions,
    drawn from ``torch.Generator().manual_seed(seed)`` on the CPU, so that a
    seed gives the same weights on every machine."""
    gen = torch.Generator().manual_seed(seed)
    return reset_all(SupportBranch(cfg.support), gen)


def _cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating-point parameter (LayerNorm scale and bias
    included) to ``dtype``, as ``cor_tpu``'s ``_cast`` casts every float leaf.
    In place; returns ``model``."""
    return model.to(dtype)
