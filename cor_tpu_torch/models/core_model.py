"""The CORE model's configuration, the PyTorch counterpart of the part of
``cor_tpu.models.core_model`` that the retrieval-only serving path reads.

``CoreConfig`` mirrors ``cor_tpu``'s field for field with equal defaults. The
SAM image encoder is not ported yet (ROADMAP Queue 1, item 6): of its config
only ``img_size`` and ``patch_size`` are read (the size of a synthetic query
image, and the 64 x 64 image-embedding grid that the prompt encoder and the
mask decoder work on), so ``encoder_override`` may be any object that has
them. The prompt encoder and the mask decoder are the port's own modules.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch import nn

from cor_tpu_torch.models.prompt_encoder import PromptEncoder, PromptEncoderConfig
from cor_tpu_torch.models.sam_decoder import MaskDecoder, MaskDecoderConfig
from cor_tpu_torch.models.support_branch import SupportBranch, SupportBranchConfig
from cor_tpu_torch.ops.common import reset_all

# SAM image-encoder input size by model name (cor_tpu sam_encoder.SAM_SIZES:
# every SAM size takes 1024 x 1024 in 16 x 16 patches)
SAM_IMG_SIZE = {"sam_base": 1024, "sam_large": 1024, "sam_huge": 1024}


@dataclass(frozen=True)
class SamEncoderConfig:
    """The part of ``cor_tpu``'s SAM encoder config that the port reads."""

    img_size: int = 1024
    patch_size: int = 16

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


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
    def encoder(self):
        if self.encoder_override is not None:
            return self.encoder_override
        if self.sam_model not in SAM_IMG_SIZE:
            raise ValueError(f"Invalid SAM model: {self.sam_model}")
        return SamEncoderConfig(img_size=SAM_IMG_SIZE[self.sam_model])

    @property
    def query_img_size(self) -> int:
        return int(self.encoder.img_size)

    @property
    def decoder(self) -> MaskDecoderConfig:
        return self.decoder_override or MaskDecoderConfig()

    @property
    def prompt(self) -> PromptEncoderConfig:
        if self.prompt_override is not None:
            return self.prompt_override
        enc = self.encoder
        g = int(enc.img_size) // int(enc.patch_size)
        return PromptEncoderConfig(
            image_embedding_size=(g, g), input_image_size=(enc.img_size, enc.img_size)
        )

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


def init_prompt_encoder(cfg: CoreConfig, seed: int) -> PromptEncoder:
    """The prompt encoder with the port's seeded init (cor_tpu
    ``init_prompt_encoder``'s distributions)."""
    return reset_all(PromptEncoder(cfg.prompt), torch.Generator().manual_seed(seed))


def init_mask_decoder(cfg: CoreConfig, seed: int) -> MaskDecoder:
    """The mask decoder with the port's seeded init (cor_tpu
    ``init_mask_decoder``'s distributions)."""
    return reset_all(MaskDecoder(cfg.decoder), torch.Generator().manual_seed(seed))


class DecodeModel(nn.Module):
    """What the candidate-mask decode reads: ``prompt_encoder`` and
    ``mask_decoder``, named as the two subtrees of a ``cor_tpu`` parameter
    tree so that ``{"prompt_encoder": ..., "mask_decoder": ...}`` loads
    through the weight bridge as it is."""

    def __init__(self, prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder):
        super().__init__()
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder


def init_decode_model(cfg: CoreConfig, seed: int) -> DecodeModel:
    """The prompt encoder from ``seed`` and the mask decoder from ``seed + 1``."""
    return DecodeModel(init_prompt_encoder(cfg, seed), init_mask_decoder(cfg, seed + 1))


def _cast(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every floating-point parameter (LayerNorm scale and bias
    included) to ``dtype``, as ``cor_tpu``'s ``_cast`` casts every float leaf.
    In place; returns ``model``."""
    return model.to(dtype)
