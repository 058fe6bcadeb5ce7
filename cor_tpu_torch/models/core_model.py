"""The CORE model, the PyTorch counterpart of ``cor_tpu.models.core_model``:
its configuration, the seeded init of each of its four parts, ``CoreModel``
(the four parts named as the subtrees of ``init_core_model``'s tree) and
``core_forward``, for inference and for training.

``CoreConfig`` mirrors ``cor_tpu``'s field for field with equal defaults;
``encoder`` is the full SAM encoder config of ``models.sam_encoder``
(``encoder_override`` may be any object with its fields). The image encoder,
the support branch, the prompt encoder and the mask decoder are the port's
own modules.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn

from cor_tpu_torch.models.prompt_encoder import (
    PromptEncoder,
    PromptEncoderConfig,
    get_dense_pe,
    prompt_encoder_dense,
)
from cor_tpu_torch.models.sam_decoder import MaskDecoder, MaskDecoderConfig, mask_decoder
from cor_tpu_torch.models.sam_encoder import SamEncoder, SamEncoderConfig, sam_encoder_config
from cor_tpu_torch.models.support_branch import SupportBranch, SupportBranchConfig
from cor_tpu_torch.ops.common import reset_all


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
    def encoder(self) -> SamEncoderConfig:
        if self.encoder_override is not None:
            return self.encoder_override
        return sam_encoder_config(self.sam_model)

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


# the compute dtypes the card's kernels take (forward and backward), and the
# ROADMAP row that ports another
KERNEL_DTYPES = ("bfloat16", "float32")
FP16_ITEM = "ROADMAP Queue 2, @fp16 (the kernels in fp16)"


def check_kernel_dtype(cfg: CoreConfig, device) -> None:
    """Refuse, off the CPU, a compute dtype that the card's kernels do not
    take, naming the ROADMAP row that ports it (fp16: @fp16). bf16 and fp32
    serve, build and train, frozen or unfrozen (the encoder's attention
    backward, K6b, takes both). The CPU runs any float dtype through the
    kernels' plain versions. The entry points call this before they look for
    the card, so that the refusal comes before any model is built."""
    dt = cfg.dtype  # raises on a name that is no float dtype
    if torch.device(device).type == "cpu":
        return
    if cfg.compute_dtype not in KERNEL_DTYPES:
        raise ValueError(
            f"compute_dtype {cfg.compute_dtype} ({dt}) has no kernels on the card, which take "
            f"{' and '.join(KERNEL_DTYPES)}: {FP16_ITEM}; --device cpu runs it on the CPU")


def describe(cfg: CoreConfig) -> str:
    """What a config runs, for the entry points' logs: the SigLIP towers and
    the SAM image encoder by name, width, depth and heads, and the dtype."""
    vis, enc = cfg.support.siglip.vision, cfg.encoder
    return (f"{cfg.support.siglip_model} (width {vis.width}, {vis.depth} layers, "
            f"{vis.num_heads} heads of {vis.width // vis.num_heads}, grid {vis.grid}) + "
            f"{cfg.sam_model} (embed {enc.embed_dim}, {enc.depth} blocks, {enc.num_heads} heads "
            f"of {enc.embed_dim // enc.num_heads}), {cfg.compute_dtype}")


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


def init_image_encoder(cfg: CoreConfig, seed: int) -> SamEncoder:
    """The SAM image encoder with the port's seeded init (cor_tpu
    ``init_sam_encoder``'s distributions: zeros for ``pos_embed`` and the
    rel-pos tables)."""
    return reset_all(SamEncoder(cfg.encoder), torch.Generator().manual_seed(seed))


class CoreModel(nn.Module):
    """The whole model, its four children named as the subtrees of cor_tpu
    ``init_core_model``'s tree, so that one cor_tpu tree loads through the
    weight bridge as it is."""

    def __init__(self, image_encoder: SamEncoder, support_branch: SupportBranch,
                 prompt_encoder: PromptEncoder, mask_decoder: MaskDecoder):
        super().__init__()
        self.image_encoder = image_encoder
        self.support_branch = support_branch
        self.prompt_encoder = prompt_encoder
        self.mask_decoder = mask_decoder

    def forward(
        self,
        query_images: torch.Tensor,
        support_images: torch.Tensor,
        text_tokens: torch.Tensor,
        support_masks: torch.Tensor,
        cfg: CoreConfig,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """cor_tpu ``core_forward`` on parameters already in ``cfg.dtype``
        (``core_forward`` below supplies them): the frozen towers build no
        graph, the decoder runs its kernels (``fused``) unless training."""
        dt = cfg.dtype
        with torch.set_grad_enabled(torch.is_grad_enabled() and not cfg.freeze_towers):
            query_embeddings = self.image_encoder(query_images.to(dt))
        comb_support_feat = self.support_branch(
            support_images.to(dt), text_tokens, support_masks.to(dt), generator=generator,
            train=train)
        B = query_images.shape[0]
        pe = self.prompt_encoder
        masks, iou, _ = mask_decoder(
            self.mask_decoder, query_embeddings, get_dense_pe(pe).to(dt),
            comb_support_feat.to(dt), prompt_encoder_dense(pe, B).to(dt), cfg.multimask_output,
            fused=not train,
        )
        return (select_mask(cfg, masks, iou), query_embeddings.float(),
                comb_support_feat.float())


def init_core_model(cfg: CoreConfig, seed: int) -> CoreModel:
    """The seeds the entry points use: the support branch and the prompt
    encoder from ``seed``, the mask decoder from ``seed + 1``, the image
    encoder from ``seed + 2``."""
    return CoreModel(init_image_encoder(cfg, seed + 2), init_support_branch(cfg, seed),
                     init_prompt_encoder(cfg, seed), init_mask_decoder(cfg, seed + 1))


def select_mask(cfg: CoreConfig, masks: torch.Tensor, iou: torch.Tensor) -> torch.Tensor:
    """With ``multimask_output``, each row's mask of the highest predicted
    IoU; fp32 [B, 1, 4g, 4g]."""
    if cfg.multimask_output:
        best = iou.argmax(dim=1)
        masks = masks[torch.arange(masks.shape[0], device=masks.device), best][:, None]
    return masks.float()


def core_forward(
    model: CoreModel,
    query_images: torch.Tensor,  # [B, img, img, 3] normalized
    support_images: torch.Tensor,  # [B, S, S, 3] normalized
    text_tokens: torch.Tensor,  # [B, L] int
    support_masks: torch.Tensor,  # [B, S, S, 1] in [0, 1]
    cfg: CoreConfig,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """cor_tpu ``core_forward``: (mask logits [B, 1, 4g, 4g], query image
    embeddings [B, g, g, C], the support feature [B, 1, D]), all fp32.

    As in ``cor_tpu``, the model's parameters and buffers are cast to
    ``cfg.dtype`` for this call only (``torch.func.functional_call`` on the
    copies; a model already in ``cfg.dtype``, as ``_cast`` leaves a served
    one, is used as it is), so that training updates fp32 masters: the
    gradients flow through the casts to them. ``train=True`` records the
    graph through every parameter that requires grad (the image encoder and
    the SigLIP towers only with ``cfg.freeze_towers=False``; the PE matrix is
    a buffer and never trains), draws the dropouts (CirFuse's 0.5,
    ``dim_proj``'s 0.8) from ``generator`` and runs the decoder's
    ``fused=False`` path. ``train=False`` runs under ``torch.inference_mode``
    with the decoder's kernels."""
    with torch.inference_mode(not train):
        state = {
            name: t.to(cfg.dtype) if t.is_floating_point() else t
            for name, t in itertools.chain(model.named_parameters(), model.named_buffers())
        }
        return torch.func.functional_call(
            model, state, (query_images, support_images, text_tokens, support_masks, cfg),
            {"train": train, "generator": generator})
