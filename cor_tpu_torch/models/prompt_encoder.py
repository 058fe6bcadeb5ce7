"""The stripped SAM prompt encoder that CORE uses, the PyTorch counterpart of
``cor_tpu.models.prompt_encoder`` (``init_prompt_encoder``,
``dense_positional_encoding``, ``prompt_encoder_dense``, ``get_dense_pe``).

It emits only the dense "no mask" embedding broadcast to the image-embedding
grid, and a random-Fourier positional encoding of that grid. The sparse
prompt is the support branch's query feature. ``full_prompt_encoder``
(points, boxes, masks) is not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class PromptEncoderConfig:
    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (64, 64)
    input_image_size: Tuple[int, int] = (1024, 1024)
    mask_in_chans: int = 16


class PositionEmbeddingRandom(nn.Module):
    """``gaussian_matrix`` [2, num_pos_feats] ~ N(0, 1) (cor_tpu's default
    scale, the only one CORE uses)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.gaussian_matrix = nn.Parameter(torch.empty(2, num_pos_feats))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.gaussian_matrix.copy_(torch.randn(self.gaussian_matrix.shape, generator=generator))


class PromptEncoder(nn.Module):
    def __init__(self, cfg: PromptEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(cfg.embed_dim // 2)
        self.no_mask_embed = nn.Parameter(torch.empty(1, cfg.embed_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch nn.Embedding's default init, N(0, 1)
        self.no_mask_embed.copy_(torch.randn(self.no_mask_embed.shape, generator=generator))


def _pe_encoding(gaussian_matrix: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """coords in [0, 1]^2, [..., 2] -> [..., 2 * num_pos_feats] fp32."""
    coords = 2.0 * coords - 1.0
    coords = coords @ gaussian_matrix.float()
    coords = 2.0 * math.pi * coords
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def dense_positional_encoding(gaussian_matrix: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """The positional grid [1, H, W, C] fp32. The grid is stacked in (x, y)
    order with +0.5 cell centres, as the reference stacks [x, y]."""
    h, w = size
    dev = gaussian_matrix.device
    y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    grid = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)
    return _pe_encoding(gaussian_matrix, grid)[None]


def prompt_encoder_dense(p: PromptEncoder, batch: int) -> torch.Tensor:
    """The dense prompt: ``no_mask_embed`` broadcast to [B, H, W, C]."""
    h, w = p.cfg.image_embedding_size
    return p.no_mask_embed.reshape(1, 1, 1, -1).expand(batch, h, w, -1)


def get_dense_pe(p: PromptEncoder) -> torch.Tensor:
    return dense_positional_encoding(p.pe_layer.gaussian_matrix, p.cfg.image_embedding_size)
