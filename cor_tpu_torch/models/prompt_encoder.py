"""SAM's prompt encoders, the PyTorch counterpart of
``cor_tpu.models.prompt_encoder``:

- the stripped encoder that CORE uses (``PromptEncoder``; ``init_prompt_encoder``,
  ``dense_positional_encoding``, ``prompt_encoder_dense``, ``get_dense_pe``):
  only the dense "no mask" embedding broadcast to the image-embedding grid,
  and a random-Fourier positional encoding of that grid. The sparse prompt
  is the support branch's query feature;
- SAM's stock encoder (``FullPromptEncoder``; ``init_full_prompt_encoder``,
  ``encode_coords``, ``embed_points``, ``embed_boxes``, ``embed_masks``,
  ``full_prompt_encoder``): points (positive, negative, padding), boxes and
  a low-resolution mask prompt, for segmenting an image from clicks. Its
  sparse prompts make decodes of 5 + n tokens (a pad point is added to
  points without a box), which the mask decoder runs through K1 up to 8
  tokens and K8a/K8b above (``models/sam_decoder.py``).

The mask downscaling (conv 2x2/s2, LN, GELU, conv 2x2/s2, LN, GELU, conv
1x1) is plain PyTorch, as ``cor_tpu`` leaves it to XLA. Every function
computes in fp32 (the coordinates) or in the mask's dtype (the dense path),
as ``cor_tpu``'s do; a caller casts to the decoder's compute dtype.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from cor_tpu_torch.ops.common import Conv2d, LayerNorm, gelu, layer_norm, reset_all


@dataclass(frozen=True)
class PromptEncoderConfig:
    embed_dim: int = 256
    image_embedding_size: Tuple[int, int] = (64, 64)
    input_image_size: Tuple[int, int] = (1024, 1024)
    mask_in_chans: int = 16


class PositionEmbeddingRandom(nn.Module):
    """``gaussian_matrix`` [2, num_pos_feats] ~ N(0, 1) (cor_tpu's default
    scale, the only one CORE uses): a buffer, as in the reference, which
    never trains (``cor_tpu`` stops its gradient and masks it out of every
    optimizer)."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("gaussian_matrix", torch.empty(2, num_pos_feats))

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


# ---------------------------------------------------------------------------
# SAM's stock prompt encoder: points, boxes, masks
# ---------------------------------------------------------------------------


class MaskDownscaling(nn.Module):
    """The mask prompt's convolutions (``cor_tpu``'s ``mask_downscaling``):
    [4H, 4W, 1] -> [H, W, embed_dim]."""

    def __init__(self, embed_dim: int, mask_in_chans: int):
        super().__init__()
        self.conv1 = Conv2d(1, mask_in_chans // 4, 2)
        self.ln1 = LayerNorm(mask_in_chans // 4)
        self.conv2 = Conv2d(mask_in_chans // 4, mask_in_chans, 2)
        self.ln2 = LayerNorm(mask_in_chans)
        self.conv3 = Conv2d(mask_in_chans, embed_dim, 1)


class FullPromptEncoder(nn.Module):
    """The leaves of ``init_full_prompt_encoder``: the PE matrix (a buffer),
    ``point_embeddings`` [4, C] (negative, positive, box corner 1 and 2),
    ``not_a_point_embed`` and ``no_mask_embed`` [1, C], and the mask
    downscaling. ``reset_all`` draws the embeddings N(0, 1) (torch
    nn.Embedding's init) and the convolutions as torch's."""

    def __init__(self, cfg: PromptEncoderConfig):
        super().__init__()
        d = cfg.embed_dim
        self.cfg = cfg
        self.pe_layer = PositionEmbeddingRandom(d // 2)
        self.point_embeddings = nn.Parameter(torch.empty(4, d))
        self.not_a_point_embed = nn.Parameter(torch.empty(1, d))
        self.no_mask_embed = nn.Parameter(torch.empty(1, d))
        self.mask_downscaling = MaskDownscaling(d, cfg.mask_in_chans)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for p in (self.point_embeddings, self.not_a_point_embed, self.no_mask_embed):
            p.copy_(torch.randn(p.shape, generator=generator))


def init_full_prompt_encoder(cfg: PromptEncoderConfig, seed: int) -> FullPromptEncoder:
    """A ``FullPromptEncoder`` with random weights from ``seed``."""
    return reset_all(FullPromptEncoder(cfg), torch.Generator().manual_seed(seed))


def encode_coords(pe: PositionEmbeddingRandom, coords: torch.Tensor,
                  image_size: Tuple[int, int]) -> torch.Tensor:
    """Unnormalised pixel coordinates [..., 2] (x, y) -> [..., C] fp32."""
    c = coords.float()
    c = torch.stack([c[..., 0] / image_size[1], c[..., 1] / image_size[0]], dim=-1)
    return _pe_encoding(pe.gaussian_matrix, c)


def embed_points(p: FullPromptEncoder, points: torch.Tensor, labels: torch.Tensor,
                 cfg: PromptEncoderConfig, pad: bool = True) -> torch.Tensor:
    """points [B, N, 2], labels [B, N] in {-1 pad, 0 negative, 1 positive}
    -> [B, N (+ 1 with ``pad``), C]: a padding point (label -1) is appended
    when no box follows."""
    if pad:
        B = points.shape[0]
        points = torch.cat([points, points.new_zeros(B, 1, 2)], dim=1)
        labels = torch.cat([labels, -labels.new_ones(B, 1)], dim=1)
    pe = encode_coords(p.pe_layer, points + 0.5, cfg.input_image_size)
    lab = labels[..., None]
    pe = torch.where(lab == -1, p.not_a_point_embed[0].float(), pe)
    pe = pe + torch.where(lab == 0, p.point_embeddings[0].float(), 0.0)
    return pe + torch.where(lab == 1, p.point_embeddings[1].float(), 0.0)


def embed_boxes(p: FullPromptEncoder, boxes: torch.Tensor,
                cfg: PromptEncoderConfig) -> torch.Tensor:
    """boxes [B, 4] (x0, y0, x1, y1) -> [B, 2, C]: the two corners."""
    pe = encode_coords(p.pe_layer, (boxes + 0.5).reshape(-1, 2, 2), cfg.input_image_size)
    return pe + p.point_embeddings[2:4].float()


def embed_masks(p: FullPromptEncoder, masks: torch.Tensor) -> torch.Tensor:
    """masks [B, 4H, 4W, 1] -> the dense embedding [B, H, W, C], in the
    masks' dtype."""
    md = p.mask_downscaling
    x = gelu(layer_norm(md.conv1(masks, stride=2), md.ln1.scale, md.ln1.bias, 1e-6))
    x = gelu(layer_norm(md.conv2(x, stride=2), md.ln2.scale, md.ln2.bias, 1e-6))
    return md.conv3(x)


def full_prompt_encoder(
    p: FullPromptEncoder,
    cfg: PromptEncoderConfig,
    points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    boxes: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
    batch: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sparse [B, n, C] fp32, dense [B, H, W, C]): the points (coordinates
    [B, N, 2] and labels [B, N]) then the box corners, and the mask
    prompt's embedding or ``no_mask_embed`` broadcast to the grid."""
    d = cfg.embed_dim
    parts = []
    if points is not None:
        coords, labels = points
        batch = coords.shape[0]
        parts.append(embed_points(p, coords, labels, cfg, pad=boxes is None))
    if boxes is not None:
        batch = boxes.shape[0]
        parts.append(embed_boxes(p, boxes, cfg))
    dev = p.no_mask_embed.device
    sparse = torch.cat(parts, dim=1) if parts else torch.zeros(batch, 0, d, device=dev)
    if masks is not None:
        return sparse, embed_masks(p, masks)
    h, w = cfg.image_embedding_size
    return sparse, p.no_mask_embed.reshape(1, 1, 1, d).expand(batch, h, w, d)
