"""SigLIP image and text towers, the PyTorch counterpart of
``cor_tpu.models.siglip``.

- Vision: VALID patchify as unfold + one GEMM, learned position embedding,
  pre-LN blocks, final norm, MAP attention-pooling head. Returns the pooled
  feature and the post-norm patch grid [B, g, g, width] (NHWC).
- Text: token + position embedding, pre-LN blocks with no causal mask, final
  LN, last-token pooling, linear projection with bias.

The blocks' LayerNorms and the towers' final norms (``_ln``) run the
LayerNorm kernel (``ops.kernels.layernorm``) and every block's attention
core runs the sequence-attention kernel (``ops.kernels.seq_attention``) on a
CUDA tensor: 25 LayerNorm and 12 attention launches per tower at depth 12.
The MAP head's norm is the plain ``layer_norm``, as in ``cor_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch import nn

from cor_tpu_torch.ops.attention import AttentionSeq
from cor_tpu_torch.ops.common import Dense, LayerNorm, MlpBlock, l2_normalize, trunc_normal_
from cor_tpu_torch.ops.kernels.layernorm import layer_norm as layer_norm_kernel


@dataclass(frozen=True)
class SigLIPVisionConfig:
    image_size: int = 384
    patch_size: int = 16
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6

    @property
    def grid(self) -> int:
        # conv with VALID padding: floor((img - patch)/patch) + 1
        return (self.image_size - self.patch_size) // self.patch_size + 1

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid


@dataclass(frozen=True)
class SigLIPTextConfig:
    context_length: int = 64
    vocab_size: int = 32000
    width: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-6


@dataclass(frozen=True)
class SigLIPConfig:
    vision: SigLIPVisionConfig = SigLIPVisionConfig()
    text: SigLIPTextConfig = SigLIPTextConfig()

    @property
    def embed_dim(self) -> int:
        return self.vision.width


SIGLIP_MODELS: Dict[str, SigLIPConfig] = {
    "ViT-B-16-SigLIP-384": SigLIPConfig(
        SigLIPVisionConfig(384, 16, 768, 12, 12), SigLIPTextConfig(64, 32000, 768, 12, 12)
    ),
    "ViT-B-16-SigLIP2-384": SigLIPConfig(
        SigLIPVisionConfig(384, 16, 768, 12, 12), SigLIPTextConfig(64, 256000, 768, 12, 12)
    ),
    "ViT-L-16-SigLIP-384": SigLIPConfig(
        SigLIPVisionConfig(384, 16, 1024, 24, 16), SigLIPTextConfig(64, 32000, 1024, 24, 16)
    ),
    "ViT-L-16-SigLIP2-384": SigLIPConfig(
        SigLIPVisionConfig(384, 16, 1024, 24, 16), SigLIPTextConfig(64, 256000, 1024, 24, 16)
    ),
    "ViT-SO400M-14-SigLIP-384": SigLIPConfig(
        SigLIPVisionConfig(384, 14, 1152, 27, 16, mlp_ratio=3.7362),
        SigLIPTextConfig(64, 32000, 1152, 27, 16, mlp_ratio=3.7362),
    ),
}


# ---------------------------------------------------------------------------
# shared pre-LN block
# ---------------------------------------------------------------------------


def _ln(p: LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """The LayerNorm kernel (cor_tpu: ``layer_norm_pallas``)."""
    return layer_norm_kernel(x, p.scale, p.bias, p.eps)


class Block(nn.Module):
    def __init__(self, width: int, mlp_hidden: int, num_heads: int, eps: float):
        super().__init__()
        self.norm1 = LayerNorm(width, eps)
        self.attn = AttentionSeq(width, num_heads)
        self.norm2 = LayerNorm(width, eps)
        self.mlp = MlpBlock(width, mlp_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(_ln(self.norm1, x))
        return x + self.mlp(_ln(self.norm2, x))


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


class MapHead(nn.Module):
    """Attention pooling with a learned latent probe (timm AttentionPoolLatent)."""

    def __init__(self, width: int, mlp_hidden: int, num_heads: int, eps: float):
        super().__init__()
        self.num_heads = num_heads
        self.latent = nn.Parameter(torch.empty(1, 1, width))
        self.q = Dense(width, width)
        self.kv = Dense(width, 2 * width)
        self.proj = Dense(width, width)
        self.norm = LayerNorm(width, eps)
        self.mlp = MlpBlock(width, mlp_hidden)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.latent, 0.02, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        q = self.q(self.latent.to(x.dtype).expand(B, 1, C))
        kv = self.kv(x).reshape(B, N, 2, H, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0].float(), kv[1].float()
        qh = q.reshape(B, 1, H, hd).permute(0, 2, 1, 3).float()
        attn = torch.einsum("bhqd,bhkd->bhqk", qh, k) / (hd**0.5)
        attn = torch.softmax(attn, dim=-1).to(x.dtype).float()
        out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.to(x.dtype).permute(0, 2, 1, 3).reshape(B, 1, C)
        out = self.proj(out)
        out = out + self.mlp(self.norm(out))
        return out[:, 0]


class SigLIPVision(nn.Module):
    def __init__(self, cfg: SigLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        mlp_hidden = int(round(cfg.width * cfg.mlp_ratio))
        self.patch_embed = Dense(cfg.patch_size * cfg.patch_size * 3, cfg.width)
        self.pos_embed = nn.Parameter(torch.empty(1, cfg.num_patches, cfg.width))
        self.blocks = nn.ModuleList(
            Block(cfg.width, mlp_hidden, cfg.num_heads, cfg.ln_eps) for _ in range(cfg.depth)
        )
        self.norm = LayerNorm(cfg.width, cfg.ln_eps)
        self.attn_pool = MapHead(cfg.width, mlp_hidden, cfg.num_heads, cfg.ln_eps)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images [B, S, S, 3] -> (pooled [B, width], grid [B, g, g, width])."""
        cfg = self.cfg
        B = images.shape[0]
        ps, g = cfg.patch_size, cfg.grid
        crop = g * ps  # VALID patchify crops the remainder (384/14 -> 27)
        x = images[:, :crop, :crop, :]
        x = x.reshape(B, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(B, g * g, ps * ps * 3)
        x = self.patch_embed(x)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        tokens = _ln(self.norm, x)
        pooled = self.attn_pool(tokens)
        return pooled, tokens.reshape(B, g, g, cfg.width)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------


class SigLIPText(nn.Module):
    def __init__(self, cfg: SigLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        mlp_hidden = int(round(cfg.width * cfg.mlp_ratio))
        self.token_embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.width))
        self.positional_embedding = nn.Parameter(torch.empty(cfg.context_length, cfg.width))
        self.blocks = nn.ModuleList(
            Block(cfg.width, mlp_hidden, cfg.num_heads, cfg.ln_eps) for _ in range(cfg.depth)
        )
        self.ln_final = LayerNorm(cfg.width, cfg.ln_eps)
        self.text_projection = Dense(cfg.width, cfg.width)

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.token_embedding, 0.02, generator)
        trunc_normal_(self.positional_embedding, 0.01, generator)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """token_ids [B, context_length] int -> text features [B, width]."""
        x = self.token_embedding[token_ids.long()]
        x = x + self.positional_embedding[None].to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = _ln(self.ln_final, x)
        return self.text_projection(x[:, -1])


class SigLIP(nn.Module):
    def __init__(self, cfg: SigLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = SigLIPVision(cfg.vision)
        self.text = SigLIPText(cfg.text)

    def forward(
        self, images: torch.Tensor, token_ids: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """cor_tpu ``siglip_encode``: (image features L2-normed [B, D], text
        features L2-normed [B, D], patch grid [B, g, g, D])."""
        pooled, grid = self.visual(images)
        return l2_normalize(pooled), l2_normalize(self.text(token_ids)), grid
