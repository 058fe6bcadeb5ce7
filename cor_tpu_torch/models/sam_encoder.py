"""The SAM ViT image encoder, the PyTorch counterpart of
``cor_tpu.models.sam_encoder``.

A [B, 1024, 1024, 3] NHWC image becomes a [B, 64, 64, 256] NHWC embedding:

- the 16 x 16 / stride-16 patch embed as unfold + one GEMM, the unfolded
  patch in cor_tpu's (ph, pw, c) order (``patch_embed`` is a Dense);
- the absolute position embedding ``pos_embed`` [1, g, g, C];
- ``depth`` blocks: LN -> window partition (14 x 14 windows, the 64 x 64 grid
  zero-padded to 70 x 70) -> attention with the decomposed rel-pos bias ->
  unpartition -> residual -> LN -> MLP -> residual. The blocks of
  ``global_attn_indexes`` attend over the whole grid;
- the neck: 1 x 1 conv -> LN -> 3 x 3 conv -> LN (eps 1e-6), to 256 channels.

On a CUDA tensor every LayerNorm runs K5 (``ops.kernels.layernorm``) and
every attention K6 (``ops.kernels.vit_attention``): per forward of SAM-base,
26 K5 and 12 K6 launches. With ``fused_window_indexing`` (cor_tpu's opt-in,
which no YAML sets) a windowed block skips the partition copies: it pads x
to whole windows and attends through K7, which reads the windows by strides
(``ops.attention.attention_2d_fused(..., window=)``); SAM-base then launches
K7 8 times and K6 4 times per forward, sam_huge 28 and 4. Modules name their
parameters after the leaves of ``init_sam_encoder``'s tree, so a ``cor_tpu``
tree loads through ``utils.weights.load_cor_tpu_params``.

Config values the port does not run are refused with the ROADMAP item that
ports them: ``seq_shard`` and ``pp_stages > 1`` (parallel), and, on the
card, ``fused_attention=False`` or ``fused_layernorm=False`` (the plain
formulations are test oracles on the CPU, not a served path).
``remat_blocks`` (default on; ``TrainConfig.encoder_remat`` overrides it)
acts where autograd records the forward (an unfrozen fine-tune): each block
runs under ``torch.utils.checkpoint`` and is recomputed in the backward, so
only the blocks' inputs stay alive (the fp32 GELU polynomial's
intermediates alone would hold ~0.75 GB per image per block). Its K6 and K5
then launch twice per training step, and K6b once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cor_tpu_torch.ops.attention import (
    Attention2d,
    attention_2d,
    attention_2d_fused,
    window_partition,
    window_unpartition,
)
from cor_tpu_torch.ops.common import Conv2d, Dense, LayerNorm, MlpBlock, layer_norm
from cor_tpu_torch.ops.kernels.layernorm import layer_norm as layer_norm_kernel

NECK_EPS = 1e-6


@dataclass(frozen=True)
class SamEncoderConfig:
    img_size: int = 1024
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    qkv_bias: bool = True
    use_abs_pos: bool = True
    use_rel_pos: bool = True
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    ln_eps: float = 1e-6
    fused_attention: bool = True  # K6; False: attention_2d (CPU only)
    remat_blocks: bool = True  # recompute each block in the backward (training only)
    fused_layernorm: bool = True  # K5; False: ops.common.layer_norm (CPU only)
    fused_window_indexing: bool = False  # windowed blocks through K7
    seq_shard: bool = False  # refused: parallel
    pp_stages: int = 0  # refused above 1: parallel
    pp_microbatches: int = 4

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


# size table (cor_tpu sam_encoder.SAM_SIZES)
SAM_SIZES = {
    "sam_base": dict(embed_dim=768, depth=12, num_heads=12, global_attn_indexes=(2, 5, 8, 11)),
    "sam_large": dict(embed_dim=1024, depth=24, num_heads=16, global_attn_indexes=(5, 11, 17, 23)),
    "sam_huge": dict(embed_dim=1280, depth=32, num_heads=16, global_attn_indexes=(7, 15, 23, 31)),
}


def sam_encoder_config(name: str, **overrides) -> SamEncoderConfig:
    if name not in SAM_SIZES:
        raise ValueError(f"Invalid SAM model: {name}")
    return SamEncoderConfig(**{**SAM_SIZES[name], **overrides})


def check_config(cfg) -> None:
    """Refuse the config values the port does not run, naming their item."""
    if cfg.seq_shard or cfg.pp_stages > 1:
        raise ValueError(
            "seq_shard and pp_stages > 1 are not ported to cor_tpu_torch yet: ROADMAP "
            "Queue 1, item 9 (parallel)"
        )


def _ln(p: LayerNorm, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.fused_layernorm:
        return layer_norm_kernel(x, p.scale, p.bias, p.eps)
    return layer_norm(x, p.scale, p.bias, p.eps)


class SamBlock(nn.Module):
    """cor_tpu ``init_sam_encoder``'s block: ``norm1``, ``attn``, ``norm2``,
    ``mlp``; ``window`` 0 for a global block."""

    def __init__(self, cfg, window: int):
        super().__init__()
        self.cfg = cfg
        self.window = window
        size = (cfg.grid, cfg.grid) if window == 0 else (window, window)
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.ln_eps)
        self.attn = Attention2d(cfg.embed_dim, cfg.num_heads,
                                size if cfg.use_rel_pos else None, cfg.qkv_bias)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.ln_eps)
        self.mlp = MlpBlock(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        shortcut = x
        x = _ln(self.norm1, x, cfg)
        if cfg.fused_attention and self.window > 0 and cfg.fused_window_indexing:
            # the partition inside the kernel's indexing (K7)
            x = attention_2d_fused(self.attn, x, cfg.num_heads, window=self.window)
        else:
            if self.window > 0:
                hw = x.shape[1:3]
                x, pad_hw = window_partition(x, self.window)
            attn = attention_2d_fused if cfg.fused_attention else attention_2d
            x = attn(self.attn, x, cfg.num_heads)
            if self.window > 0:
                x = window_unpartition(x, self.window, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(_ln(self.norm2, x, cfg))


def _call_block(block: SamBlock, names, x: torch.Tensor, *params) -> torch.Tensor:
    """``block(x)`` with these parameters: the tensors the forward ran with
    (``core_forward``'s compute-dtype copies) are the ones the checkpoint's
    recompute in the backward runs with, not the module's own."""
    return torch.func.functional_call(block, dict(zip(names, params)), (x,))


class Neck(nn.Module):
    def __init__(self, embed_dim: int, out_chans: int):
        super().__init__()
        self.conv1 = Conv2d(embed_dim, out_chans, 1, bias=False)
        self.ln1 = LayerNorm(out_chans, NECK_EPS)
        self.conv2 = Conv2d(out_chans, out_chans, 3, bias=False)
        self.ln2 = LayerNorm(out_chans, NECK_EPS)


class SamEncoder(nn.Module):
    """cor_tpu ``init_sam_encoder`` (the parameters, initialised by
    ``ops.common.reset_all`` with zero ``pos_embed`` and rel-pos tables) and
    ``sam_encoder`` (``forward``)."""

    def __init__(self, cfg):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        patch_dim = cfg.patch_size * cfg.patch_size * cfg.in_chans
        self.patch_embed = Dense(patch_dim, cfg.embed_dim)
        self.pos_embed = None
        if cfg.use_abs_pos:
            self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, cfg.embed_dim))
        self.blocks = nn.ModuleList(
            SamBlock(cfg, 0 if i in cfg.global_attn_indexes else cfg.window_size)
            for i in range(cfg.depth)
        )
        self.neck = Neck(cfg.embed_dim, cfg.out_chans)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.pos_embed is not None:
            self.pos_embed.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, img, img, in_chans] NHWC -> [B, grid, grid, out_chans]."""
        cfg = self.cfg
        if x.device.type != "cpu" and not (cfg.fused_attention and cfg.fused_layernorm):
            raise ValueError(
                "fused_attention=False and fused_layernorm=False select the plain "
                "formulations, which are test oracles on the CPU: the card runs K5 and K6"
            )
        B, Hi, Wi, Cin = x.shape
        P = cfg.patch_size
        gh, gw = Hi // P, Wi // P
        x = x.reshape(B, gh, P, gw, P, Cin).permute(0, 1, 3, 2, 4, 5)
        x = self.patch_embed(x.reshape(B, gh, gw, P * P * Cin))
        if self.pos_embed is not None:
            x = x + self.pos_embed.to(x.dtype)
        remat = cfg.remat_blocks and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                names, params = zip(*block.named_parameters())
                x = checkpoint(_call_block, block, names, x, *params, use_reentrant=False)
            else:
                x = block(x)
        n = self.neck
        x = _ln(n.ln1, n.conv1(x), cfg)
        return _ln(n.ln2, n.conv2(x, padding=1), cfg)
