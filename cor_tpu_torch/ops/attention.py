"""Multi-head attention for the SigLIP towers, the PyTorch counterpart of the
fused-QKV part of ``cor_tpu.ops.attention`` (``attention_heads``,
``init_attention_seq``, ``attention_seq``).

The fused QKV projection is one ``F.linear`` (a large GEMM, left to cuBLAS as
``cor_tpu`` leaves it to XLA); the softmax core runs in the hand-written
kernel ``cor_tpu_torch.ops.kernels.seq_attention`` on a CUDA tensor.
"""

from __future__ import annotations

import torch
from torch import nn

from cor_tpu_torch.ops.common import Dense
from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv


def attention_heads(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """Scaled-dot-product attention on projected [B, N, C] operands.

    Logits and softmax in fp32; the probabilities are cast to q.dtype before
    the product with v, which accumulates in fp32."""
    B, Nq, C = q.shape
    Nk = k.shape[1]
    hd = C // num_heads
    qh = q.reshape(B, Nq, num_heads, hd).float()
    kh = k.reshape(B, Nk, num_heads, hd).float()
    vh = v.reshape(B, Nk, num_heads, hd).float()
    attn = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / (hd**0.5)
    attn = torch.softmax(attn, dim=-1).to(q.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", attn, vh)
    return out.to(q.dtype).reshape(B, Nq, C)


class AttentionQKV(nn.Module):
    """cor_tpu ``init_attention_qkv`` / ``attention_qkv``: separate q/k/v/out
    projections with an internal width ``embed_dim // downsample_rate`` (the
    SAM two-way transformer's attention)."""

    def __init__(self, embed_dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        internal = embed_dim // downsample_rate
        if internal % num_heads:
            raise ValueError(f"internal width {internal} is not a multiple of {num_heads} heads")
        self.num_heads = num_heads
        self.q_proj = Dense(embed_dim, internal)
        self.k_proj = Dense(embed_dim, internal)
        self.v_proj = Dense(embed_dim, internal)
        self.out_proj = Dense(internal, embed_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        out = attention_heads(self.q_proj(q), self.k_proj(k), self.v_proj(v), self.num_heads)
        return self.out_proj(out)


class AttentionSeq(nn.Module):
    """cor_tpu ``init_attention_seq`` (the parameters, initialised by
    ``reset_all``) and ``attention_seq`` (``forward``): fused-QKV
    self-attention over [B, N, C], no mask."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x)  # [B, N, 3C], heads contiguous per third
        return self.proj(attention_seq_qkv(qkv, self.num_heads))
