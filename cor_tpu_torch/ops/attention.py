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
