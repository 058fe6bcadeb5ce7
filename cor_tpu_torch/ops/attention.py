"""Multi-head attention, the PyTorch counterpart of ``cor_tpu.ops.attention``:

- the SigLIP towers' fused-QKV attention (``attention_heads``,
  ``AttentionSeq``) and the SAM decoder's ``AttentionQKV``;
- the SAM ViT encoder's attention over a 2-D token grid: window
  partitioning, the decomposed relative-position bias (``get_rel_pos``,
  ``decomposed_rel_pos_bias``), ``Attention2d`` (the leaves of
  ``init_attention_2d``), ``attention_2d`` (the plain formulation, a test
  oracle) and ``attention_2d_fused`` (the served path; with ``window``, the
  window partition inside the kernel).

The QKV projections are ``F.linear`` (large GEMMs, left to cuBLAS as
``cor_tpu`` leaves them to XLA); the softmax cores run in the hand-written
kernels ``ops.kernels.seq_attention`` (K4) and ``ops.kernels.vit_attention``
(K6, K7) on a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cor_tpu_torch.ops.common import Dense
from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv
from cor_tpu_torch.ops.kernels.vit_attention import (
    vit_attention_relpos,
    vit_attention_relpos_windows,
)


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


# ---------------------------------------------------------------------------
# SAM ViT attention over a 2-D token grid
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """[B, H, W, C] -> ([B * nW, window, window, C], (Hp, Wp)), zero-padding
    H and W up to multiples of ``window``. The pad tokens are real keys of
    their window's attention (their k and v are the qkv bias)."""
    B, H, W, C = x.shape
    pad_h = (window - H % window) % window
    pad_w = (window - W % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window, window, Wp // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, C), (Hp, Wp)


def window_unpartition(
    windows: torch.Tensor, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    """The inverse of ``window_partition``; crops the padding."""
    Hp, Wp = pad_hw
    H, W = hw
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // window) * (Wp // window))
    x = windows.reshape(B, Hp // window, Wp // window, window, window, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :]
    return x.contiguous()


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """The (L, head_dim) table read at every (query, key) offset of a
    (q_size, k_size) axis: [q_size, k_size, head_dim]. A table whose length is
    not 2 * max(q_size, k_size) - 1 is first resized linearly along its
    length (half-pixel centres, no antialiasing), in fp32."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(
            rel_pos.float().t()[None], size=max_rel_dist, mode="linear", align_corners=False,
        )[0].t().to(rel_pos.dtype)
    # float32 coordinates, truncated to int, as cor_tpu computes them
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[relative.to(torch.long).to(rel_pos.device)]


def decomposed_rel_pos_bias(
    q: torch.Tensor,
    rel_pos_h: torch.Tensor,
    rel_pos_w: torch.Tensor,
    q_size: Tuple[int, int],
    k_size: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rel_h [B, qh, qw, kh], rel_w [B, qh, qw, kw]) fp32 bias factors of
    q [B, qh * qw, head_dim]: the tables in q's dtype, the products summed
    in fp32. The caller adds rel_h[..., :, None] + rel_w[..., None, :] to the
    logits viewed as [B, qh, qw, kh, kw]."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h).to(q.dtype).float()
    Rw = get_rel_pos(q_w, k_w, rel_pos_w).to(q.dtype).float()
    r_q = q.reshape(q.shape[0], q_h, q_w, -1).float()
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    return rel_h, rel_w


class Attention2d(nn.Module):
    """cor_tpu ``init_attention_2d``: ``qkv`` and ``proj`` Dense layers and,
    with ``input_size``, the relative-position tables ``rel_pos_h``
    [2 H - 1, head_dim] and ``rel_pos_w`` [2 W - 1, head_dim], zeros at init
    as in cor_tpu."""

    def __init__(
        self,
        dim: int,
        num_heads: int,
        input_size: Optional[Tuple[int, int]] = None,
        qkv_bias: bool = True,
    ):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.proj = Dense(dim, dim)
        self.rel_pos_h = self.rel_pos_w = None
        if input_size is not None:
            head_dim = dim // num_heads
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.rel_pos_h is not None:
            self.rel_pos_h.zero_()
            self.rel_pos_w.zero_()


def attention_2d(p: Attention2d, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head self-attention over an NHWC grid [B, H, W, C] with the
    decomposed rel-pos bias, materialising the fp32 [B * heads, N, N] logits
    (cor_tpu ``attention_2d``): the oracle of ``attention_2d_fused``."""
    B, H, W, C = x.shape
    N = H * W
    head_dim = C // num_heads
    qkv = p.qkv(x.reshape(B, N, C))
    qkv = qkv.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, B * num_heads, N, head_dim)
    attn = torch.einsum("bqd,bkd->bqk", (q * head_dim**-0.5).float(), k.float())
    if p.rel_pos_h is not None:
        rel_h, rel_w = decomposed_rel_pos_bias(q, p.rel_pos_h, p.rel_pos_w, (H, W), (H, W))
        attn = attn.reshape(B * num_heads, H, W, H, W)
        attn = attn + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
        attn = attn.reshape(B * num_heads, N, N)
    attn = torch.softmax(attn, dim=-1).to(x.dtype)
    out = torch.einsum("bqk,bkd->bqd", attn.float(), v.float()).to(x.dtype)
    out = out.reshape(B, num_heads, H, W, head_dim).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
    return p.proj(out)


def rel_pos_factors(
    p: Attention2d, q: torch.Tensor, hw: Tuple[int, int], num_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's bias factors from the unscaled q [B, N, C] of the fused QKV
    output: (rel_h [B, heads, N, H], rel_w [B, heads, N, W]), the tables
    rounded to q's dtype, the products summed in fp32 and rounded to q's
    dtype (cor_tpu ``_attention_2d_fused_impl``; not padded). Without tables
    (``use_rel_pos=False``) the factors are zeros."""
    H, W = hw
    B, N, C = q.shape
    if p.rel_pos_h is None:
        return (q.new_zeros(B, num_heads, N, H), q.new_zeros(B, num_heads, N, W))
    qh = q.reshape(B, N, num_heads, C // num_heads).transpose(1, 2).reshape(B * num_heads, N, -1)
    rel_h, rel_w = decomposed_rel_pos_bias(qh, p.rel_pos_h, p.rel_pos_w, hw, hw)
    return (rel_h.to(q.dtype).reshape(B, num_heads, N, H),
            rel_w.to(q.dtype).reshape(B, num_heads, N, W))


def window_rel_pos_factors(
    p: Attention2d, q: torch.Tensor, window: int, num_heads: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's bias factors from the unscaled q [B, Hp, Wp, C] of the padded
    grid's fused QKV: (rel_h, rel_w) [B, heads, Hp * Wp, window], each grid
    token's factors over its window's key rows and columns, with the tables
    at window size read at the token's row and column within its window;
    rounded as ``rel_pos_factors`` rounds (cor_tpu
    ``_attention_2d_fused_impl`` with ``window``, without its 8-sublane
    column padding). No partition copy is made."""
    B, Hp, Wp, C = q.shape
    D = C // num_heads
    if p.rel_pos_h is None:
        return (q.new_zeros(B, num_heads, Hp * Wp, window),
                q.new_zeros(B, num_heads, Hp * Wp, window))
    Rh = get_rel_pos(window, window, p.rel_pos_h).to(q.dtype).float()  # [row, key row, D]
    Rw = get_rel_pos(window, window, p.rel_pos_w).to(q.dtype).float()
    qf = q.float()
    # grid row y = a * window + r, column x = c * window + s
    rel_h = torch.einsum("barxnd,rkd->bnarxk",
                         qf.reshape(B, Hp // window, window, Wp, num_heads, D), Rh)
    rel_w = torch.einsum("bycsnd,skd->bnycsk",
                         qf.reshape(B, Hp, Wp // window, window, num_heads, D), Rw)
    return (rel_h.to(q.dtype).reshape(B, num_heads, Hp * Wp, window),
            rel_w.to(q.dtype).reshape(B, num_heads, Hp * Wp, window))


def attention_2d_fused(
    p: Attention2d, x: torch.Tensor, num_heads: int, window: int = 0
) -> torch.Tensor:
    """``attention_2d`` through K6 (cor_tpu ``attention_2d_fused`` with
    window 0, the served path of both the global blocks and the windowed
    blocks after ``window_partition``): the fused QKV GEMM, the bias factors
    from the unscaled q with plain einsums, then the kernel, which never
    materialises the logits.

    With ``window > 0`` (cor_tpu's opt-in ``fused_window_indexing``), x
    [B, H, W, C] is the whole grid: it is zero-padded to multiples of the
    window, the QKV GEMM runs over the padded grid (so the pad tokens' k and
    v are the qkv bias, as after ``window_partition``), and K7 attends within
    each window by strides and writes the cropped [B, H, W, C]; it equals
    ``window_partition`` + ``attention_2d`` + ``window_unpartition``. K7's
    gradient is its plain version's VJP, recomputed in the backward (as
    cor_tpu's oracle VJP is)."""
    if window > 0:
        B, H, W, C = x.shape
        pad_h, pad_w = (window - H % window) % window, (window - W % window) % window
        if pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        qkv = p.qkv(x)  # [B, Hp, Wp, 3C]
        rel_h, rel_w = window_rel_pos_factors(p, qkv[..., :C], window, num_heads)
        out = vit_attention_relpos_windows(qkv, rel_h, rel_w, num_heads, window, (H, W))
        return p.proj(out)
    B, H, W, C = x.shape
    N = H * W
    qkv = p.qkv(x.reshape(B, N, C))  # [B, N, 3C], heads contiguous per third
    rel_h, rel_w = rel_pos_factors(p, qkv[..., :C], (H, W), num_heads)
    out = vit_attention_relpos(qkv, rel_h, rel_w, num_heads, (H, W))
    return p.proj(out.reshape(B, H, W, C))
