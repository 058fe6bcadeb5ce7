"""SAM mask decoder and two-way transformer, the PyTorch counterpart of
``cor_tpu.models.sam_decoder``: the inference (``fused=True``) path through
the decoder kernels, and the training (``fused=False``) path in plain
PyTorch, as ``cor_tpu`` runs it in XLA.

- ``TwoWayTransformer``: two TwoWayAttentionBlocks (token self-attention,
  token -> image attention, ReLU MLP, image -> token attention, 4 LNs,
  attention downsample 2) and a final token -> image attention + LN
  (reference transformer.py:16-106). Each block runs through
  ``ops/kernels/two_way_layer`` and the final attention through
  ``ops/kernels/t2i_flash``; the image PE enters through the projections
  only (``proj(keys) + proj(key_pe)``, with ``key_pe`` kept batch-1).
- ``MaskDecoder``: tokens = [iou_token; mask_tokens; sparse prompt], the
  transformer against image embedding + dense prompt, the upscale tail and
  hypernetwork dot in ``ops/kernels/decoder_tail``, and the IoU head
  (reference mask_decoder.py:16-142). Only the selected mask token's map is
  computed.

``fused=False`` (``_two_way_block``, the final attention and the upscale
tail as separate ops: LN eps 1e-6, GELU, transposed conv, GELU, the
hypernetwork einsum) is differentiable and runs no kernel; the kernels have
no backward and refuse to be differentiated.

Parameters are named after ``cor_tpu``'s tree (``init_mask_decoder``), so the
weight bridge maps a ``cor_tpu`` tree onto the module; the transposed-conv
kernels keep ``cor_tpu``'s layout [C_in, 2, 2, C_out].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cor_tpu_torch.ops.attention import AttentionQKV, attention_heads
from cor_tpu_torch.ops.common import (
    LayerNorm,
    MlpBlock,
    MlpStack,
    gelu,
    layer_norm,
    mlp_block,
    torch_uniform_,
)
from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv
from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer

LN_EPS = 1e-5  # the two-way transformer's LayerNorms (the tail's is 1e-6)


@dataclass(frozen=True)
class TwoWayTransformerConfig:
    depth: int = 2
    embedding_dim: int = 256
    num_heads: int = 8
    mlp_dim: int = 2048
    attention_downsample_rate: int = 2


@dataclass(frozen=True)
class MaskDecoderConfig:
    transformer_dim: int = 256
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    transformer: TwoWayTransformerConfig = TwoWayTransformerConfig()

    @property
    def num_mask_tokens(self) -> int:
        return self.num_multimask_outputs + 1


class TwoWayBlock(nn.Module):
    def __init__(self, cfg: TwoWayTransformerConfig):
        super().__init__()
        d, h, r = cfg.embedding_dim, cfg.num_heads, cfg.attention_downsample_rate
        self.self_attn = AttentionQKV(d, h)
        self.norm1 = LayerNorm(d, LN_EPS)
        self.cross_attn_t2i = AttentionQKV(d, h, r)
        self.norm2 = LayerNorm(d, LN_EPS)
        self.mlp = MlpBlock(d, cfg.mlp_dim)
        self.norm3 = LayerNorm(d, LN_EPS)
        self.norm4 = LayerNorm(d, LN_EPS)
        self.cross_attn_i2t = AttentionQKV(d, h, r)


class TwoWayTransformer(nn.Module):
    def __init__(self, cfg: TwoWayTransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(TwoWayBlock(cfg) for _ in range(cfg.depth))
        self.final_attn_t2i = AttentionQKV(
            cfg.embedding_dim, cfg.num_heads, cfg.attention_downsample_rate
        )
        self.norm_final = LayerNorm(cfg.embedding_dim, LN_EPS)


class ConvTranspose2x(nn.Module):
    """A 2x2 stride-2 transposed convolution's parameters in cor_tpu's layout:
    ``w`` [C_in, 2, 2, C_out], ``b`` [C_out]; torch ConvTranspose2d's init,
    U(+-1/sqrt(fan_in)) with fan_in = C_in * 4."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_ch, 2, 2, out_ch))
        self.b = nn.Parameter(torch.empty(out_ch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.w.shape[0] * 4
        torch_uniform_(self.w, fan_in, generator)
        torch_uniform_(self.b, fan_in, generator)


class OutputUpscaling(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.convt1 = ConvTranspose2x(d, d // 4)
        self.ln = LayerNorm(d // 4, 1e-6)
        self.convt2 = ConvTranspose2x(d // 4, d // 8)


class MaskDecoder(nn.Module):
    def __init__(self, cfg: MaskDecoderConfig):
        super().__init__()
        d, nmt = cfg.transformer_dim, cfg.num_mask_tokens
        self.cfg = cfg
        self.iou_token = nn.Parameter(torch.empty(1, d))
        self.mask_tokens = nn.Parameter(torch.empty(nmt, d))
        self.transformer = TwoWayTransformer(cfg.transformer)
        self.output_upscaling = OutputUpscaling(d)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MlpStack(d, d, d // 8, 3) for _ in range(nmt)
        )
        self.iou_prediction_head = MlpStack(d, cfg.iou_head_hidden_dim, nmt, cfg.iou_head_depth)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # torch nn.Embedding's default init, N(0, 1)
        self.iou_token.copy_(torch.randn(self.iou_token.shape, generator=generator))
        self.mask_tokens.copy_(torch.randn(self.mask_tokens.shape, generator=generator))


def _matmul_nobias(d, x: torch.Tensor) -> torch.Tensor:
    """x @ w without the bias (the linear PE decomposition), in x.dtype."""
    return torch.nn.functional.linear(x, d.w.to(x.dtype))


def _ln(p: LayerNorm, x: torch.Tensor, eps: float = LN_EPS) -> torch.Tensor:
    return layer_norm(x, p.scale, p.bias, eps)


def _two_way_block(lp: TwoWayBlock, queries, keys, query_pe, key_pe, num_heads: int,
                   skip_first_layer_pe: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One TwoWayAttentionBlock as separate ops (cor_tpu ``_two_way_block``
    with ``fused=False``): ``proj(keys + key_pe)`` as ``proj(keys) +
    proj(key_pe)`` with ``key_pe`` [1, N, C] kept batch-1."""
    if skip_first_layer_pe:
        queries = lp.self_attn(queries, queries, queries)
    else:
        q = queries + query_pe
        queries = queries + lp.self_attn(q, q, queries)
    queries = _ln(lp.norm1, queries)

    t2i, i2t = lp.cross_attn_t2i, lp.cross_attn_i2t
    kpe = _matmul_nobias(t2i.k_proj, key_pe)
    qpe = _matmul_nobias(i2t.q_proj, key_pe)
    q_tok = t2i.q_proj(queries + query_pe)
    k_img = t2i.k_proj(keys) + kpe
    v_img = t2i.v_proj(keys)
    q_img = i2t.q_proj(keys) + qpe
    queries = queries + t2i.out_proj(attention_heads(q_tok, k_img, v_img, num_heads))
    queries = _ln(lp.norm2, queries)

    queries = queries + mlp_block(lp.mlp, queries, act=torch.relu)
    queries = _ln(lp.norm3, queries)

    k_tok = i2t.k_proj(queries + query_pe)
    v_tok = i2t.v_proj(queries)
    attn_out = i2t.out_proj(attention_heads(q_img, k_tok, v_tok, num_heads))
    keys = _ln(lp.norm4, keys + attn_out)
    return queries, keys


def _two_way_transformer_unfused(p: TwoWayTransformer, image_embedding, image_pe,
                                 point_embedding) -> Tuple[torch.Tensor, torch.Tensor]:
    B, H, W, C = image_embedding.shape
    keys = image_embedding.reshape(B, H * W, C)
    key_pe = image_pe.reshape(1, H * W, C).to(image_embedding.dtype)
    queries = query_pe = point_embedding
    for i, lp in enumerate(p.layers):
        queries, keys = _two_way_block(lp, queries, keys, query_pe, key_pe, p.cfg.num_heads,
                                       skip_first_layer_pe=(i == 0))
    fa = p.final_attn_t2i
    q_tok = fa.q_proj(queries + query_pe)
    k_img = fa.k_proj(keys) + _matmul_nobias(fa.k_proj, key_pe)
    attn_out = attention_heads(q_tok, k_img, fa.v_proj(keys), p.cfg.num_heads)
    queries = _ln(p.norm_final, queries + fa.out_proj(attn_out))
    return queries, keys


def _conv_transpose_2x(p: ConvTranspose2x, x: torch.Tensor) -> torch.Tensor:
    """2 x 2 stride-2 transposed convolution, NHWC in x.dtype, the bias added
    after the product is rounded (cor_tpu ``_conv_transpose_2x``)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p.w.to(x.dtype).permute(0, 3, 1, 2), stride=2)
    return y.permute(0, 2, 3, 1) + p.b.to(x.dtype)


def two_way_transformer(
    p: TwoWayTransformer,
    image_embedding: torch.Tensor,  # [B, H, W, C], or a store [S, H, W, C]
    image_pe: torch.Tensor,  # [1, H, W, C]
    point_embedding: torch.Tensor,  # [B, T, C]
    store_idx: Optional[torch.Tensor] = None,  # int32 [B]: candidate b reads store row idx[b]
    store_scale: Optional[torch.Tensor] = None,  # fp32 [S]: the store is int8
    fused: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(queries [B, T, C], keys [B, H*W, C]) in the compute dtype.
    ``fused=False`` is the differentiable path (no store)."""
    S, H, W, C = image_embedding.shape
    if not fused:
        if store_idx is not None:
            raise ValueError("the fused=False path takes image embeddings, not a store")
        return _two_way_transformer_unfused(p, image_embedding, image_pe, point_embedding)
    if store_scale is not None and store_idx is None:
        raise ValueError("an int8 store needs store_idx")
    comp_dt = point_embedding.dtype if store_scale is not None else image_embedding.dtype
    keys = image_embedding.reshape(S, H * W, C)
    key_pe = image_pe.reshape(1, H * W, C).to(comp_dt)
    queries = query_pe = point_embedding
    for i, lp in enumerate(p.layers):
        kpe = _matmul_nobias(lp.cross_attn_t2i.k_proj, key_pe)[0]
        qpe = _matmul_nobias(lp.cross_attn_i2t.q_proj, key_pe)[0]
        queries, keys = two_way_layer(
            lp, queries, query_pe, keys, kpe, qpe, skip_pe=(i == 0), eps=LN_EPS,
            idx=store_idx if i == 0 else None, scale=store_scale if i == 0 else None,
        )
    fa = p.final_attn_t2i
    q_tok = fa.q_proj(queries + query_pe)
    kpe = _matmul_nobias(fa.k_proj, key_pe)[0]
    attn_out = t2i_flash_kv(keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe,
                            q_tok, p.cfg.num_heads)
    queries = queries + fa.out_proj(attn_out)
    queries = layer_norm(queries, p.norm_final.scale, p.norm_final.bias, LN_EPS)
    return queries, keys


def mask_decoder(
    p: MaskDecoder,
    image_embeddings: torch.Tensor,  # [B, H, W, C], or a store [S, H, W, C]
    image_pe: torch.Tensor,  # [1, H, W, C]
    sparse_prompt_embeddings: torch.Tensor,  # [B, N_s, C]
    dense_prompt_embeddings: Optional[torch.Tensor],  # [B, H, W, C]; None: pre-baked
    multimask_output: bool,
    store_idx: Optional[torch.Tensor] = None,
    store_scale: Optional[torch.Tensor] = None,
    fused: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(masks [B, n_out, 4H, 4W], iou_pred [B, n_out], src [B, H*W, C]),
    masks in the compute dtype. ``fused=False``: the training path."""
    S, H, W, C = image_embeddings.shape
    B = store_idx.shape[0] if store_idx is not None else S
    nmt = p.cfg.num_mask_tokens
    if store_idx is not None and dense_prompt_embeddings is not None:
        raise ValueError("store-indexed decode takes the dense prompt pre-baked into the store "
                         "(dense_prompt_embeddings=None)")
    comp_dt = sparse_prompt_embeddings.dtype if store_scale is not None else image_embeddings.dtype
    output_tokens = torch.cat([p.iou_token, p.mask_tokens]).to(comp_dt)
    tokens = torch.cat([output_tokens[None].expand(B, -1, -1), sparse_prompt_embeddings], dim=1)
    src = image_embeddings
    if dense_prompt_embeddings is not None:
        src = image_embeddings + dense_prompt_embeddings

    hs, src_seq = two_way_transformer(p.transformer, src, image_pe, tokens, store_idx, store_scale,
                                      fused=fused)
    mask_tokens_out = hs[:, 1 : 1 + nmt, :]
    token_ids = list(range(1, nmt)) if multimask_output else [0]
    hyper_in = torch.stack(
        [p.output_hypernetworks_mlps[i](mask_tokens_out[:, i, :]) for i in token_ids], dim=1
    )  # [B, n_out, C/8]
    up = p.output_upscaling
    if fused:
        masks = decoder_tail(
            src_seq.reshape(B, H, W, C), up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias,
            up.convt2.w, up.convt2.b, hyper_in,
        ).to(comp_dt)
    else:
        x = gelu(layer_norm(_conv_transpose_2x(up.convt1, src_seq.reshape(B, H, W, C)),
                            up.ln.scale, up.ln.bias, 1e-6))
        upscaled = gelu(_conv_transpose_2x(up.convt2, x))  # [B, 4H, 4W, C/8]
        masks = torch.einsum("bnc,bhwc->bnhw", hyper_in, upscaled).to(comp_dt)
    iou_pred = p.iou_prediction_head(hs[:, 0, :])
    iou_pred = iou_pred[:, 1:] if multimask_output else iou_pred[:, 0:1]
    return masks, iou_pred, src_seq
