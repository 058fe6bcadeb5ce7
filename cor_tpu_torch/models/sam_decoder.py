"""SAM mask decoder and two-way transformer, the PyTorch counterpart of
``cor_tpu.models.sam_decoder``: the inference (``fused=True``) path through
the decoder kernels, and the training (``fused=False``) path in plain
PyTorch, as ``cor_tpu`` runs it in XLA.

- ``TwoWayTransformer``: two TwoWayAttentionBlocks (token self-attention,
  token -> image attention, ReLU MLP, image -> token attention, 4 LNs,
  attention downsample 2) and a final token -> image attention + LN
  (reference transformer.py:16-106). Each block runs through
  ``ops/kernels/two_way_layer`` (or K8a/K8b, below) and the final attention
  through ``ops/kernels/t2i_flash``; the image PE enters through the
  projections only (``proj(keys) + proj(key_pe)``, with ``key_pe`` kept
  batch-1).
- ``MaskDecoder``: tokens = [iou_token; mask_tokens; sparse prompt], the
  transformer against image embedding + dense prompt, the upscale tail and
  hypernetwork dot in ``ops/kernels/decoder_tail``, and the IoU head
  (reference mask_decoder.py:16-142). Only the selected mask token's map is
  computed.

``fused=False`` (``_two_way_block``, the final attention and the upscale
tail as separate ops: LN eps 1e-6, GELU, transposed conv, GELU, the
hypernetwork einsum) is differentiable and runs no kernel; the kernels have
no backward and refuse to be differentiated.

``fused=True`` routes as ``cor_tpu`` does (``layer_route``, its
``layer_fused`` test): a grid of H * W a multiple of 1,024 rows, at most 8
tokens and a width that the heads divide go through the per-layer kernel
(K1, at 5 to 8 tokens); other geometries (SAM's stock prompts above 8
tokens: ``prompt_encoder.full_prompt_encoder``) through
``_two_way_block(fused=True)``: the token side in plain PyTorch, the
token -> image attention and q_img in K8a (``ops/kernels/t2i_flash``
``proj_q_t2i_flash``), the image -> token attention and the rows' LN in K8b
(``ops/kernels/i2t_attention``), a store's rows gathered and dequantised
first in PyTorch, as ``cor_tpu`` does in XLA. The final attention is K2 at
every token count. The module flags ``GRID_FUSED``, ``STACK_FUSED`` and
``DMA_FUSED`` select ``cor_tpu``'s other schedules of the K1 route, with its
precedence and conditions: K1-grid, then K1-stack (the whole transformer and
the final attention in one kernel, depth 2, no int8 store), else K1-dma for
each layer. Off the CPU, what the kernels do not take (more than 32
tokens; a grid not 64 wide or not 256 channels; more than 65,535
candidates in one call) is refused before any kernel runs, naming its
ROADMAP row. On the CPU the plain versions run
every geometry.

Parameters are named after ``cor_tpu``'s tree (``init_mask_decoder``), so the
weight bridge maps a ``cor_tpu`` tree onto the module; the transposed-conv
kernels keep ``cor_tpu``'s layout [C_in, 2, 2, C_out].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from cor_tpu_torch.ops.attention import AttentionQKV, attention_heads
from cor_tpu_torch.ops.common import (
    LayerNorm,
    MlpBlock,
    MlpStack,
    convolution,
    gelu,
    layer_norm,
    mlp_block,
    torch_uniform_,
)
from cor_tpu_torch.ops.kernels.decoder_tail import GRID_W, decoder_tail
from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
from cor_tpu_torch.ops.kernels.t2i_flash import (
    C_DIM,
    MAX_TOKENS,
    proj_q_t2i_flash,
    t2i_flash_kv,
)
from cor_tpu_torch.ops.kernels.two_way_layer import gather_rows, two_way_layer, two_way_layer_dma
from cor_tpu_torch.ops.kernels.two_way_stack import two_way_grid_fused, two_way_stack_fused

# cor_tpu's opt-in decode schedules (models/sam_decoder.py:54-66), read at
# each call: the whole depth-2 transformer as one kernel with the token
# state fp32 throughout (K1-stack) or rounded between the layers (K1-grid;
# checked first), where K1 would run and the store is not int8; else each
# layer through K1-dma, K1 with its image passes behind a cp.async ring
STACK_FUSED = False
GRID_FUSED = False
DMA_FUSED = False

LN_EPS = 1e-5  # the two-way transformer's LayerNorms (the tail's is 1e-6)
# cor_tpu's layer_fused test (models/sam_decoder.py:255-260): K1's row tile
# and token pad (ops/pallas/two_way_layer.py:79-80)
LAYER_ROW_TILE, LAYER_MAX_TOKENS = 1024, 8
TOKENS_ROW = "ROADMAP Queue 2, @T>32 (decodes of more than 32 tokens)"
GRID_ROW = ("ROADMAP Queue 2, @grid (decoder grids other than 64 wide and 256 channels, the "
            "geometry of SAM's image encoder)")
# the decoder kernels index candidates by a grid dimension and K2's tickets
MAX_CANDIDATES = 65535
CANDIDATES_ROW = "ROADMAP Queue 2, @n>65535 (a fused decode of more than 65,535 candidates)"


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
                   skip_first_layer_pe: bool,
                   fused: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One TwoWayAttentionBlock (cor_tpu ``_two_way_block``): ``proj(keys +
    key_pe)`` as ``proj(keys) + proj(key_pe)`` with ``key_pe`` [1, N, C] kept
    batch-1. ``fused=False``: separate ops (differentiable); ``fused=True``:
    the token side as separate ops, the image side in K8a and K8b."""
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
    if fused:
        q_img, t2i_out = proj_q_t2i_flash(
            keys, t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b, i2t.q_proj.w,
            i2t.q_proj.b, kpe[0], qpe[0], q_tok, num_heads)
    else:
        k_img = t2i.k_proj(keys) + kpe
        v_img = t2i.v_proj(keys)
        q_img = i2t.q_proj(keys) + qpe
        t2i_out = attention_heads(q_tok, k_img, v_img, num_heads)
    queries = queries + t2i.out_proj(t2i_out)
    queries = _ln(lp.norm2, queries)

    queries = queries + mlp_block(lp.mlp, queries, act=torch.relu)
    queries = _ln(lp.norm3, queries)

    k_tok = i2t.k_proj(queries + query_pe)
    v_tok = i2t.v_proj(queries)
    if fused:
        keys = i2t_attention_fused(q_img, keys, k_tok, v_tok, i2t.out_proj.w, i2t.out_proj.b,
                                   lp.norm4.scale, lp.norm4.bias, num_heads, LN_EPS)
    else:
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
    y = convolution(x.permute(0, 3, 1, 2), p.w.to(x.dtype).permute(0, 3, 1, 2), stride=2,
                    transposed=True)
    return y.permute(0, 2, 3, 1) + p.b.to(x.dtype)


def layer_route(n_rows: int, n_tokens: int, width: int, num_heads: int) -> str:
    """cor_tpu's routing of a fused decode of ``n_rows`` = H * W image rows
    and ``n_tokens`` tokens: "layer" (K1, one kernel per layer) or "k8"
    (``_two_way_block(fused=True)``: K8a/K8b)."""
    if (n_rows % LAYER_ROW_TILE == 0 and n_tokens <= LAYER_MAX_TOKENS
            and width % num_heads == 0):
        return "layer"
    return "k8"


def check_fused_geometry(grid_w: int, n_tokens: int, width: int, n: int = 1) -> None:
    """Refuse, before any kernel runs, a fused decode on the card that the
    port's kernels do not take, naming the ROADMAP row that ports it. The
    decoder always has 5 output tokens; K3 takes a grid 64 wide (so H * W is
    a multiple of 64, the image passes' row tile) of 256 channels; every
    kernel at most ``MAX_CANDIDATES`` candidates (``n``) a call."""
    if n > MAX_CANDIDATES:
        raise ValueError(f"a fused decode of {n} candidates in one call: the decoder kernels "
                         f"take at most {MAX_CANDIDATES} ({CANDIDATES_ROW})")
    if n_tokens > MAX_TOKENS:
        raise ValueError(f"a fused decode of {n_tokens} tokens: the decoder kernels take at "
                         f"most {MAX_TOKENS} ({TOKENS_ROW})")
    if (grid_w, width) != (GRID_W, C_DIM):
        raise ValueError(f"a fused decode on a grid {grid_w} wide of {width} channels: the "
                         f"decoder kernels take {GRID_W} wide, {C_DIM} channels ({GRID_ROW})")


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
    T = point_embedding.shape[1]
    if image_embedding.device.type != "cpu":
        check_fused_geometry(W, T, C, S if store_idx is None else store_idx.shape[0])
    comp_dt = point_embedding.dtype if store_scale is not None else image_embedding.dtype
    keys = image_embedding.reshape(S, H * W, C)
    key_pe = image_pe.reshape(1, H * W, C).to(comp_dt)
    queries = query_pe = point_embedding
    route = layer_route(H * W, T, C, p.cfg.num_heads)
    if (route == "layer" and len(p.layers) == 2 and store_scale is None
            and (GRID_FUSED or STACK_FUSED)):
        # cor_tpu's whole-transformer schedules (models/sam_decoder.py:262-297)
        kpe_l = [_matmul_nobias(lp.cross_attn_t2i.k_proj, key_pe)[0] for lp in p.layers]
        qpe_l = [_matmul_nobias(lp.cross_attn_i2t.q_proj, key_pe)[0] for lp in p.layers]
        kpe_f = _matmul_nobias(p.final_attn_t2i.k_proj, key_pe)[0]
        fused_fn = two_way_grid_fused if GRID_FUSED else two_way_stack_fused
        return fused_fn(p, queries, query_pe, keys, kpe_l, qpe_l, kpe_f, idx=store_idx,
                        eps=LN_EPS)
    if route == "k8" and store_idx is not None:
        # cor_tpu's gather fallback (models/sam_decoder.py:321-327)
        keys = gather_rows(keys, store_idx, store_scale, comp_dt)
    layer_fn = two_way_layer_dma if DMA_FUSED else two_way_layer
    for i, lp in enumerate(p.layers):
        if route == "k8":
            queries, keys = _two_way_block(lp, queries, keys, query_pe, key_pe,
                                           p.cfg.num_heads, skip_first_layer_pe=(i == 0),
                                           fused=True)
        else:
            kpe = _matmul_nobias(lp.cross_attn_t2i.k_proj, key_pe)[0]
            qpe = _matmul_nobias(lp.cross_attn_i2t.q_proj, key_pe)[0]
            queries, keys = layer_fn(
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
