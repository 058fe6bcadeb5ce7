"""One two-way transformer layer of the SAM mask decoder: the CUDA kernels
``csrc/two_way_layer.cu`` (with the image pass of ``csrc/t2i_flash.cu``) and
their plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused`` (its
``pallas_call``s at lines 978, 998 and 1012): one TwoWayAttentionBlock
(reference transformer.py:151-182) over [n, T, C] tokens and [n, N, C] image
rows, each candidate attending only to its own rows:

1. token self-attention (no PE and no residual on the first layer,
   ``skip_pe``), LN1;
2. token -> image attention, the image-side k/v projections (+ the k-side PE)
   computed from the rows inside, and the i2t query ``q_img`` of every row
   emitted beside it; out-projection, residual, LN2;
3. token ReLU MLP, residual, LN3;
4. image -> token attention (softmax over the T tokens of each head),
   out-projection, residual with the rows, LN4 -> the new rows.

With ``idx`` the rows are a candidate store [S, N, C] and candidate b reads
store row ``clip(idx[b], 0, S - 1)``; with ``scale`` the store is int8 and a
row dequantises as ``(int8 -> fp32) * scale[row]``, rounded to the compute
dtype, in stage 2 and again for the residual of stage 4.

Numerics, as in the TPU kernel: the token state stays fp32 inside the layer;
every operand of a product is rounded to the compute dtype first (the image
projections k_t, v_t, q_img; the attention queries after their scale, which
follows the bias; the unnormalised t2i exponentials; the i2t
probabilities); every sum and every statistic is fp32. The i2t softmax
shifts by the exact per-head max (the TPU kernel shifts by the per-head
mean, the same function).

On the card the layer is four launches (``two_way_layer.launches`` adds 4
per call): a token kernel (stage 1 and the t2i query), the image pass of
``t2i_flash.cu`` (stage 2's projections and per-tile flash partials), a
token kernel (the partials' combine, the rest of stage 2, stage 3, the i2t
keys and values), and an image kernel (stage 4). See the sources for what
bounds each. The kernels take the SAM geometry only: bf16, C = 256, 8
heads, internal width 128, 6 tokens, MLP 2048, N a multiple of 64. Any
other CUDA input raises; a CPU tensor takes the plain version. ``cor_tpu``'s
kernel has no backward, and neither has this one: with autograd recording
(an input or a weight that requires grad, grad mode on) it raises. Training
runs the decoder's ``fused=False`` path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cor_tpu_torch.ops.common import layer_norm
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, library

C_DIM, HEADS, INTERNAL, TOKENS, MLP_DIM = 256, 8, 128, 6, 2048
ROW_TILE = 64  # image rows per CTA of the image passes


def _lin(x: torch.Tensor, d) -> torch.Tensor:
    """fp32 x @ w.T + b of a ``Dense`` holder, with fp32 accumulation."""
    return x @ d.w.float().T + d.b.float()


def gather_rows(keys, idx, scale, dt) -> torch.Tensor:
    """The rows a layer reads: ``keys`` itself, or store rows
    ``keys[clip(idx)]``, dequantised by ``scale`` when the store is int8."""
    if idx is None:
        return keys.to(dt)
    rows_idx = idx.long().clamp(0, keys.shape[0] - 1)
    rows = keys[rows_idx]
    if scale is None:
        return rows.to(dt)
    return (rows.float() * scale.float()[rows_idx][:, None, None]).to(dt)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    n, t, c = x.shape
    return x.reshape(n, t, h, c // h).transpose(1, 2)  # [n, h, t, d]


def _merge(x: torch.Tensor) -> torch.Tensor:
    n, h, t, d = x.shape
    return x.transpose(1, 2).reshape(n, t, h * d)


def two_way_layer_plain(
    lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe: bool, eps: float = 1e-5,
    idx=None, scale=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (tokens', rows') in the tokens' dtype.

    ``lp`` is a ``TwoWayBlock``; ``kpe`` and ``qpe_img`` [N, I] are the
    bias-free projections of the image PE by t2i.k_proj and i2t.q_proj."""
    dt = tokens.dtype
    r = lambda x: x.to(dt).float()  # noqa: E731 -- round to the compute dtype
    rows = gather_rows(keys, idx, scale, dt)
    sa, t2i, i2t = lp.self_attn, lp.cross_attn_t2i, lp.cross_attn_i2t
    H = sa.num_heads
    C = tokens.shape[-1]
    I = t2i.q_proj.w.shape[0]
    x, qpe = tokens.float(), qpe_tok.float()

    # 1) token self-attention
    qin = r(x if skip_pe else x + qpe)
    q = r(_lin(qin, sa.q_proj) / math.sqrt(C // H))
    k = r(_lin(qin, sa.k_proj))
    v = r(_lin(r(x), sa.v_proj))
    p = torch.softmax(_heads(q, H) @ _heads(k, H).transpose(-1, -2), dim=-1)
    s = _lin(r(_merge(r(p) @ _heads(v, H))), sa.out_proj)
    x = s if skip_pe else x + s
    x = layer_norm(x, lp.norm1.scale, lp.norm1.bias, eps)

    # 2) token -> image attention; q_img for stage 4
    cross = 1.0 / math.sqrt(I // H)
    qt = r(_lin(r(x + qpe), t2i.q_proj) * cross)
    rf = rows.float()
    k_t = r(_lin(rf, t2i.k_proj) + kpe.float())
    v_t = r(_lin(rf, t2i.v_proj))
    q_img = r(_lin(rf, i2t.q_proj) + qpe_img.float())
    logits = _heads(qt, H) @ _heads(k_t, H).transpose(-1, -2)  # [n, H, T, N]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    av = (r(e) @ _heads(v_t, H)) / e.sum(dim=-1, keepdim=True)
    x = x + _lin(r(_merge(av)), t2i.out_proj)
    x = layer_norm(x, lp.norm2.scale, lp.norm2.bias, eps)

    # 3) token MLP (ReLU)
    h = torch.relu(_lin(r(x), lp.mlp.lin1))
    x = x + _lin(r(h), lp.mlp.lin2)
    x = layer_norm(x, lp.norm3.scale, lp.norm3.bias, eps)

    # 4) image -> token attention over the T tokens of each head
    k_i = r(_lin(r(x + qpe), i2t.k_proj))
    v_i = r(_lin(r(x), i2t.v_proj))
    l2 = _heads(r(q_img * cross), H) @ _heads(k_i, H).transpose(-1, -2)  # [n, H, N, T]
    a2 = r(torch.softmax(l2, dim=-1))
    o2 = _lin(r(_merge(a2 @ _heads(v_i, H))), i2t.out_proj)
    z = layer_norm(rf + o2, lp.norm4.scale, lp.norm4.bias, eps)
    return x.to(dt), z.to(dt)


def cached_pack(holder, attr: str, tensors, device, make):
    """``make()``, kept on ``holder`` as ``attr`` and made again only for
    another device, or when one of ``tensors`` is another tensor (the
    per-call copies of an eval under ``functional_call``): serving weights
    are packed once."""
    stamp = [id(t) for t in tensors]
    cache = getattr(holder, attr, None)
    if cache is None or cache[0] != device or cache[1] != stamp:
        # the tensors ride along so that their ids stay theirs while cached
        cache = (device, stamp, make(), tuple(tensors))
        setattr(holder, attr, cache)
    return cache[2]


def _pack(lp, device) -> dict:
    """The layer's weights in the kernels' layouts, bf16 matrices [out, in]
    and fp32 vectors (``cached_pack`` on the layer). Order and offsets are
    those of ``csrc/two_way_layer.cu``."""
    return cached_pack(lp, "_kernel_pack", list(lp.parameters()), device,
                       lambda: _make_pack(lp, device))


def _make_pack(lp, device) -> dict:
    sa, t2i, i2t, mlp = lp.self_attn, lp.cross_attn_t2i, lp.cross_attn_i2t, lp.mlp
    bf = lambda *ts: torch.cat([t.detach().reshape(-1).to(device, torch.bfloat16) for t in ts])  # noqa: E731
    f32 = lambda *ts: torch.cat([t.detach().reshape(-1).to(device, torch.float32) for t in ts])  # noqa: E731
    return {
        "wtok": bf(sa.q_proj.w, sa.k_proj.w, sa.v_proj.w, sa.out_proj.w, t2i.q_proj.w,
                   t2i.out_proj.w, mlp.lin1.w, mlp.lin2.w, i2t.k_proj.w, i2t.v_proj.w),
        "btok": f32(sa.q_proj.b, sa.k_proj.b, sa.v_proj.b, sa.out_proj.b,
                    lp.norm1.scale, lp.norm1.bias, t2i.q_proj.b, t2i.out_proj.b,
                    lp.norm2.scale, lp.norm2.bias, mlp.lin1.b, mlp.lin2.b,
                    lp.norm3.scale, lp.norm3.bias, i2t.k_proj.b, i2t.v_proj.b),
        "w_img": bf(t2i.k_proj.w, t2i.v_proj.w, i2t.q_proj.w).reshape(3 * INTERNAL, C_DIM),
        "b_img": f32(t2i.k_proj.b, t2i.v_proj.b, i2t.q_proj.b),
        "wo_i": bf(i2t.out_proj.w).reshape(C_DIM, INTERNAL),
        "bo_ln4": f32(i2t.out_proj.b, lp.norm4.scale, lp.norm4.bias),
    }


def _check_geometry(lp, tokens, qpe_tok, keys, kpe, qpe_img, idx, scale) -> None:
    sa, t2i = lp.self_attn, lp.cross_attn_t2i
    n, T, C = tokens.shape
    N = keys.shape[1]
    if (C, T, sa.num_heads, t2i.q_proj.w.shape[0], lp.mlp.lin1.w.shape[0]) != (
            C_DIM, TOKENS, HEADS, INTERNAL, MLP_DIM):
        raise ValueError(
            f"two_way_layer kernel takes the SAM geometry (C {C_DIM}, {TOKENS} tokens, "
            f"{HEADS} heads, internal {INTERNAL}, MLP {MLP_DIM}); got C {C}, {T} tokens, "
            f"{sa.num_heads} heads, internal {t2i.q_proj.w.shape[0]}, MLP {lp.mlp.lin1.w.shape[0]}")
    if tokens.dtype != torch.bfloat16 or qpe_tok.dtype != torch.bfloat16:
        raise TypeError(f"two_way_layer kernel takes bf16 tokens, got {tokens.dtype}")
    if keys.dim() != 3 or keys.shape[2] != C or N % ROW_TILE or N == 0:
        raise ValueError(f"two_way_layer kernel takes rows [*, N, {C}] with N % {ROW_TILE} == 0, "
                         f"got {tuple(keys.shape)}")
    if scale is not None:
        if keys.dtype != torch.int8 or idx is None or scale.dtype != torch.float32:
            raise TypeError("an int8 store takes idx and fp32 scales")
        if scale.shape != (keys.shape[0],):
            raise ValueError(f"scales {tuple(scale.shape)} for a store of {keys.shape[0]} rows")
    elif keys.dtype != torch.bfloat16:
        raise TypeError(f"two_way_layer kernel takes bf16 rows (or an int8 store), got {keys.dtype}")
    if idx is None and keys.shape[0] != n:
        raise ValueError(f"{keys.shape[0]} row blocks for {n} candidates")
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (n,)):
        raise ValueError(f"idx must be int32 [{n}], got {idx.dtype} {tuple(idx.shape)}")
    if kpe.shape != (N, INTERNAL) or qpe_img.shape != (N, INTERNAL) or \
            kpe.dtype != torch.bfloat16 or qpe_img.dtype != torch.bfloat16:
        raise ValueError("kpe and qpe_img must be bf16 [N, 128]")
    for name, t in (("tokens", tokens), ("qpe_tok", qpe_tok), ("keys", keys), ("kpe", kpe),
                    ("qpe_img", qpe_img), ("idx", idx), ("scale", scale)):
        if t is not None and (t.device != tokens.device or not t.is_contiguous()):
            raise ValueError(f"two_way_layer kernel: {name} must be contiguous on {tokens.device}")
    if n > 65535:
        raise ValueError(f"two_way_layer kernel: {n} candidates in one call (at most 65535)")


def two_way_layer(
    lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe: bool, eps: float = 1e-5,
    idx: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [n, T, C], qpe_tok [n, T, C], keys [n, N, C] (or a store
    [S, N, C] with ``idx`` int32 [n], int8 with ``scale`` fp32 [S]),
    kpe / qpe_img [N, I] -> (tokens' [n, T, C], rows' [n, N, C])."""
    if tokens.device.type == "cpu":
        refuse_grad("two_way_layer", tokens, qpe_tok, keys, kpe, qpe_img, *lp.parameters())
        return two_way_layer_plain(lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, eps,
                                   idx, scale)
    if tokens.device.type != "cuda":
        raise ValueError(f"two_way_layer: no kernel for device {tokens.device}")
    _check_geometry(lp, tokens, qpe_tok, keys, kpe, qpe_img, idx, scale)
    refuse_grad("two_way_layer", tokens, qpe_tok, keys, kpe, qpe_img, *lp.parameters())
    n = tokens.shape[0]
    S, N = keys.shape[0], keys.shape[1]
    dev = tokens.device
    pk = _pack(lp, dev)
    tiles = N // ROW_TILE
    f32 = dict(device=dev, dtype=torch.float32)
    bf = dict(device=dev, dtype=torch.bfloat16)
    x_mid = torch.empty((n, TOKENS, C_DIM), **f32)
    qt = torch.empty((n, TOKENS, INTERNAL), **bf)
    q_img = torch.empty((n, N, INTERNAL), **bf)
    part_m = torch.empty((n, tiles, HEADS * TOKENS), **f32)
    part_l = torch.empty((n, tiles, HEADS * TOKENS), **f32)
    part_acc = torch.empty((n, tiles, HEADS * TOKENS, INTERNAL // HEADS), **f32)
    tokens_out = torch.empty((n, TOKENS, C_DIM), **bf)
    k_i = torch.empty((n, TOKENS, INTERNAL), **bf)
    v_i = torch.empty((n, TOKENS, INTERNAL), **bf)
    keys_out = torch.empty((n, N, C_DIM), **bf)
    idx_p = 0 if idx is None else idx.data_ptr()
    scale_p = 0 if scale is None else scale.data_ptr()
    int8 = int(scale is not None)
    self_scale = 1.0 / math.sqrt(C_DIM // HEADS)
    cross_scale = 1.0 / math.sqrt(INTERNAL // HEADS)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.cor_twl_tokens_in(
            tokens.data_ptr(), qpe_tok.data_ptr(), pk["wtok"].data_ptr(), pk["btok"].data_ptr(),
            int(skip_pe), self_scale, cross_scale, eps, n,
            x_mid.data_ptr(), qt.data_ptr(), stream), "two_way_layer tokens_in")
        check(lib.cor_t2i_image_pass(
            keys.data_ptr(), int8, idx_p, scale_p, S, n, N,
            pk["w_img"].data_ptr(), pk["b_img"].data_ptr(), kpe.data_ptr(), qpe_img.data_ptr(),
            qt.data_ptr(), q_img.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), stream),
            "two_way_layer image t2i")
        check(lib.cor_twl_tokens_mid(
            x_mid.data_ptr(), qpe_tok.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), tiles, pk["wtok"].data_ptr(), pk["btok"].data_ptr(), eps, n,
            tokens_out.data_ptr(), k_i.data_ptr(), v_i.data_ptr(), stream),
            "two_way_layer tokens_mid")
        check(lib.cor_twl_image_i2t(
            keys.data_ptr(), int8, idx_p, scale_p, S, n, N, q_img.data_ptr(),
            k_i.data_ptr(), v_i.data_ptr(), pk["wo_i"].data_ptr(), pk["bo_ln4"].data_ptr(),
            eps, cross_scale, keys_out.data_ptr(), stream), "two_way_layer image i2t")
    two_way_layer.launches += LAUNCHES
    return tokens_out, keys_out


LAUNCHES = 4  # kernel launches per call on the card
two_way_layer.launches = 0
