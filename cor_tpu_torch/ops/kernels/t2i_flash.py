"""The final token -> image attention of the SAM two-way transformer: the CUDA
kernels of ``csrc/t2i_flash.cu`` and their plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/t2i_flash.py:t2i_flash_kv`` (its
``pallas_call`` at line 220). Per candidate, with the image rows ``keys``
[N, C] and the projected token queries ``q_tok`` [T, I]:

    k = bf16(keys @ wk + bk + kpe),  v = bf16(keys @ wv + bv)
    out[t, head h] = softmax_over_rows(q_h[t] k_h^T / sqrt(d)) v_h

for every head of width d = I / heads, without k or v reaching device
memory. The queries are scaled and rounded to the compute dtype first, the
exponentials are rounded before their product with v, and the division by
the fp32 row sum comes last, as in the TPU kernel.

On the card this is two launches (``t2i_flash_kv.launches`` adds 2 per
call): the image pass (one CTA per 64-row tile of a candidate: projections
on the tensor cores, then the tile's flash partials: max, sum and the
unnormalised [heads x T, d] product) and a combine over the tiles. The
image pass is shared with stage 2 of the two-way layer kernel. The kernels
take bf16 with C = 256, 8 heads, I = 128, 6 tokens and N a multiple of 64;
any other CUDA input raises, and a CPU tensor takes the plain version. With
autograd recording it raises: ``cor_tpu``'s kernel has no backward either.
"""

from __future__ import annotations

import math

import torch

from cor_tpu_torch.ops.kernels._build import check, library
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels.two_way_layer import (
    C_DIM,
    HEADS,
    INTERNAL,
    ROW_TILE,
    TOKENS,
    cached_pack,
)


def t2i_flash_kv_plain(keys, wk, bk, wv, bv, kpe, q_tok, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: [n, T, I] in the keys' dtype. ``wk``/``wv``
    are [I, C] (``Dense`` layout), ``kpe`` [N, I], ``q_tok`` [n, T, I]."""
    dt = keys.dtype
    r = lambda x: x.to(dt).float()  # noqa: E731 -- round to the compute dtype
    n, T, I = q_tok.shape
    d = I // num_heads
    kf = keys.float()
    k = r(kf @ wk.float().T + bk.float() + kpe.float())
    v = r(kf @ wv.float().T + bv.float())
    qh = r(q_tok.float() / math.sqrt(d)).reshape(n, T, num_heads, d).transpose(1, 2)
    kh = k.reshape(n, -1, num_heads, d).transpose(1, 2)
    vh = v.reshape(n, -1, num_heads, d).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2)  # [n, H, T, N]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (r(e) @ vh) / e.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).reshape(n, T, I).to(dt)


def t2i_flash_kv(keys, wk, bk, wv, bv, kpe, q_tok, num_heads: int) -> torch.Tensor:
    """keys [n, N, C], q_tok [n, T, I] -> [n, T, I]."""
    if keys.device.type == "cpu":
        refuse_grad("t2i_flash_kv", keys, wk, bk, wv, bv, kpe, q_tok)
        return t2i_flash_kv_plain(keys, wk, bk, wv, bv, kpe, q_tok, num_heads)
    if keys.device.type != "cuda":
        raise ValueError(f"t2i_flash_kv: no kernel for device {keys.device}")
    n, N, C = keys.shape
    if (C, num_heads, tuple(q_tok.shape[1:]), tuple(wk.shape), tuple(wv.shape)) != (
            C_DIM, HEADS, (TOKENS, INTERNAL), (INTERNAL, C_DIM), (INTERNAL, C_DIM)):
        raise ValueError(
            f"t2i_flash_kv kernel takes C {C_DIM}, {HEADS} heads, q_tok [n, {TOKENS}, "
            f"{INTERNAL}]; got keys {tuple(keys.shape)}, {num_heads} heads, q_tok "
            f"{tuple(q_tok.shape)}")
    if N == 0 or N % ROW_TILE or kpe.shape != (N, INTERNAL) or q_tok.shape[0] != n:
        raise ValueError(f"t2i_flash_kv kernel: N {N} must be a multiple of {ROW_TILE}, "
                         f"kpe [N, {INTERNAL}], q_tok [{n}, ...]")
    if keys.dtype != torch.bfloat16 or q_tok.dtype != torch.bfloat16 or kpe.dtype != torch.bfloat16:
        raise TypeError(f"t2i_flash_kv kernel takes bf16, got {keys.dtype}")
    if not keys.is_contiguous() or not kpe.is_contiguous() or n > 65535:
        raise ValueError("t2i_flash_kv kernel takes contiguous keys and kpe, n <= 65535")
    refuse_grad("t2i_flash_kv", keys, wk, bk, wv, bv, kpe, q_tok)
    dev = keys.device
    w_kv, b_kv = cached_pack(wk, "_t2i_pack", (wk, bk, wv, bv), dev, lambda: (
        torch.cat([wk.detach(), wv.detach()]).to(dev, torch.bfloat16).contiguous(),
        torch.cat([bk.detach(), bv.detach()]).to(dev, torch.float32).contiguous()))
    qt = (q_tok.float() / math.sqrt(INTERNAL // HEADS)).to(torch.bfloat16).contiguous()
    tiles = N // ROW_TILE
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty((n, tiles, HEADS * TOKENS), **f32)
    part_l = torch.empty((n, tiles, HEADS * TOKENS), **f32)
    part_acc = torch.empty((n, tiles, HEADS * TOKENS, INTERNAL // HEADS), **f32)
    out = torch.empty((n, TOKENS, INTERNAL), device=dev, dtype=torch.bfloat16)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.cor_t2i_image_pass(
            keys.data_ptr(), 0, 0, 0, n, n, N, w_kv.data_ptr(), b_kv.data_ptr(),
            kpe.data_ptr(), 0, qt.data_ptr(), 0,
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), stream),
            "t2i_flash_kv image pass")
        check(lib.cor_t2i_combine(
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), tiles, n,
            out.data_ptr(), stream), "t2i_flash_kv combine")
    t2i_flash_kv.launches += LAUNCHES
    return out


LAUNCHES = 2  # kernel launches per call on the card
t2i_flash_kv.launches = 0
