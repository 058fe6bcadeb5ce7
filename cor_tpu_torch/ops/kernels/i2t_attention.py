"""The image -> token attention block tail of the SAM two-way transformer
(K8b): the CUDA kernel of ``csrc/twl_i2t.cu`` (K1's stage-4 image pass) and
its plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/i2t_attention.py:i2t_attention_fused`` (its
``pallas_call`` at line 105). Per candidate, each image row attends to the
T tokens of its head, and the block ends there:

    a    = softmax_over_tokens(q_img_h k_tok_h^T / sqrt(d))   (per head h)
    out  = LayerNorm(keys + (a v_tok) @ w_out^T + b_out)

with the image rows ``keys`` [N, C], their queries ``q_img`` [N, I] (K8a's
output), and the tokens' keys and values ``k_tok``, ``v_tok`` [T, I],
projected by the caller. The scaled queries, the probabilities and their
product with the values are rounded to the compute dtype before the next
product; the logits, the statistics and the residual are fp32. The softmax
shifts by the exact per-head max, where ``cor_tpu``'s kernel shifts by the
per-head mean: the same function.

``cor_tpu``'s fused decode runs it where its layer kernel (K1) does not,
above 8 tokens. On the card it is one launch (``launches`` adds 1 per call)
of K1's image pass redesigned for Hopper, which ends K1's layer
(``cor_twl_i2t``; above 8 tokens its wide instantiation: the tokens' keys
and values held once a CTA, the attention output written over the q_img
tile): persistent CTAs of two consumer warpgroups, the softmax on the CUDA
cores in the shared body's order (bf16 keeps its bits; in fp32 above 8
tokens an online softmax over the tokens 4 at a time), the out-projection
on ``wgmma`` from a ring fed by TMA bulk copies (the weight laid out as the
ring's blocks, K1's pack), the residual and the LayerNorm in its epilogue.
It takes C = 256, 8 heads, I =
128, T from 5 to 32 tokens and N a multiple of 64, in bf16 or fp32 (every
operand of one dtype; in fp32 the out-projection runs in 3xTF32 and
nothing is rounded); any other CUDA input raises, a CPU tensor takes the
plain version, and with autograd recording it raises (``cor_tpu``'s kernel
has no backward). Launches are counted by dtype (``launches``: bf16,
``launches_fp32``).
"""

from __future__ import annotations

import math

import torch

from cor_tpu_torch.ops.common import layer_norm
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype
from cor_tpu_torch.ops.kernels.t2i_flash import (
    C_DIM,
    HEADS,
    INTERNAL,
    MAX_TOKENS,
    MIN_TOKENS,
    ROW_TILE,
    cached_pack,
    ring_blocks,
)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    n, t, c = x.shape
    return x.reshape(n, t, h, c // h).transpose(1, 2)  # [n, h, t, d]


def i2t_attention_fused_plain(q_img, keys, k_tok, v_tok, w_out, b_out, ln_scale, ln_bias,
                              num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The plain PyTorch version: [n, N, C] in the keys' dtype. ``w_out`` is
    [C, I] (``Dense`` layout)."""
    dt = keys.dtype
    r = lambda x: x.to(dt).float()  # noqa: E731 -- round to the compute dtype
    n, N, I = q_img.shape
    scale = 1.0 / math.sqrt(I // num_heads)
    logits = _heads(r(q_img.float() * scale), num_heads) @ _heads(
        k_tok.float(), num_heads).transpose(-1, -2)  # [n, H, N, T]
    a = r(torch.softmax(logits, dim=-1))
    o = r((a @ _heads(v_tok.float(), num_heads)).transpose(1, 2).reshape(n, N, I))
    z = keys.float() + (o @ w_out.float().T + b_out.float())
    return layer_norm(z, ln_scale, ln_bias, eps).to(dt)


def i2t_attention_fused(q_img, keys, k_tok, v_tok, w_out, b_out, ln_scale, ln_bias,
                        num_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """q_img [n, N, I], keys [n, N, C], k_tok / v_tok [n, T, I] -> [n, N, C],
    ``cor_tpu``'s signature (``w_out`` in the port's [C, I] layout)."""
    args = (q_img, keys, k_tok, v_tok, w_out, b_out, ln_scale, ln_bias)
    if keys.device.type == "cpu":
        refuse_grad("i2t_attention_fused", *args)
        return i2t_attention_fused_plain(*args, num_heads, eps)
    if keys.device.type != "cuda":
        raise ValueError(f"i2t_attention_fused: no kernel for device {keys.device}")
    dt = _check(q_img, keys, k_tok, v_tok, w_out, num_heads)
    refuse_grad("i2t_attention_fused", *args)
    n, N, _ = keys.shape
    dev = keys.device
    wo, wo_blocks, bo_ln = cached_pack(
        w_out, "_i2t_pack", (w_out, b_out, ln_scale, ln_bias), dev, dt,
        lambda: _pack(w_out, b_out, ln_scale, ln_bias, dev, dt))
    out = torch.empty((n, N, C_DIM), device=dev, dtype=dt)
    with torch.cuda.device(dev):
        check(library().cor_twl_i2t(
            keys.data_ptr(), 0, 0, 0, n, n, k_tok.shape[1], N, q_img.data_ptr(),
            k_tok.data_ptr(), v_tok.data_ptr(), wo.data_ptr(),
            0 if wo_blocks is None else wo_blocks.data_ptr(), bo_ln.data_ptr(), eps,
            1.0 / math.sqrt(INTERNAL // HEADS), out.data_ptr(), int(dt == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream), "i2t_attention_fused")
    count_launch(i2t_attention_fused, dt)
    return out


def _pack(w_out, b_out, ln_scale, ln_bias, dev, dt):
    """(w_out [C, I] in the compute dtype, in bf16 laid out as the ring's
    blocks too (K1's ``wo_i_blocks``; fp32 splits the weight as it streams
    it), the fp32 [b_out | ln_scale | ln_bias])."""
    wo = w_out.detach().to(dev, dt).contiguous()
    return (wo, ring_blocks(wo, I2T_BLOCK) if dt == torch.bfloat16 else None,
            torch.cat([b_out.detach(), ln_scale.detach(), ln_bias.detach()]).to(
                dev, torch.float32))


def _check(q_img, keys, k_tok, v_tok, w_out, num_heads: int) -> torch.dtype:
    """The compute dtype (bf16 or fp32) of the operands, or raise on what
    the kernel does not take."""
    n, N, C = keys.shape
    T = k_tok.shape[1]
    if (C, num_heads, tuple(w_out.shape)) != (C_DIM, HEADS, (C_DIM, INTERNAL)):
        raise ValueError(
            f"i2t_attention_fused kernel takes C {C_DIM}, {HEADS} heads, w_out [{C_DIM}, "
            f"{INTERNAL}]; got keys {tuple(keys.shape)}, {num_heads} heads, w_out "
            f"{tuple(w_out.shape)}")
    if not MIN_TOKENS <= T <= MAX_TOKENS:
        raise ValueError(f"i2t_attention_fused kernel takes {MIN_TOKENS} to {MAX_TOKENS} "
                         f"tokens, got {T}")
    if (N == 0 or N % ROW_TILE or q_img.shape != (n, N, INTERNAL)
            or k_tok.shape != (n, T, INTERNAL) or v_tok.shape != k_tok.shape):
        raise ValueError(
            f"i2t_attention_fused kernel takes keys [n, N, {C_DIM}] with N % {ROW_TILE} == 0, "
            f"q_img [n, N, {INTERNAL}], k_tok and v_tok [n, T, {INTERNAL}]; got "
            f"{tuple(keys.shape)}, {tuple(q_img.shape)}, {tuple(k_tok.shape)}, "
            f"{tuple(v_tok.shape)}")
    dt = operand_dtype("i2t_attention_fused", q_img, keys, k_tok, v_tok)
    if not all(t.is_contiguous() for t in (q_img, keys, k_tok, v_tok)) or n > 65535:
        raise ValueError("i2t_attention_fused kernel takes contiguous operands, n <= 65535")
    return dt


I2T_BLOCK = 32  # the inputs of a ring block of the pass (csrc/twl_i2t.cu, bf16 kKB)
_LAYER_TOKENS = 8  # K1's instantiation takes up to 8 tokens, the wide one 9 to 32


def i2t_smem(dtype: torch.dtype, T: int) -> int:
    """The pass's dynamic shared memory at T tokens, as csrc/twl_i2t.cu lays
    it out (``I2tSmem<T, kWide>``): the ring; per consumer warpgroup its
    q_img tile, in bf16 its rows tile, and up to 8 tokens its attention output
    and the tokens' keys and values [8][I] fp32; above 8 the attention output
    over the q_img tile (bf16 [64][128] in the core-matrix layout) and one
    copy of the tokens' keys and values [32][I] fp32 a CTA; the bias and
    LN4 vectors, the mbarriers."""
    bf16 = dtype == torch.bfloat16
    wide = T > _LAYER_TOKENS
    stages, stage = (4, C_DIM * I2T_BLOCK * 2) if bf16 else (2, C_DIM * 16 * 8)
    ld_q = INTERNAL + (8 if bf16 else 4)
    q_tile = ROW_TILE * (INTERNAL * 2 if bf16 and wide else ld_q * (2 if bf16 else 4))
    rows_tile = ROW_TILE * (C_DIM + 8) * 2 if bf16 else 0  # fp32 reads device memory
    av = 0 if wide else (ROW_TILE * INTERNAL * 2 if bf16 else ROW_TILE * (INTERNAL + 4) * 4)
    tok = 2 * (MAX_TOKENS if wide else _LAYER_TOKENS) * INTERNAL * 4
    group = q_tile + rows_tile + av + (0 if wide else tok)
    return (stages * stage + 2 * group + (tok if wide else 0) + 3 * C_DIM * 4
            + (2 * stages + 8) * 8)


i2t_attention_fused.launches = i2t_attention_fused.launches_fp32 = 0
