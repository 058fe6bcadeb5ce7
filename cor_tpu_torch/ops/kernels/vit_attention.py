"""SAM ViT attention with the decomposed relative-position bias, off a fused
QKV tensor: the CUDA kernel ``csrc/vit_attention.cu`` (K6) and its plain
PyTorch version.

Replaces ``cor_tpu/ops/pallas/vit_attention.py:vit_attention_relpos_pallas``
(the ``pallas_call`` in ``_vit_attention_relpos_pallas_impl``). Over the
N = H * W tokens of a grid, for every head:

    l[i, j] = bf16(q_i * scale) . k_j + rel_h[i, j // W] + rel_w[i, j % W]
    out_i   = sum_j exp(l[i, j] - m_i) v_j / sum_j exp(l[i, j] - m_i)

read from ``qkv`` [B, N, 3C] laid out (q | k | v) with heads contiguous
inside each third, the bias factors ``rel_h`` [B, heads, N, H] and ``rel_w``
[B, heads, N, W] in the compute dtype, and written to [B, N, C] with the
heads merged. Rounding points of the TPU kernel: q * scale rounded to the
compute dtype, logits and exp in fp32, the unnormalised probabilities
rounded to the compute dtype before the product with v, the division by the
fp32 row sum after it. The TPU kernel shifts each logit row by the mean of
its concatenated keys; here the shift is the row max (the same function).

On the H100 a global block (N = 4096) is bound by operations and a 14 x 14
window (N = 196) by bytes; see the source for the design.

``vit_attention_relpos`` takes the plain version for a tensor on the CPU,
and the kernel for a CUDA tensor. The kernel takes bf16 with head_dim 64 and
H, W <= 64; any other CUDA input raises (sam_huge's head_dim 80 is not ported
yet). It never falls back from the kernel to the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cor_tpu_torch.ops.kernels._build import check, library

HEAD_DIM = 64  # the only head_dim the kernel takes
MAX_SIDE = 64  # H, W <= 64: the tile's bias rows are staged in shared memory


def vit_attention_relpos_plain(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """The plain PyTorch version, with materialised fp32 logits."""
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    dt = qkv.dtype
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, num_heads, D) for i in range(3))
    qs = (q.float() * D**-0.5).to(dt).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qs, k.float()).reshape(B, num_heads, N, H, W)
    logits = logits + rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    logits = logits.reshape(B, num_heads, N, N)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    s = e.sum(dim=-1)  # [B, heads, N]
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(dt).float(), v.float())
    return (out / s.transpose(1, 2)[..., None]).to(dt).reshape(B, N, C)


def vit_attention_relpos(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """qkv [B, N, 3C], rel_h [B, heads, N, H], rel_w [B, heads, N, W] with
    N = H * W -> [B, N, C]."""
    if qkv.device.type == "cpu":
        return vit_attention_relpos_plain(qkv, rel_h, rel_w, num_heads, hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention_relpos: no kernel for device {qkv.device}")
    H, W = hw
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"vit_attention_relpos takes qkv [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads != 0 or C // num_heads != HEAD_DIM:
        raise ValueError(
            f"vit_attention_relpos kernel takes head_dim {HEAD_DIM}; width {C} with "
            f"{num_heads} heads is not ported yet (ROADMAP Queue 1, item 6: sam_huge)"
        )
    if N != H * W or not (1 <= H <= MAX_SIDE and 1 <= W <= MAX_SIDE):
        raise ValueError(
            f"vit_attention_relpos kernel takes N = H * W with H, W <= {MAX_SIDE}; got N={N}, "
            f"H={H}, W={W}"
        )
    for name, t, k in (("rel_h", rel_h, H), ("rel_w", rel_w, W)):
        if t.shape != (B, num_heads, N, k) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(
                f"vit_attention_relpos kernel: {name} must be [{B}, {num_heads}, {N}, {k}] "
                f"{qkv.dtype} on {qkv.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"vit_attention_relpos kernel takes bf16, got {qkv.dtype}")
    if not (qkv.is_contiguous() and rel_h.is_contiguous() and rel_w.is_contiguous()) or (
        qkv.data_ptr() % 16 != 0
    ):
        raise ValueError("vit_attention_relpos kernel takes contiguous inputs, qkv 16-byte aligned")
    if not (1 <= B <= 65535 and num_heads <= 65535):
        raise ValueError(f"vit_attention_relpos kernel: batch {B} / heads {num_heads} out of range")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        err = lib.cor_vit_attention_relpos(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
            B, N, C, num_heads, H, W, float(HEAD_DIM**-0.5),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "vit_attention_relpos")
    vit_attention_relpos.launches += 1
    return out


vit_attention_relpos.launches = 0
