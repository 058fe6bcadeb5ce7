"""Sequence self-attention off a fused QKV tensor: the CUDA kernel
``csrc/seq_attention.cu`` and its plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/seq_attention.py:attention_seq_qkv_pallas``
(the ``pallas_call`` in ``_qkv_pair_call``): softmax(q k^T / sqrt(D)) v for
every head, read straight from ``qkv`` [B, N, 3C] laid out (q | k | v) with
heads contiguous inside each third, written to [B, N, C] with the heads
merged. Logits and softmax in fp32; probabilities rounded to the compute
dtype before the product with v.

On the H100 the kernel is bound by bytes and by the rate of small (64 x 64)
matrix products; it reads q/k/v in place and keeps logits out of memory
(tensor-core mma.sync, online softmax). See the source for the design.

``attention_seq_qkv`` takes the plain version for a tensor on the CPU, and
the kernel for a CUDA tensor. The kernel takes bf16 with head_dim 64; any
other CUDA input raises (head_dim 72 of SO400M and 80 are not ported yet).
It never falls back from the kernel to the plain version. Where autograd
records the call, the kernel runs forward and the gradient is the plain
version's, recomputed in the backward (``ops.diff.with_plain_vjp``), as
``cor_tpu`` takes it from XLA.
"""

from __future__ import annotations

import torch

from cor_tpu_torch.ops.diff import needs_grad, with_plain_vjp
from cor_tpu_torch.ops.kernels._build import check, library

HEAD_DIM = 64  # the only head_dim the kernel takes


def attention_seq_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version (cor_tpu ``attention_seq_qkv_xla``)."""
    from cor_tpu_torch.ops.attention import attention_heads

    C = qkv.shape[-1] // 3
    return attention_heads(qkv[..., :C], qkv[..., C : 2 * C], qkv[..., 2 * C :], num_heads)


def attention_seq_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv [B, N, 3C] -> [B, N, C]."""
    if qkv.device.type == "cpu":
        return attention_seq_qkv_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_seq_qkv: no kernel for device {qkv.device}")
    if needs_grad(qkv):
        return _attention_seq_qkv_diff(qkv, num_heads)
    return _attention_seq_qkv_kernel(qkv, num_heads)


def _attention_seq_qkv_kernel(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"attention_seq_qkv takes qkv [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads != 0 or C // num_heads != HEAD_DIM:
        raise ValueError(
            f"attention_seq_qkv kernel takes head_dim {HEAD_DIM}; width {C} with "
            f"{num_heads} heads is not ported yet (ROADMAP: K4 for other head dims)"
        )
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"attention_seq_qkv kernel takes bf16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16 != 0:
        raise ValueError("attention_seq_qkv kernel takes a contiguous, 16-byte aligned qkv")
    if not (1 <= B <= 65535 and num_heads <= 65535):
        raise ValueError(f"attention_seq_qkv kernel: batch {B} / heads {num_heads} out of range")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    if N == 0:
        return out
    lib = library()
    with torch.cuda.device(qkv.device):
        err = lib.cor_seq_attention_qkv(
            qkv.data_ptr(), out.data_ptr(), B, N, C, num_heads,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "attention_seq_qkv")
    attention_seq_qkv.launches += 1
    return out


_attention_seq_qkv_diff = with_plain_vjp(_attention_seq_qkv_kernel, attention_seq_qkv_plain)
attention_seq_qkv.launches = 0
