"""Sequence self-attention: the CUDA kernel ``csrc/seq_attention.cu`` and its
plain PyTorch versions, through two entries.

- ``attention_seq_qkv`` replaces
  ``cor_tpu/ops/pallas/seq_attention.py:attention_seq_qkv_pallas`` (the
  ``pallas_call`` in ``_qkv_pair_call``): softmax(q k^T / sqrt(D)) v for
  every head, read straight from ``qkv`` [B, N, 3C] laid out (q | k | v)
  with heads contiguous inside each third, written to [B, N, C] with the
  heads merged. The SigLIP towers call it at every head_dim.
- ``attention_seq`` replaces ``attention_seq_pallas`` (the ``pallas_call``
  in ``_attention_padded``, K4′): the same over q, k, v [B, H, N, D] ->
  [B, H, N, D], ``cor_tpu``'s route for head dims that do not tile the TPU's
  128 lanes (ViT-SO400M-14-SigLIP-384: 72). Here both entries launch one
  kernel with the operands' strides; ``cor_tpu`` transposes the fused QKV
  for its K4′, the port's towers do not.

Logits and softmax in fp32; probabilities rounded to the compute dtype before
the product with v; the scale is 1/sqrt(D) of the true D.

On the H100 both instantiations read q/k/v in place and keep the logits out
of memory (online softmax over 64-key tiles) on Hopper's warpgroup products
(``wgmma``), two consumer warpgroups of 64 query rows sharing each K/V tile
that a producer stages: in bf16 (bound by moving the tiles from L2 to shared
memory) through a cp.async ring; in fp32 (bound by operations, three TF32
products per fp32 one) the producer splits each tile once into its TF32
halves, V transposed, for the 3xTF32 products. See the source for the design.

Each entry takes its plain version for a tensor on the CPU, and the kernel
for a CUDA tensor. The kernel takes bf16 or fp32 (the compute dtype; every
operand of one dtype) with head_dim 64 (ViT-B and ViT-L), 72 (SO400M) or 80;
any other CUDA input raises, naming the ROADMAP item for another head_dim.
In fp32 its products run in 3xTF32 on the tensor cores (fp32 accuracy) and
nothing is rounded. It never falls back from the kernel to the plain
version. Launches are counted by dtype: ``launches`` (bf16) and
``launches_fp32`` on each entry. Where autograd
records the call, the kernel runs forward and the gradient is the plain
version's, recomputed in the backward (``ops.diff.with_plain_vjp``), as
``cor_tpu`` takes it from XLA.
"""

from __future__ import annotations

import torch

from cor_tpu_torch.ops.diff import needs_grad, with_plain_vjp
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype

HEAD_DIMS = (64, 72, 80)  # the head dims the kernel takes
OTHER_HEAD_DIMS_ITEM = "ROADMAP Queue 2, K4′: head dims other than 64, 72 and 80"


def attention_seq_qkv_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version (cor_tpu ``attention_seq_qkv_xla``)."""
    from cor_tpu_torch.ops.attention import attention_heads

    C = qkv.shape[-1] // 3
    return attention_heads(qkv[..., :C], qkv[..., C : 2 * C], qkv[..., 2 * C :], num_heads)


def attention_seq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """The plain PyTorch version of K4′ (cor_tpu ``_kernel`` of
    ``attention_seq_pallas``): [B, H, N, D] operands -> [B, H, N, D]."""
    D = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (1.0 / D**0.5)
    a = torch.softmax(logits, dim=-1).to(q.dtype).float()
    return torch.einsum("bhqk,bhkd->bhqd", a, v.float()).to(q.dtype)


def attention_seq_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """qkv [B, N, 3C] -> [B, N, C]."""
    if qkv.device.type == "cpu":
        return attention_seq_qkv_plain(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_seq_qkv: no kernel for device {qkv.device}")
    if needs_grad(qkv):
        return _attention_seq_qkv_diff(qkv, num_heads)
    return _attention_seq_qkv_kernel(qkv, num_heads)


def attention_seq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int
) -> torch.Tensor:
    """q, k, v [B, H, N, D] with H = num_heads -> [B, H, N, D]."""
    if q.device.type == "cpu":
        return attention_seq_plain(q, k, v, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"attention_seq: no kernel for device {q.device}")
    if needs_grad(q, k, v):
        return _attention_seq_diff(q, k, v, num_heads)
    return _attention_seq_kernel(q, k, v, num_heads)


def _check_head_dim(what: str, width: int, num_heads: int) -> int:
    if num_heads < 1 or width % num_heads != 0 or width // num_heads not in HEAD_DIMS:
        raise ValueError(
            f"{what} kernel takes head_dim {', '.join(map(str, HEAD_DIMS))}; width {width} "
            f"with {num_heads} heads is not ported ({OTHER_HEAD_DIMS_ITEM})"
        )
    return width // num_heads


def _check_operands(what: str, *ts: torch.Tensor) -> torch.dtype:
    """The operands' one compute dtype (bf16 or fp32); raises on another
    dtype, a mix, or a non-contiguous or unaligned operand."""
    dt = operand_dtype(what, *ts)
    for x in ts:
        if not x.is_contiguous() or x.data_ptr() % 16 != 0:
            raise ValueError(f"{what} kernel takes contiguous, 16-byte aligned operands")
    return dt


def _launch(what: str, q, k, v, out, B, H, N, D, in_strides, out_strides, device,
            dt: torch.dtype) -> None:
    if not (1 <= B <= 65535 and H <= 65535):
        raise ValueError(f"{what} kernel: batch {B} / heads {H} out of range")
    lib = library()
    with torch.cuda.device(device):
        err = lib.cor_seq_attention(
            q, k, v, out, B, H, N, D, *in_strides, *out_strides, int(dt == torch.float32),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check(err, what)


def _attention_seq_qkv_kernel(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"attention_seq_qkv takes qkv [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = _check_head_dim("attention_seq_qkv", C, num_heads)
    dt = _check_operands("attention_seq_qkv", qkv)
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    if N == 0:
        return out
    base, size = qkv.data_ptr(), qkv.element_size()
    _launch("attention_seq_qkv", base, base + C * size, base + 2 * C * size, out.data_ptr(),
            B, num_heads, N, D, (N * C3, D, C3), (N * C, D, C), qkv.device, dt)
    count_launch(attention_seq_qkv, dt)
    return out


def _attention_seq_kernel(q, k, v, num_heads: int) -> torch.Tensor:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape or q.shape[1] != num_heads:
        raise ValueError(
            f"attention_seq takes q, k, v [B, {num_heads}, N, D] of one shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, N, D = q.shape
    _check_head_dim("attention_seq", H * D, H)
    dt = _check_operands("attention_seq", q, k, v)
    if not (k.device == v.device == q.device):
        raise ValueError("attention_seq: q, k and v must be on one device")
    out = torch.empty_like(q)
    if N == 0:
        return out
    strides = (H * N * D, N * D, D)
    _launch("attention_seq", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N,
            D, strides, strides, q.device, dt)
    count_launch(attention_seq, dt)
    return out


_attention_seq_qkv_diff = with_plain_vjp(_attention_seq_qkv_kernel, attention_seq_qkv_plain)
_attention_seq_diff = with_plain_vjp(_attention_seq_kernel, attention_seq_plain)
attention_seq_qkv.launches = attention_seq_qkv.launches_fp32 = 0
attention_seq.launches = attention_seq.launches_fp32 = 0
