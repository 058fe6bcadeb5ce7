"""SAM ViT attention with the decomposed relative-position bias, off a fused
QKV tensor: the CUDA kernels ``csrc/vit_attention.cu`` (K6, the forward) and
``csrc/vit_attention_bwd.cu`` (K6b, its backward), and their plain PyTorch
versions.

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

``vit_attention_relpos`` is a ``torch.autograd.Function``. Its backward
replaces ``cor_tpu/ops/pallas/vit_attention.py:_vit_attention_relpos_bwd``
(the ``pallas_call`` at line 459, K6's ``custom_vjp``), the standard
attention VJP with the bias factors' gradients read off ``dl``:

    a  = softmax(l),  da = do v^T,  dl = a * (da - rowsum(a * da))
    dq = bf16(dl) k * scale,  dk = bf16(dl)^T bf16(q * scale),  dv = bf16(a)^T do
    drel_h[i, r] = sum_{j // W == r} bf16(dl)[i, j],  drel_w likewise by j % W

with the TPU kernel's rounding points: logits, ``a``, ``da`` and ``dl`` in
fp32, ``a`` and ``dl`` rounded to the compute dtype before the products,
``dk``/``dv`` accumulated in fp32 and rounded once, ``drel`` summed in fp32
and returned in the factors' dtype. (The TPU kernel shifts its concatenated
keys by their column mean; ``rowsum(dl) = 0`` makes that shift vanish from
the gradient, so it is left out here.)

Both directions take the plain version for a tensor on the CPU and the
kernel for a CUDA tensor. The kernels take bf16 with head_dim 64 and
H, W <= 64; any other CUDA input raises (sam_huge's head_dim 80 is not ported
yet). They never fall back from a kernel to a plain version.
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


def vit_attention_relpos_bwd_plain(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dqkv [B, N, 3C] in qkv's dtype, drel_h, drel_w in
    the factors' dtypes) for the cotangent ``do`` [B, N, C] of the output."""
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // num_heads
    dt = qkv.dtype
    scale = D**-0.5
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, num_heads, D).transpose(1, 2).float()
               for i in range(3))  # [B, heads, N, D]
    qs = (q * scale).to(dt).float()
    logits = (qs @ k.transpose(-1, -2)).reshape(B, num_heads, N, H, W)
    logits = logits + rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    a = torch.softmax(logits.reshape(B, num_heads, N, N), dim=-1)
    dof = do.to(dt).reshape(B, N, num_heads, D).transpose(1, 2).float()
    da = dof @ v.transpose(-1, -2)
    dl = a * (da - (a * da).sum(dim=-1, keepdim=True))
    dlc, ac = dl.to(dt).float(), a.to(dt).float()
    merge = lambda x: x.to(dt).transpose(1, 2).reshape(B, N, C)  # noqa: E731
    dq = merge((dlc @ k) * scale)
    dk = merge(dlc.transpose(-1, -2) @ qs)
    dv = merge(ac.transpose(-1, -2) @ dof)
    dl5 = dlc.reshape(B, num_heads, N, H, W)
    return (torch.cat([dq, dk, dv], dim=-1), dl5.sum(dim=-1).to(rel_h.dtype),
            dl5.sum(dim=-2).to(rel_w.dtype))


def _check(qkv, rel_h, rel_w, num_heads, hw, what: str) -> None:
    """Raise on what the kernels do not take."""
    H, W = hw
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"{what} takes qkv [B, N, 3C], got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    C = C3 // 3
    if C % num_heads != 0 or C // num_heads != HEAD_DIM:
        raise ValueError(
            f"{what} kernel takes head_dim {HEAD_DIM}; width {C} with "
            f"{num_heads} heads is not ported yet (ROADMAP Queue 1, item 6: sam_huge)"
        )
    if N != H * W or not (1 <= H <= MAX_SIDE and 1 <= W <= MAX_SIDE):
        raise ValueError(
            f"{what} kernel takes N = H * W with H, W <= {MAX_SIDE}; got N={N}, "
            f"H={H}, W={W}"
        )
    for name, t, k in (("rel_h", rel_h, H), ("rel_w", rel_w, W)):
        if t.shape != (B, num_heads, N, k) or t.dtype != qkv.dtype or t.device != qkv.device:
            raise ValueError(
                f"{what} kernel: {name} must be [{B}, {num_heads}, {N}, {k}] "
                f"{qkv.dtype} on {qkv.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {qkv.dtype}")
    if not (qkv.is_contiguous() and rel_h.is_contiguous() and rel_w.is_contiguous()) or (
        qkv.data_ptr() % 16 != 0
    ):
        raise ValueError(f"{what} kernel takes contiguous inputs, qkv 16-byte aligned")
    if not (1 <= B <= 65535 and num_heads <= 65535):
        raise ValueError(f"{what} kernel: batch {B} / heads {num_heads} out of range")


def _forward(qkv, rel_h, rel_w, num_heads: int, hw: Tuple[int, int]) -> torch.Tensor:
    """K6 on a CUDA tensor, the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return vit_attention_relpos_plain(qkv, rel_h, rel_w, num_heads, hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention_relpos: no kernel for device {qkv.device}")
    _check(qkv, rel_h, rel_w, num_heads, hw, "vit_attention_relpos")
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
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


def vit_attention_relpos_bwd(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6b on a CUDA tensor, the plain backward on the CPU: (dqkv, drel_h,
    drel_w). One call is the kernel's two passes (dq and the factors'
    gradients, then dk and dv) and counts one launch."""
    if qkv.device.type == "cpu":
        return vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, num_heads, hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention_relpos_bwd: no kernel for device {qkv.device}")
    _check(qkv, rel_h, rel_w, num_heads, hw, "vit_attention_relpos_bwd")
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    do = do.to(qkv.dtype).contiguous()
    if do.shape != (B, N, C) or do.device != qkv.device:
        raise ValueError(f"vit_attention_relpos_bwd: do must be [{B}, {N}, {C}] on {qkv.device}, "
                         f"got {tuple(do.shape)} on {do.device}")
    dqkv = torch.empty_like(qkv)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    stats = torch.empty((2, B, num_heads, N), dtype=torch.float32, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        err = lib.cor_vit_attention_relpos_bwd(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), do.data_ptr(),
            dqkv.data_ptr(), drel_h.data_ptr(), drel_w.data_ptr(), stats.data_ptr(),
            B, N, C, num_heads, H, W, float(HEAD_DIM**-0.5),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "vit_attention_relpos_bwd")
    vit_attention_relpos_bwd.launches += 1
    return dqkv, drel_h, drel_w


class _VitAttentionRelpos(torch.autograd.Function):
    """K6 forward, K6b backward (the plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, num_heads, hw):
        ctx.num_heads, ctx.hw = num_heads, hw
        ctx.save_for_backward(qkv, rel_h, rel_w)
        return _forward(qkv, rel_h, rel_w, num_heads, hw)

    @staticmethod
    def backward(ctx, do):
        qkv, rel_h, rel_w = ctx.saved_tensors
        dqkv, drel_h, drel_w = vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, ctx.num_heads,
                                                        ctx.hw)
        return dqkv, drel_h, drel_w, None, None


def vit_attention_relpos(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """qkv [B, N, 3C], rel_h [B, heads, N, H], rel_w [B, heads, N, W] with
    N = H * W -> [B, N, C]; differentiable in all three."""
    return _VitAttentionRelpos.apply(qkv, rel_h, rel_w, num_heads, tuple(hw))


vit_attention_relpos.launches = 0
vit_attention_relpos_bwd.launches = 0
