"""SAM ViT attention with the decomposed relative-position bias, off a fused
QKV tensor: the CUDA kernels ``csrc/vit_attention.cu`` (K6, the forward, and
K7, the same function over the windows of a padded grid) and
``csrc/vit_attention_bwd.cu`` (K6b, K6's backward), and their plain PyTorch
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
the gradient, so it is left out here.) The kernel takes the forward's
statistics, as SDPA's and FlashAttention's backwards do, in bf16 and fp32
alike: each row's log-sum-exp of the logits, which K6 writes beside its
output when autograd records it (``lse`` [B, heads, N] fp32), and
``rowsum(a * da)`` computed as ``rowsum(do * out)`` in fp32 over the
forward's ``out``. In bf16 that departs from ``cor_tpu``'s exact sum by the
rounding of ``out`` (a known difference, ROADMAP Queue 3); in fp32 the dq
pass corrects both statistics from its own sums (see the source). The plain
version keeps the exact sum and takes ``out`` and ``lse`` without reading
them.

``vit_attention_relpos_windows`` replaces
``cor_tpu/ops/pallas/vit_attention.py:vit_attention_relpos_windows_pallas``
(K7, the ``pallas_call`` at line 180; the SAM encoder's opt-in
``fused_window_indexing``): K6's function in every ``window`` x ``window``
window of a grid zero-padded to multiples of the window, read off the fused
QKV of the whole padded grid [B, Hp, Wp, 3C] with the factors [B, heads,
Hp * Wp, window] of every grid token, and written to the grid cropped to
``hw``. The pad tokens are keys of their window (their k and v are the qkv
bias), as in ``window_partition``. Like ``cor_tpu``'s K7 it has no backward
kernel: its gradient is the VJP of its plain version, recomputed in the
backward (``ops.diff.with_plain_vjp``; ``cor_tpu``'s ``with_oracle_vjp``).

Each takes the plain version for a tensor on the CPU and its kernel for a
CUDA tensor: head_dim 64 (SAM-base and SAM-large) or 80 (sam_huge), H, W
(K7: the window) <= 64. K6, K6b and K7 take bf16 or fp32 (qkv, the factors
and K6b's cotangent of one dtype; in fp32 the products run in 3xTF32 on the
tensor cores and nothing is rounded). Any other CUDA input raises, naming
the ROADMAP item that ports it (fp16: @fp16). They never fall back from a
kernel to a plain version. Launches are counted by dtype: ``launches``
(bf16) and ``launches_fp32`` on each entry.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cor_tpu_torch.ops.diff import with_plain_vjp
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype

MAX_SIDE = 64  # H, W <= 64: the tile's bias rows are staged in shared memory
MAX_BWD_WIDTH = 4096  # K6b: C <= 4096 (delta sums C / 8 or C / 4 partials in shared memory)
# the head dims K6, K6b and K7 take, and the ROADMAP row that ports others
HEAD_DIMS = (64, 80)
OTHER_DIMS_ITEM = "ROADMAP Queue 2, K4′ / K6 / K7: head dims other than 64 and 80"


def vit_attention_relpos_plain(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
    with_lse: bool = False,
):
    """The plain PyTorch version, with materialised fp32 logits; with
    ``with_lse``, (out, the rows' log-sum-exp of the logits [B, heads, N]
    fp32)."""
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
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    s = e.sum(dim=-1)  # [B, heads, N]
    out = torch.einsum("bhqk,bkhd->bqhd", e.to(dt).float(), v.float())
    out = (out / s.transpose(1, 2)[..., None]).to(dt).reshape(B, N, C)
    return (out, m[..., 0] + torch.log(s)) if with_lse else out


def vit_attention_relpos_bwd_plain(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward: (dqkv [B, N, 3C] in qkv's dtype, drel_h, drel_w in
    the factors' dtypes) for the cotangent ``do`` [B, N, C] of the output,
    with ``cor_tpu``'s exact ``rowsum(a * da)``; the forward's ``out`` and
    ``lse`` are taken and not read."""
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


def _check_head_dim(qkv, num_heads, what: str) -> int:
    """The head_dim, or raise if the kernel ``what`` does not take it."""
    if qkv.dim() != 3 or qkv.shape[-1] % 3 != 0:
        raise ValueError(f"{what} takes qkv [B, N, 3C], got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if num_heads < 1 or C % num_heads != 0 or C // num_heads not in HEAD_DIMS:
        raise ValueError(
            f"{what} kernel takes head_dim {' or '.join(map(str, HEAD_DIMS))}; width {C} "
            f"with {num_heads} heads is not ported yet ({OTHER_DIMS_ITEM})"
        )
    return C // num_heads


def _check(qkv, rel_h, rel_w, num_heads, hw, what: str, sides=None) -> Tuple[int, torch.dtype]:
    """(head_dim, compute dtype), or raise on what the kernel ``what`` does
    not take: qkv [B, N, 3C] with N = H * W, the factors [B, heads, N, side]
    with ``sides`` (default ``hw``) <= 64, all three bf16 or all fp32."""
    H, W = hw
    kh, kw = sides or hw
    D = _check_head_dim(qkv, num_heads, what)
    B, N, C3 = qkv.shape
    if N != H * W or not (1 <= kh <= MAX_SIDE and 1 <= kw <= MAX_SIDE):
        raise ValueError(
            f"{what} kernel takes N = H * W with bias sides <= {MAX_SIDE}; got N={N}, "
            f"H={H}, W={W}, sides {kh}, {kw}"
        )
    dt = operand_dtype(what, qkv, rel_h, rel_w)
    for name, t, k in (("rel_h", rel_h, kh), ("rel_w", rel_w, kw)):
        if t.shape != (B, num_heads, N, k) or t.device != qkv.device:
            raise ValueError(
                f"{what} kernel: {name} must be [{B}, {num_heads}, {N}, {k}] "
                f"on {qkv.device}, got {tuple(t.shape)} on {t.device}"
            )
    if not (qkv.is_contiguous() and rel_h.is_contiguous() and rel_w.is_contiguous()) or (
        qkv.data_ptr() % 16 != 0
    ):
        raise ValueError(f"{what} kernel takes contiguous inputs, qkv 16-byte aligned")
    if not (1 <= B <= 65535 and num_heads <= 65535):
        raise ValueError(f"{what} kernel: batch {B} / heads {num_heads} out of range")
    return D, dt


def _forward(qkv, rel_h, rel_w, num_heads: int, hw: Tuple[int, int], with_lse: bool = False):
    """(out, lse): K6 on a CUDA tensor, the plain version on the CPU. lse,
    the rows' log-sum-exp [B, heads, N] fp32 that K6b reads, with
    ``with_lse``; else None."""
    if qkv.device.type == "cpu":
        if with_lse:
            return vit_attention_relpos_plain(qkv, rel_h, rel_w, num_heads, hw, with_lse=True)
        return vit_attention_relpos_plain(qkv, rel_h, rel_w, num_heads, hw), None
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention_relpos: no kernel for device {qkv.device}")
    D, dt = _check(qkv, rel_h, rel_w, num_heads, hw, "vit_attention_relpos")
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lse = None
    if with_lse:
        lse = torch.empty((B, num_heads, N), dtype=torch.float32, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        err = lib.cor_vit_attention_relpos(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, N, C, num_heads, H, W, float(D**-0.5),
            int(dt == torch.float32), torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "vit_attention_relpos")
    count_launch(vit_attention_relpos, dt)
    return out, lse


def vit_attention_relpos_with_lse(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K6 as autograd's forward runs it: (out, lse), the statistics
    ``vit_attention_relpos_bwd`` takes. One launch of
    ``vit_attention_relpos``; no autograd."""
    return _forward(qkv, rel_h, rel_w, num_heads, tuple(hw), with_lse=True)


def vit_attention_relpos_bwd(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    do: torch.Tensor,
    num_heads: int,
    hw: Tuple[int, int],
    out: Optional[torch.Tensor] = None,
    lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6b on a CUDA tensor, the plain backward on the CPU: (dqkv, drel_h,
    drel_w). ``out`` and ``lse``: the forward's output and its rows'
    log-sum-exp (``vit_attention_relpos_with_lse``), which the kernel needs
    and raises without; the plain version does not read them. One call is
    the kernel's three passes (delta, and in bf16 bf16(q * scale); dq and the
    factors' gradients; dk and dv) and counts one launch."""
    if qkv.device.type == "cpu":
        return vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, num_heads, hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention_relpos_bwd: no kernel for device {qkv.device}")
    D, dt = _check(qkv, rel_h, rel_w, num_heads, hw, "vit_attention_relpos_bwd")
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    do = do.to(qkv.dtype).contiguous()
    if do.shape != (B, N, C) or do.device != qkv.device:
        raise ValueError(f"vit_attention_relpos_bwd: do must be [{B}, {N}, {C}] on {qkv.device}, "
                         f"got {tuple(do.shape)} on {do.device}")
    rows = B * num_heads * N
    if out is None or lse is None:
        raise ValueError("vit_attention_relpos_bwd: the kernel takes the forward's out and lse "
                         "(vit_attention_relpos_with_lse)")
    if (out.shape != (B, N, C) or out.dtype != dt or not out.is_contiguous()
            or out.data_ptr() % 16 != 0 or lse.shape != (B, num_heads, N)
            or lse.dtype != torch.float32 or not lse.is_contiguous()
            or out.device != qkv.device or lse.device != qkv.device):
        raise ValueError(
            f"vit_attention_relpos_bwd: out must be a contiguous [{B}, {N}, {C}] {dt} and "
            f"lse a contiguous [{B}, {num_heads}, {N}] fp32 on {qkv.device}")
    if C > MAX_BWD_WIDTH:
        raise ValueError(f"vit_attention_relpos_bwd kernel takes widths up to "
                         f"{MAX_BWD_WIDTH}, got {C}")
    if dt == torch.bfloat16:
        # delta, then bf16(q * scale) 16-byte aligned (csrc: k6b::qs_offset_floats)
        stats = torch.empty(-(-rows // 4) * 4 + -(-B * N * C // 2), dtype=torch.float32,
                            device=qkv.device)
    else:
        # delta and the dq pass's corrected lse (the first design took the
        # same for its own lse and delta)
        stats = torch.empty((2, rows), dtype=torch.float32, device=qkv.device)
    dqkv = torch.empty_like(qkv)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    lib = library()
    with torch.cuda.device(qkv.device):
        err = lib.cor_vit_attention_relpos_bwd(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), do.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            dqkv.data_ptr(), drel_h.data_ptr(), drel_w.data_ptr(), stats.data_ptr(),
            B, N, C, num_heads, H, W, float(D**-0.5), int(dt == torch.float32),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, "vit_attention_relpos_bwd")
    count_launch(vit_attention_relpos_bwd, dt)
    return dqkv, drel_h, drel_w


class _VitAttentionRelpos(torch.autograd.Function):
    """K6 forward, K6b backward (the plain versions on the CPU). Where a
    gradient is wanted the forward writes its rows' log-sum-exp too, and
    saves it and its output for the backward."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, num_heads, hw):
        ctx.num_heads, ctx.hw = num_heads, hw
        out, lse = _forward(qkv, rel_h, rel_w, num_heads, hw,
                            with_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(qkv, rel_h, rel_w, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, rel_h, rel_w, out, lse = ctx.saved_tensors
        dqkv, drel_h, drel_w = vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, ctx.num_heads,
                                                        ctx.hw, out=out, lse=lse)
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


# ---------------------------------------------------------------------------
# K7: the windows of a padded grid
# ---------------------------------------------------------------------------


def _partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, Hp, Wp, ...] -> [B * nW, window * window, ...], windows in row
    order (``ops.attention.window_partition`` on a grid already padded)."""
    B, Hp, Wp = x.shape[:3]
    rest = x.shape[3:]
    x = x.reshape(B, Hp // window, window, Wp // window, window, *rest)
    x = x.permute(0, 1, 3, 2, 4, *range(5, x.dim()))
    return x.reshape(B * (Hp // window) * (Wp // window), window * window, *rest)


def vit_attention_relpos_windows_plain(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    window: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """The plain version: the windows partitioned, K6's plain version in
    each, unpartitioned and cropped to ``hw``."""
    B, Hp, Wp, C3 = qkv.shape
    H, W = hw
    qw = _partition(qkv, window)
    rel = [_partition(r.reshape(B, num_heads, Hp, Wp, window).permute(0, 2, 3, 1, 4), window)
           .transpose(1, 2) for r in (rel_h, rel_w)]  # [B * nW, heads, window^2, window]
    out = vit_attention_relpos_plain(qw, rel[0], rel[1], num_heads, (window, window))
    out = out.reshape(B, Hp // window, Wp // window, window, window, C3 // 3)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C3 // 3)
    return out[:, :H, :W].contiguous()


def _windows_forward(qkv, rel_h, rel_w, num_heads: int, window: int,
                     hw: Tuple[int, int]) -> torch.Tensor:
    """K7 on a CUDA tensor, the plain version on the CPU."""
    if qkv.device.type == "cpu":
        return vit_attention_relpos_windows_plain(qkv, rel_h, rel_w, num_heads, window, hw)
    if qkv.device.type != "cuda":
        raise ValueError(f"vit_attention_relpos_windows: no kernel for device {qkv.device}")
    what = "vit_attention_relpos_windows"
    if qkv.dim() != 4 or not qkv.is_contiguous():
        raise ValueError(f"{what} takes a contiguous qkv [B, Hp, Wp, 3C], got "
                         f"{tuple(qkv.shape)}")
    B, Hp, Wp, C3 = qkv.shape
    H, W = hw
    D, dt = _check(qkv.reshape(B, Hp * Wp, C3), rel_h, rel_w, num_heads, (Hp, Wp), what,
                   sides=(window, window))
    if not (1 <= window <= MAX_SIDE and Hp % window == 0 and Wp % window == 0
            and 1 <= H <= Hp and 1 <= W <= Wp):
        raise ValueError(f"{what} kernel: grid {Hp} x {Wp} must be whole windows of "
                         f"{window} <= {MAX_SIDE}, cropped to {H} x {W}")
    if B * (Hp // window) * (Wp // window) > 65535:
        raise ValueError(f"{what} kernel: {B} images of {Hp // window} x {Wp // window} "
                         "windows is more than 65535 blocks")
    C = C3 // 3
    out = torch.empty((B, H, W, C), dtype=qkv.dtype, device=qkv.device)
    lib = library()
    with torch.cuda.device(qkv.device):
        err = lib.cor_vit_attention_relpos_windows(
            qkv.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
            B, Hp, Wp, H, W, C, num_heads, window, float(D**-0.5), int(dt == torch.float32),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    check(err, what)
    count_launch(vit_attention_relpos_windows, dt)
    return out


_windows_diff = with_plain_vjp(_windows_forward, vit_attention_relpos_windows_plain)


def vit_attention_relpos_windows(
    qkv: torch.Tensor,
    rel_h: torch.Tensor,
    rel_w: torch.Tensor,
    num_heads: int,
    window: int,
    hw: Tuple[int, int],
) -> torch.Tensor:
    """qkv [B, Hp, Wp, 3C] (Hp, Wp multiples of ``window``), rel_h and rel_w
    [B, heads, Hp * Wp, window] -> [B, H, W, C] with (H, W) = ``hw``;
    differentiable in all three (the plain version's VJP)."""
    return _windows_diff(qkv, rel_h, rel_w, num_heads, window, tuple(hw))


vit_attention_relpos.launches = vit_attention_relpos.launches_fp32 = 0
vit_attention_relpos_bwd.launches = vit_attention_relpos_bwd.launches_fp32 = 0
vit_attention_relpos_windows.launches = vit_attention_relpos_windows.launches_fp32 = 0
