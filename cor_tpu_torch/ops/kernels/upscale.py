"""The mask decoder's last upscale stage fused with the hypernetwork product:
the CUDA kernel ``csrc/upscale.cu`` and its plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/upscale.py:fused_upscale2_hyper`` (K9, its
``pallas_call`` at line 104):

    up  = gelu(conv_transpose_2x2_s2(x, w) + b)           # [B, 2H, 2W, O]
    out = einsum('bnc,bhwc->bnhw', hyper, up)             # [B, N, 2H, 2W] fp32

with cor_tpu's weight layout ``w`` [C, 2, 2, O]: input pixel (i, j) makes
output pixels (2i + p, 2j + q). Only tests call it in either package: K3
(``ops.kernels.decoder_tail``) supersedes it on the decode path.

Numerics, as the TPU kernel's: w is rounded to x's dtype and the products
accumulate in fp32; the bias is fp32; the GELU is ``gelu_erf_as`` (erf by
Abramowitz-Stegun, ``cor_tpu``'s ``_gelu_exact``) in fp32 on the unrounded
accumulator, in bf16 and fp32 alike (not K3's bf16 polynomial); hyper is
rounded to x's dtype and widened, and the second product is fp32.

On the card: one launch per call (``fused_upscale2_hyper.launches`` in
bf16, ``launches_fp32`` in fp32) of a persistent kernel redesigned for
Hopper: w resident in shared memory, the x tiles streamed by the TMA, one
wgmma product a 64-pixel tile for all four positions, the GELU and the hyper
dot in registers. ``tile_geometry``, ``cta_tiles``, ``upscale_plan`` and
``resident_w`` mirror its walk, its launch plan and its shared-memory copy
of w for the tests. x and hyper are bf16 or fp32, of one
dtype (fp16: ROADMAP Queue 2, @fp16); C a multiple of 16 up to 256, O a
multiple of 8 up to 64, 1 <= N <= 16, B <= 65535 (other shapes: ROADMAP
Queue 2, @K9-shape). Anything else raises before the launch, on any device
but the CPU, whose tensors take the plain version. Forward only, as the
TPU kernel: with autograd recording it raises.
"""

from __future__ import annotations

import torch

from cor_tpu_torch.ops.common import gelu_erf_as
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype
from cor_tpu_torch.ops.kernels.t2i_flash import SMEM_LIMIT, cached_pack

MAX_C, MAX_O, MAX_N, MAX_B = 256, 64, 16, 65535
SHAPE_ITEM = "ROADMAP Queue 2, @K9-shape"  # the row that ports other shapes


def fused_upscale2_hyper_plain(x, w, b, hyper) -> torch.Tensor:
    """x [B, H, W, C], w [C, 2, 2, O], b [O], hyper [B, N, O] -> [B, N, 2H,
    2W] fp32. The transposed conv is an einsum (a matmul, so cuDNN's TF32
    setting does not reach it)."""
    dt = x.dtype
    B, H, W, _ = x.shape
    y = torch.einsum("bhwc,cpqo->bhpwqo", x.float(), w.to(dt).float())
    up = gelu_erf_as(y.reshape(B, 2 * H, 2 * W, -1) + b.float())
    return torch.einsum("bnc,bhwc->bnhw", hyper.to(dt).float(), up)


def fused_upscale2_hyper(x, w, b, hyper) -> torch.Tensor:
    """x [B, H, W, C], w [C, 2, 2, O], b [O], hyper [B, N, O] -> [B, N, 2H,
    2W] fp32."""
    if x.device.type == "cpu":
        refuse_grad("fused_upscale2_hyper", x, w, b, hyper)
        return fused_upscale2_hyper_plain(x, w, b, hyper)
    dt = _check(x, w, b, hyper)
    if x.device.type != "cuda":
        raise ValueError(f"fused_upscale2_hyper: no kernel for device {x.device}")
    refuse_grad("fused_upscale2_hyper", x, w, b, hyper)
    B, H, W, C = x.shape
    O, N = w.shape[-1], hyper.shape[1]
    dev = x.device
    out = torch.empty((B, N, 2 * H, 2 * W), device=dev, dtype=torch.float32)
    if out.numel() == 0:
        return out
    wt, bf = _pack(w, b, dev, dt)
    lib = library()
    with torch.cuda.device(dev):
        check(lib.cor_fused_upscale2_hyper(
            x.data_ptr(), wt.data_ptr(), bf.data_ptr(), hyper.data_ptr(), out.data_ptr(),
            B, H, W, C, O, N, int(dt == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream), "fused_upscale2_hyper")
    count_launch(fused_upscale2_hyper, dt)
    return out


def _check(x, w, b, hyper) -> torch.dtype:
    """The compute dtype (bf16 or fp32) of x and hyper, or raise on what the
    kernel does not take."""
    if x.dim() != 4 or hyper.dim() != 3:
        raise ValueError(f"fused_upscale2_hyper takes x [B, H, W, C] and hyper [B, N, O]; got "
                         f"{tuple(x.shape)}, {tuple(hyper.shape)}")
    B, H, W, C = x.shape
    O, N = w.shape[-1], hyper.shape[1]
    if (tuple(w.shape) != (C, 2, 2, O) or tuple(b.shape) != (O,)
            or tuple(hyper.shape) != (B, N, O)):
        raise ValueError(
            f"fused_upscale2_hyper: w must be [{C}, 2, 2, O], b [O] and hyper [{B}, N, O]; got "
            f"{tuple(w.shape)}, {tuple(b.shape)}, {tuple(hyper.shape)}")
    if not (C % 16 == 0 and 16 <= C <= MAX_C and O % 8 == 0 and 8 <= O <= MAX_O
            and 1 <= N <= MAX_N and B <= MAX_B):
        raise ValueError(
            f"fused_upscale2_hyper kernel takes C a multiple of 16 up to {MAX_C}, O a multiple "
            f"of 8 up to {MAX_O}, 1 <= N <= {MAX_N} and B <= {MAX_B}; got C {C}, O {O}, N {N}, "
            f"B {B} ({SHAPE_ITEM})")
    dt = operand_dtype("fused_upscale2_hyper", x, hyper)
    if not (w.is_floating_point() and b.is_floating_point()):
        raise TypeError(f"fused_upscale2_hyper: w and b must be floating, got {w.dtype}, "
                        f"{b.dtype}")
    if not x.is_contiguous() or not hyper.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_upscale2_hyper kernel takes contiguous x (16-byte aligned) "
                         "and hyper")
    if any(t.device != x.device for t in (w, b, hyper)):
        raise ValueError(f"fused_upscale2_hyper: every operand on {x.device}")
    return dt


def _pack(w, b, device, dtype):
    """(w as [(p, q, o), C] in the compute dtype, b in fp32), kept on ``w``
    (``cached_pack``: keyed by device and dtype)."""
    def make():
        C, O = w.shape[0], w.shape[-1]
        return (w.detach().reshape(C, 4 * O).T.to(device, dtype).contiguous(),
                b.detach().to(device, torch.float32).contiguous())

    return cached_pack(w, "_upscale_pack", (w, b), device, dtype, make)


# the kernel's geometry (csrc/upscale.cu)
TILE_PIXELS = 64  # input pixels a tile: wgmma's M
MAX_STAGES = 6  # x tiles in flight a CTA
MAPS_AT_ONCE = 2  # the maps whose hyper dots a thread sums at once (hyper rows padded to it)


def tile_geometry(H: int, W: int) -> tuple:
    """A tile of the kernel (``tile_at``): (wc, rt, tiles_w, per_b): rt rows
    of wc pixels (64 columns of a row where W >= 64, else 64 // W whole
    rows), tiles_w tiles across a row, per_b tiles a sample."""
    wc = TILE_PIXELS if W >= TILE_PIXELS else W
    rt = 1 if W >= TILE_PIXELS else TILE_PIXELS // W
    tiles_w = -(-W // wc)
    return wc, rt, tiles_w, -(-H // rt) * tiles_w


def tile_pixels(B: int, H: int, W: int, tile: int) -> list:
    """The (b, i, j) input pixels that tile ``tile`` computes, in its GEMM
    rows' order (the rows past them are masked)."""
    wc, rt, tiles_w, per_b = tile_geometry(H, W)
    b, r = divmod(tile, per_b)
    i0, j0 = (r // tiles_w) * rt, (r % tiles_w) * wc
    cnt = min(TILE_PIXELS, W - j0) if W >= TILE_PIXELS else min(rt, H - i0) * W
    return [(b, i0 + row // wc, j0 + row % wc) for row in range(cnt)]


def cta_tiles(tiles: int, ctas: int, groups: int = 3) -> list:
    """The persistent walk: CTA c takes the contiguous range [c * tiles //
    ctas, (c + 1) * tiles // ctas), and its consumer warpgroup g every
    ``groups``-th tile of it from the g-th: [[tiles of warpgroup 0, ...],
    ...] by CTA."""
    out = []
    for c in range(ctas):
        first, last = c * tiles // ctas, (c + 1) * tiles // ctas
        out.append([list(range(first + g, last, groups)) for g in range(groups)])
    return out


def upscale_plan(C: int, O: int, N: int, dtype: torch.dtype) -> dict:
    """The kernel's launch plan (``upscale_plan``): positions of w resident
    a pass (4, 2 or 1), consumer warpgroups (3, 2 or 1; at most 2 where a
    pass's product is 256 wide), x stages and the dynamic shared memory, or
    None where nothing fits."""
    el = 2 if dtype == torch.bfloat16 else 4
    kop = 32 if O <= 32 else 64
    xs = TILE_PIXELS * C * el
    wpos = kop * C * (2 if el == 2 else 8)
    group = (-(-N // MAPS_AT_ONCE) * MAPS_AT_ONCE * kop + N * 4 * TILE_PIXELS) * 4
    fixed = kop * 4 + 2 * MAX_STAGES * 8
    for npos, groups in ((4, 3), (4, 2), (2, 3), (2, 2), (1, 3), (1, 2), (4, 1), (2, 1),
                         (1, 1)):
        n = npos * kop
        if n < 64 or groups > (2 if n == 256 else 3):
            continue
        rest = SMEM_LIMIT - fixed - groups * group - npos * wpos
        if rest < xs:
            continue
        stages = min(MAX_STAGES, rest // xs)
        return dict(npos=npos, groups=groups, stages=stages, kop=kop,
                    smem=npos * wpos + kop * 4 + groups * group + 2 * stages * 8 + stages * xs)
    return None


def resident_w(wt: torch.Tensor, O: int, npos: int = 4, pass_: int = 0) -> torch.Tensor:
    """The kernel's shared-memory copy of a pass's slice of w (bf16:
    ``load_w_slice``), from the wrapper's pack ``wt`` [(p, q, o), C]: rows
    nn = (position, o) with o padded to 32 or 64 by zeros, in wgmma's K-major
    core-matrix layout (element (nn, c) at ((nn // 8) * (C // 8) + c // 8) *
    64 + (nn % 8) * 8 + c % 8), flat."""
    C = wt.shape[1]
    kop = 32 if O <= 32 else 64
    n = npos * kop
    out = torch.zeros(n * C, dtype=wt.dtype)
    ch = C // 8
    for nn in range(n):
        pq, o = pass_ * npos + nn // kop, nn % kop
        if o >= O:
            continue
        for c in range(C):
            out[((nn // 8) * ch + c // 8) * 64 + (nn % 8) * 8 + c % 8] = wt[pq * O + o, c]
    return out


fused_upscale2_hyper.launches = fused_upscale2_hyper.launches_fp32 = 0
