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
bf16, ``launches_fp32`` in fp32). x and hyper are bf16 or fp32, of one
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
from cor_tpu_torch.ops.kernels.t2i_flash import cached_pack

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


fused_upscale2_hyper.launches = fused_upscale2_hyper.launches_fp32 = 0
