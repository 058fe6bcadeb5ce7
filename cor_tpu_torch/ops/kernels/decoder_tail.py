"""The SAM mask decoder's upscale tail: the CUDA kernel
``csrc/decoder_tail.cu`` and its plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/decoder_tail.py:fused_decoder_tail`` (its
``pallas_call`` at line 150):

    y   = gelu(LN(conv_transpose_2x2_s2(src, w1) + b1))   # C -> O1, 2x up
    up  = gelu(conv_transpose_2x2_s2(y, w2) + b2)         # O1 -> O2, 2x up
    out = einsum('bnc,bhwc->bnhw', hyper, up)             # fp32 logits

with cor_tpu's weight layout ``w1`` [C, 2, 2, O1], ``w2`` [O1, 2, 2, O2].
Input pixel (i, j) makes output pixels (4i + 2p + r, 4j + 2q + s).

Numerics: products accumulate in fp32; the LayerNorm (eps 1e-6) takes fp32
statistics over each O1 group; ``y`` and ``up`` are rounded to the compute
dtype before their products, and so is ``hyper``. GELU is the ``_PHI_COEF``
polynomial in bf16 (as the TPU kernel's bf16 path) and exact in fp32. The
TPU kernel folds the LN mean into w1 and takes the variance from bf16
operands; this port keeps fp32 statistics, which is closer to the exact
function (tests hold it within 0.05 relative of cor_tpu's fp32 tail in
bf16, as cor_tpu's own bf16 test does).

On the card: one launch per call (``decoder_tail.launches`` in bf16,
``launches_fp32`` in fp32), redesigned for Hopper: persistent CTAs on
``wgmma`` that take every map's dot from one pass over the pixels (in bf16
four warpgroups, one a position, with W1 and W2 resident in shared memory,
loaded from the wrapper's core-matrix pack ``_blocks``; in fp32 two, W1
streamed and split into TF32 halves; ``csrc/decoder_tail.cu`` says how).
The kernel takes C = 256, O1 = 64, O2 = 32 and a grid 64 pixels wide,
src and hyper in bf16 or fp32, of one dtype (in fp32 both products run in
3xTF32 on the tensor cores, nothing is rounded and GELU is exact); any other
CUDA input raises, and a CPU tensor takes the plain version. With autograd
recording it raises: ``cor_tpu``'s kernel has no backward either (training
runs the decoder's ``fused=False`` tail).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cor_tpu_torch.ops.common import conv_transpose_2x, gelu_poly, layer_norm
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype
from cor_tpu_torch.ops.kernels.t2i_flash import SMEM_LIMIT, cached_pack, ring_blocks

C_IN, O1, O2, GRID_W = 256, 64, 32, 64


def decoder_tail_plain(src, w1, b1, ln_scale, ln_bias, w2, b2, hyper, eps: float = 1e-6):
    """src [n, H, W, C], hyper [n, m, O2] -> [n, m, 4H, 4W] fp32."""
    dt = src.dtype
    act = gelu_poly if dt == torch.bfloat16 else F.gelu
    x = conv_transpose_2x(src.float(), w1.float(), b1.float())
    x = act(layer_norm(x, ln_scale, ln_bias, eps)).to(dt).float()
    up = act(conv_transpose_2x(x, w2.float(), b2.float())).to(dt).float()
    return torch.einsum("bnc,bhwc->bnhw", hyper.to(dt).float(), up)


def decoder_tail(src, w1, b1, ln_scale, ln_bias, w2, b2, hyper, eps: float = 1e-6):
    """src [n, H, W, C], hyper [n, m, O2] -> [n, m, 4H, 4W] fp32."""
    if src.device.type == "cpu":
        refuse_grad("decoder_tail", src, w1, b1, ln_scale, ln_bias, w2, b2, hyper)
        return decoder_tail_plain(src, w1, b1, ln_scale, ln_bias, w2, b2, hyper, eps)
    if src.device.type != "cuda":
        raise ValueError(f"decoder_tail: no kernel for device {src.device}")
    dt = _check(src, w1, w2, hyper)
    refuse_grad("decoder_tail", src, w1, b1, ln_scale, ln_bias, w2, b2, hyper)
    n, H, W, C = src.shape
    m = hyper.shape[1]
    dev = src.device
    w1t, w2t, vec = _pack(w1, b1, ln_scale, ln_bias, w2, b2, dev, dt)
    bf16 = dt == torch.bfloat16
    w_blocks = _blocks(w1, b1, ln_scale, ln_bias, w2, b2, w1t, w2t) if bf16 else None
    out = torch.empty((n, m, 4 * H, 4 * W), device=dev, dtype=torch.float32)
    lib = library()
    with torch.cuda.device(dev):
        check(lib.cor_decoder_tail(
            src.data_ptr(), w1t.data_ptr(), w2t.data_ptr(),
            0 if w_blocks is None else w_blocks.data_ptr(), vec.data_ptr(), hyper.data_ptr(),
            n, m, H, eps, out.data_ptr(), int(dt == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream), "decoder_tail")
    count_launch(decoder_tail, dt)
    return out


def _check(src, w1, w2, hyper) -> torch.dtype:
    """The compute dtype (bf16 or fp32) of src and hyper, or raise on what
    the kernel does not take."""
    n, H, W, C = src.shape
    m = hyper.shape[1]
    if (C, W, tuple(w1.shape), tuple(w2.shape)) != (C_IN, GRID_W, (C_IN, 2, 2, O1), (O1, 2, 2, O2)):
        raise ValueError(
            f"decoder_tail kernel takes src [n, H, {GRID_W}, {C_IN}], w1 [{C_IN}, 2, 2, {O1}], "
            f"w2 [{O1}, 2, 2, {O2}]; got {tuple(src.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    if hyper.shape != (n, m, O2) or not 1 <= m <= 65535 or not 1 <= n <= 65535 or H < 1:
        raise ValueError(f"decoder_tail kernel: hyper {tuple(hyper.shape)} for {n} candidates")
    dt = operand_dtype("decoder_tail", src, hyper)
    if not src.is_contiguous() or not hyper.is_contiguous():
        raise ValueError("decoder_tail kernel takes contiguous src and hyper")
    return dt


def _pack(w1, b1, ln_scale, ln_bias, w2, b2, device, dtype):
    """(w1 [(p, q, o1), C], w2 [(r, s, o2), O1] in the compute dtype, the
    fp32 vectors), kept on ``w1`` (``cached_pack``: keyed by device and
    dtype)."""
    def make():
        vec = [b1, ln_scale, ln_bias, b2]
        return (w1.detach().reshape(C_IN, 4 * O1).T.to(device, dtype).contiguous(),
                w2.detach().reshape(O1, 4 * O2).T.to(device, dtype).contiguous(),
                torch.cat([v.detach().reshape(-1) for v in vec]).to(device, torch.float32))

    return cached_pack(w1, "_tail_pack", (w1, b1, ln_scale, ln_bias, w2, b2), device, dtype,
                       make)


def _blocks(w1, b1, ln_scale, ln_bias, w2, b2, w1t, w2t):
    """The bf16 kernel's resident weights: ``_pack``'s w1t then w2t, each in
    wgmma's core-matrix layout, one after the other as its shared memory
    holds them (fp32 reads w1t and w2t), kept on ``w1`` beside the pack."""
    return cached_pack(w1, "_tail_blocks", (w1, b1, ln_scale, ln_bias, w2, b2), w1t.device,
                       w1t.dtype, lambda: torch.cat([ring_blocks(w1t, C_IN), ring_blocks(w2t, O1)]))


def tail_smem(dtype: torch.dtype) -> int:
    """The kernel's dynamic shared memory, as csrc/decoder_tail.cu lays it out:
    bf16 (``TailB``) W1 and W2 resident, a 2-deep ring of row tiles, 4 maps'
    staged rows per output row pair, the vectors, 8 mbarriers; fp32
    (``TailF``) a row tile per warpgroup, W2's TF32 halves, a 3-stage ring of
    W1's split [64][16] blocks, one map's staged rows per warpgroup, the
    vectors, 10 mbarriers."""
    vec = (3 * O1 + O2) * 4
    rows, w1, w2 = GRID_W * C_IN * 2, 4 * O1 * C_IN * 2, 4 * O2 * O1 * 2
    if dtype == torch.bfloat16:
        return w1 + w2 + 2 * rows + 2 * 4 * 2 * 4 * GRID_W * 4 + vec + 8 * 8
    return 2 * 2 * rows + 2 * 2 * w2 + 3 * O1 * 16 * 8 + 2 * 4 * 4 * GRID_W * 4 + vec + 10 * 8



decoder_tail.launches = decoder_tail.launches_fp32 = 0
