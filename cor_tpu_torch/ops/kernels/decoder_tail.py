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

On the card: one launch per call (``decoder_tail.launches``), one CTA per
grid row of a candidate and output map. The kernel takes bf16 with C = 256,
O1 = 64, O2 = 32 and a grid 64 pixels wide; any other CUDA input raises, and
a CPU tensor takes the plain version. With autograd recording it raises:
``cor_tpu``'s kernel has no backward either (training runs the decoder's
``fused=False`` tail).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cor_tpu_torch.ops.common import conv_transpose_2x, gelu_poly, layer_norm
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, library
from cor_tpu_torch.ops.kernels.two_way_layer import cached_pack

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
    n, H, W, C = src.shape
    m = hyper.shape[1]
    if (C, W, tuple(w1.shape), tuple(w2.shape)) != (C_IN, GRID_W, (C_IN, 2, 2, O1), (O1, 2, 2, O2)):
        raise ValueError(
            f"decoder_tail kernel takes src [n, H, {GRID_W}, {C_IN}], w1 [{C_IN}, 2, 2, {O1}], "
            f"w2 [{O1}, 2, 2, {O2}]; got {tuple(src.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    if hyper.shape != (n, m, O2) or not 1 <= m <= 65535 or not 1 <= n <= 65535 or H < 1:
        raise ValueError(f"decoder_tail kernel: hyper {tuple(hyper.shape)} for {n} candidates")
    if src.dtype != torch.bfloat16 or hyper.dtype != torch.bfloat16:
        raise TypeError(f"decoder_tail kernel takes bf16, got {src.dtype} / {hyper.dtype}")
    if not src.is_contiguous() or not hyper.is_contiguous():
        raise ValueError("decoder_tail kernel takes contiguous src and hyper")
    refuse_grad("decoder_tail", src, w1, b1, ln_scale, ln_bias, w2, b2, hyper)
    dev = src.device
    bf = dict(device=dev, dtype=torch.bfloat16)
    f32 = dict(device=dev, dtype=torch.float32)
    w1t, w2t, vec = cached_pack(
        w1, "_tail_pack", (w1, b1, ln_scale, ln_bias, w2, b2), dev, lambda: (
            w1.detach().reshape(C_IN, 4 * O1).T.to(**bf).contiguous(),  # [(p,q,o1), C]
            w2.detach().reshape(O1, 4 * O2).T.to(**bf).contiguous(),  # [(r,s,o2), O1]
            torch.cat([b1.detach().reshape(-1), ln_scale.detach().reshape(-1),
                       ln_bias.detach().reshape(-1), b2.detach().reshape(-1)]).to(**f32),
        ))
    out = torch.empty((n, m, 4 * H, 4 * W), device=dev, dtype=torch.float32)
    lib = library()
    with torch.cuda.device(dev):
        check(lib.cor_decoder_tail(
            src.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), vec.data_ptr(), hyper.data_ptr(),
            n, m, H, eps, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
            "decoder_tail")
    decoder_tail.launches += 1
    return out


decoder_tail.launches = 0
