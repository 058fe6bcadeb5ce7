"""LayerNorm over the last axis: the CUDA kernel ``csrc/layernorm.cu`` and its
plain PyTorch version.

Replaces ``cor_tpu/ops/pallas/layernorm.py:layer_norm_pallas`` (the
``pallas_call`` in ``_layer_norm_pallas_impl``). Numerics are those of its
``_ln_block``: fp32 mean, biased variance as mean((x - mean)^2) in a second
pass, output in the input dtype.

On the H100 the kernel is bound by bytes (one read and one write of the
tensor, ~8 flops per element); it keeps each row in one warp's registers so
that memory is touched once each way. See the source for the design.

``layer_norm`` takes the plain version for a tensor on the CPU, and the
kernel for a CUDA tensor: x in fp32 or bf16, the scale and bias in fp32 or
bf16 (each pair of the four has its instantiation); it raises on a CUDA
tensor the kernel does not take. Launches are counted by x's dtype:
``layer_norm.launches`` (bf16) and ``layer_norm.launches_fp32``.
It never falls back from the kernel to the plain version. Where autograd
records the call (training an unfrozen tower), the kernel runs forward and
the gradient is the plain version's, recomputed in the backward
(``ops.diff.with_plain_vjp``), as ``cor_tpu`` takes it from XLA.
"""

from __future__ import annotations

import torch

# the plain PyTorch version is ops.common's layer_norm, the one the models'
# other LayerNorms use
from cor_tpu_torch.ops.common import layer_norm as layer_norm_plain
from cor_tpu_torch.ops.diff import needs_grad, with_plain_vjp
from cor_tpu_torch.ops.kernels._build import check, count_launch, library

MAX_COLS = 2048  # 64 values per lane of one warp, the kernel's largest case
_FLOAT = (torch.float32, torch.bfloat16)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm of ``x`` [..., C] with ``scale``/``bias`` [C]."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm: no kernel for device {x.device}")
    if needs_grad(x, scale, bias):
        return _layer_norm_diff(x, scale, bias, eps)
    return _layer_norm_kernel(x, scale, bias, eps)


def _layer_norm_kernel(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    C = x.shape[-1]
    if x.dtype not in _FLOAT:
        raise TypeError(f"layer_norm kernel takes fp32 or bf16 input, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype not in _FLOAT or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(
                f"layer_norm kernel: {name} must be a contiguous fp32/bf16 [{C}] tensor on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if scale.dtype != bias.dtype:
        raise TypeError(f"layer_norm kernel: scale {scale.dtype} != bias {bias.dtype}")
    if not x.is_contiguous():
        raise ValueError("layer_norm kernel takes a contiguous input")
    if not 1 <= C <= MAX_COLS:
        raise ValueError(f"layer_norm kernel takes 1 <= C <= {MAX_COLS}, got C={C}")
    y = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return y
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.cor_layer_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, C, float(eps),
            int(x.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(err, "layer_norm")
    count_launch(layer_norm, x.dtype)
    return y


_layer_norm_diff = with_plain_vjp(_layer_norm_kernel, layer_norm_plain)
layer_norm.launches = layer_norm.launches_fp32 = 0
