"""LayerNorm over the last axis, and LayerNorm(x + y): the CUDA kernel
``csrc/layernorm.cu`` and their plain PyTorch versions.

Replaces ``cor_tpu/ops/pallas/layernorm.py``'s two kernels:
``layer_norm_pallas`` (K5, the ``pallas_call`` in ``_layer_norm_pallas_impl``)
and ``add_layer_norm_pallas`` (K5′, the one in
``_add_layer_norm_pallas_impl``). Numerics are those of their ``_ln_block``:
fp32 mean, biased variance as mean((x - mean)^2) in a second pass, output in
the input dtype. K5′ adds x and y in fp32 and never rounds the sum, as the
TPU kernel's ``_add_ln_kernel``; ``cor_tpu``'s XLA fallback (C % 128 != 0,
or rows that do not tile) rounds it to x's dtype. The port takes the
kernel's numerics at every shape: in bf16 at those shapes the two packages
differ by that one rounding of the sum.

On the H100 the kernel is bound by bytes (one read of each input and one
write, ~8 flops per element); it keeps each row in one warp's registers so
that memory is touched once each way, moves 16 bytes a lane per access
(lanes own contiguous chunks of a row), keeps scale and bias in fp32 in
shared memory for all the rows a persistent block takes, and has the next
row's loads in flight while a row reduces.
A row that is not whole 16-byte chunks, or an input that is not 16-byte
aligned, takes the same kernel's scalar instantiation, counted as the same
launch. See ``csrc/layernorm.cuh`` for the design.

``layer_norm`` and ``add_layer_norm`` take the plain version for a tensor
on the CPU, and the kernel for a CUDA tensor: x (and y) in fp32 or bf16,
each on its own, the scale and bias in fp32 or bf16 (each combination has
its instantiation); they raise on a CUDA tensor the kernel does not take.
Launches are counted by x's dtype: ``layer_norm.launches`` (bf16) and
``layer_norm.launches_fp32``, and ``add_layer_norm``'s the same way. They
never fall back from the kernel to the plain version. Where autograd
records the call (training an unfrozen tower), the kernel runs forward and
the gradient is the plain version's, recomputed in the backward
(``ops.diff.with_plain_vjp``), as ``cor_tpu`` takes it from XLA; K5′ has no
backward kernel in ``cor_tpu`` either.
"""

from __future__ import annotations

import torch

# the plain PyTorch version is ops.common's layer_norm, the one the models'
# other LayerNorms use
from cor_tpu_torch.ops.common import layer_norm as layer_norm_plain
from cor_tpu_torch.ops.diff import needs_grad, with_plain_vjp
from cor_tpu_torch.ops.kernels._build import check, count_launch, library

MAX_COLS = 2048  # the widest row: scale and bias in the kernel's shared memory
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


def add_layer_norm(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm(x + y) of ``x``, ``y`` [..., C] with ``scale``/``bias`` [C],
    the sum in fp32, unrounded; output in x's dtype."""
    if x.device.type == "cpu":
        return add_layer_norm_plain(x, y, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_layer_norm: no kernel for device {x.device}")
    if needs_grad(x, y, scale, bias):
        return _add_layer_norm_diff(x, y, scale, bias, eps)
    return _add_layer_norm_kernel(x, y, scale, bias, eps)


def add_layer_norm_plain(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """The plain PyTorch version: ``layer_norm_plain`` of x + y summed in
    fp32, rounded once to x's dtype at the end."""
    return layer_norm_plain(x.float() + y.float(), scale, bias, eps).to(x.dtype)


def _check(what: str, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    """Raise on what the kernel does not take; returns C."""
    C = x.shape[-1]
    if x.dtype not in _FLOAT:
        raise TypeError(f"{what} kernel takes fp32 or bf16 input, got {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype not in _FLOAT or t.shape != (C,) or not t.is_contiguous():
            raise ValueError(
                f"{what} kernel: {name} must be a contiguous fp32/bf16 [{C}] tensor on "
                f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}"
            )
    if scale.dtype != bias.dtype:
        raise TypeError(f"{what} kernel: scale {scale.dtype} != bias {bias.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel takes a contiguous input")
    if not 1 <= C <= MAX_COLS:
        raise ValueError(f"{what} kernel takes 1 <= C <= {MAX_COLS}, got C={C}")
    return C


def _layer_norm_kernel(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    C = _check("layer_norm", x, scale, bias)
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


def _add_layer_norm_kernel(
    x: torch.Tensor, y: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float
) -> torch.Tensor:
    C = _check("add_layer_norm", x, scale, bias)
    if y.device != x.device or y.dtype not in _FLOAT or y.shape != x.shape or not y.is_contiguous():
        raise ValueError(
            f"add_layer_norm kernel: y must be a contiguous fp32/bf16 tensor of x's shape "
            f"{tuple(x.shape)} on {x.device}, got {tuple(y.shape)} {y.dtype} on {y.device}")
    out = torch.empty_like(x)
    rows = x.numel() // C
    if rows == 0:
        return out
    lib = library()
    with torch.cuda.device(x.device):
        err = lib.cor_add_layer_norm(
            x.data_ptr(), y.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, C, float(eps), int(x.dtype == torch.bfloat16),
            int(y.dtype == torch.bfloat16), int(scale.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    check(err, "add_layer_norm")
    count_launch(add_layer_norm, x.dtype)
    return out


_layer_norm_diff = with_plain_vjp(_layer_norm_kernel, layer_norm_plain)
_add_layer_norm_diff = with_plain_vjp(_add_layer_norm_kernel, add_layer_norm_plain)
layer_norm.launches = layer_norm.launches_fp32 = 0
add_layer_norm.launches = add_layer_norm.launches_fp32 = 0
