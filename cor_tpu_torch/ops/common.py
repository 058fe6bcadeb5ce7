"""Core building blocks, the PyTorch counterpart of ``cor_tpu.ops.common``.

Two layers, as in ``cor_tpu``: plain functions on tensors (``dense``,
``layer_norm``, ``gelu`` ...) that fix the numerics, and small ``nn.Module``
parameter holders (``Dense``, ``LayerNorm``, ``Conv2d``, ``MlpBlock``) whose
parameter names are the leaf names of ``cor_tpu``'s parameter trees (``w``,
``b``, ``scale``, ``bias``), so that a ``cor_tpu`` tree maps onto a module's
``state_dict`` name for name (``cor_tpu_torch.utils.weights``).

Layouts:
- activations are NHWC and ``[B, N, C]``, as in ``cor_tpu``;
- a dense weight is stored ``[out, in]`` (``cor_tpu``: ``[in, out]``) and a
  convolution weight OIHW (``cor_tpu``: HWIO). The weight bridge converts.

Numerics follow ``cor_tpu``: matmuls in the input dtype, normalisation
statistics in fp32, GELU exact (erf) in fp32 and the ``_PHI_COEF``
polynomial in bf16.

Each holder's ``reset_parameters(generator)`` draws the distributions of the
matching ``cor_tpu`` init function (torch's kaiming-uniform(a=sqrt(5)) bound
``1/sqrt(fan_in)`` for weights and biases; LayerNorm ones and zeros), from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


@torch.no_grad()
def torch_uniform_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)) in place (cor_tpu ``_torch_uniform``)."""
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    u = torch.rand(t.shape, generator=generator, dtype=torch.float32, device=generator.device)
    t.copy_(u * (2 * bound) - bound)
    return t


@torch.no_grad()
def trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """Normal(0, std) truncated to [-2 std, 2 std] by inverse CDF, in place
    (cor_tpu ``trunc_normal``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    u = torch.rand(t.shape, generator=generator, dtype=torch.float32, device=generator.device)
    z = torch.erfinv((lo + (hi - lo) * u) * 2.0 - 1.0) * math.sqrt(2.0)
    t.copy_(z.clamp_(-2.0, 2.0) * std)
    return t


def reset_all(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter of ``module``: each submodule that owns
    parameters defines ``reset_parameters(generator)``, called in
    ``module.modules()`` order."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module


# ---------------------------------------------------------------------------
# functions
# ---------------------------------------------------------------------------


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w.T + b, output in x.dtype. ``w`` is ``[out, in]``."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


@contextlib.contextmanager
def _cudnn_full_fp32():
    """cuDNN with TF32 off for the calls inside, the flag restored after.

    Torch's default is ``torch.backends.cudnn.allow_tf32 = True``, under which
    an fp32 convolution on the card multiplies in TF32 (a 10-bit mantissa);
    ``cor_tpu``'s fp32 convolutions are full fp32. Only this flag is touched
    (``torch.backends.cudnn.flags`` would reset benchmark and determinism
    too), through the one API that torch 2.11 and 2.13 both take without a
    warning."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old


def _pair(v) -> list:
    return [v, v] if isinstance(v, int) else list(v)


class _Fp32Conv(torch.autograd.Function):
    """An fp32 convolution, transposed or not, with TF32 off in the forward
    and in the backward: autograd's own backward would read the global flag
    when it runs, outside any scope the forward set."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, groups, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, groups, transposed, None if b is None else list(b.shape))
        conv = F.conv_transpose2d if transposed else F.conv2d
        with _cudnn_full_fp32():
            return conv(x, w, b, stride=stride, padding=padding, groups=groups)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, groups, transposed, b_shape = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                ctx.needs_input_grad[2] and b_shape is not None]
        with _cudnn_full_fp32():
            gx, gw, gb = torch.ops.aten.convolution_backward(
                g, x, w, b_shape, stride, padding, [1, 1], transposed, [0, 0], groups, mask)
        return gx, gw, gb, None, None, None, None


def convolution(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Union[int, Tuple[int, int]] = 0,
    groups: int = 1,
    transposed: bool = False,
) -> torch.Tensor:
    """``F.conv2d`` (or ``F.conv_transpose2d``), NCHW, x and w of one dtype.
    In fp32 the products are full fp32, forward and backward, whatever
    ``torch.backends.cudnn.allow_tf32`` says outside; other dtypes run as
    torch runs them."""
    if x.dtype != torch.float32:
        conv = F.conv_transpose2d if transposed else F.conv2d
        return conv(x, w, b, stride=stride, padding=padding, groups=groups)
    return _Fp32Conv.apply(x, w, b, _pair(stride), _pair(padding), groups, transposed)


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    stride: int = 1,
    padding: Union[int, Tuple[int, int]] = 0,
    groups: int = 1,
) -> torch.Tensor:
    """NHWC convolution with an OIHW weight (torch.nn.Conv2d semantics);
    fp32 in full fp32 (``convolution``)."""
    y = convolution(
        x.permute(0, 3, 1, 2), w.to(x.dtype), None if b is None else b.to(x.dtype),
        stride=stride, padding=padding, groups=groups,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def conv_transpose_2x(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 transposed convolution, NHWC, with cor_tpu's kernel layout
    ``w`` [C_in, 2, 2, C_out]:

        out[n, 2i + di, 2j + dj, o] = sum_c x[n, i, j, c] * w[c, di, dj, o] + b[o]

    ``F.conv_transpose2d`` takes [C_in, C_out, kh, kw] and applies it without
    a flip (cor_tpu pre-flips only because ``lax.conv_transpose`` flips).
    Output in x.dtype; fp32 in full fp32 (``convolution``)."""
    y = convolution(
        x.permute(0, 3, 1, 2), w.to(x.dtype).permute(0, 3, 1, 2), b.to(x.dtype), stride=2,
        transposed=True,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis: fp32 mean, biased variance
    mean((x - mean)^2), output in x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


# Phi(x) ~ 0.5 + x * P(x^2) on [-4, 4] with the endpoints pinned: the
# coefficients of cor_tpu.ops.common._PHI_COEF, the GELU that cor_tpu runs in
# bf16. Using the same fit keeps bf16 results aligned with cor_tpu's.
_PHI_COEF = (
    0.3988655684219049,
    -0.06549521524440009,
    0.00915741119509791,
    -0.0008908471655209013,
    5.561942806489455e-05,
    -1.968709803084503e-06,
    2.967939450354871e-08,
)


def gelu_poly(x: torch.Tensor) -> torch.Tensor:
    """The polynomial GELU itself (same float dtype in and out)."""
    t = x.clamp(-4.0, 4.0)
    t2 = t * t
    p = torch.full_like(t, _PHI_COEF[-1])
    for c in _PHI_COEF[-2::-1]:
        p = p * t2 + c
    return x * (0.5 + t * p)


# erf by Abramowitz-Stegun 7.1.26 (|error| < 1.5e-7): the coefficients of
# cor_tpu.ops.pallas.upscale._erf, whose Pallas kernel (K9) has no erf
_ERF_AS = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_ERF_AS_P = 0.3275911


def gelu_erf_as(x: torch.Tensor) -> torch.Tensor:
    """GELU with erf by Abramowitz-Stegun 7.1.26: the port's copy of
    ``cor_tpu.ops.pallas.upscale._gelu_exact``, K9's GELU in every dtype
    (same dtype in and out)."""
    z = x * 0.7071067811865476
    az = z.abs()
    t = 1.0 / (1.0 + _ERF_AS_P * az)
    a1, a2, a3, a4, a5 = _ERF_AS
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return 0.5 * x * (1.0 + torch.sign(z) * (1.0 - poly * torch.exp(-az * az)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: exact (erf) unless bf16, where it is ``gelu_poly`` in fp32."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    return gelu_poly(x.float()).to(x.dtype)


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator], train: bool
) -> torch.Tensor:
    """Inverted dropout; the identity when not training, at rate 0, or
    without a generator (cor_tpu: without a key)."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator, device=generator.device).to(x.device)
    return torch.where(u < keep, x / keep, torch.zeros_like(x)).to(x.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps), computed in fp32, output in x.dtype."""
    x32 = x.float()
    n = torch.sqrt(torch.clamp((x32 * x32).sum(dim=dim, keepdim=True), min=eps * eps))
    return (x32 / n).to(x.dtype)


def mlp_block(p: "MlpBlock", x: torch.Tensor, act=gelu) -> torch.Tensor:
    """lin2(act(lin1(x)))."""
    return p.lin2(act(p.lin1(x)))


# ---------------------------------------------------------------------------
# parameter holders
# ---------------------------------------------------------------------------


class Dense(nn.Module):
    """cor_tpu ``init_dense`` / ``dense``: ``w`` [out, in], optional ``b``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.in_dim = in_dim
        self.w = nn.Parameter(torch.empty(out_dim, in_dim))
        self.b = nn.Parameter(torch.empty(out_dim)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_uniform_(self.w, self.in_dim, generator)
        if self.b is not None:
            torch_uniform_(self.b, self.in_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b)


class Conv2d(nn.Module):
    """cor_tpu ``init_conv2d`` / ``conv2d``: ``w`` OIHW [out, in/groups, kh, kw]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, bias: bool = True, groups: int = 1):
        super().__init__()
        self.fan_in = (in_ch // groups) * kernel * kernel
        self.groups = groups
        self.w = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.b = nn.Parameter(torch.empty(out_ch)) if bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        torch_uniform_(self.w, self.fan_in, generator)
        if self.b is not None:
            torch_uniform_(self.b, self.fan_in, generator)

    def forward(self, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
        return conv2d(x, self.w, self.b, stride=stride, padding=padding, groups=self.groups)


class LayerNorm(nn.Module):
    """cor_tpu ``init_layer_norm`` / ``layer_norm``: ``scale`` and ``bias``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(dim))
        self.bias = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias, self.eps)


class MlpBlock(nn.Module):
    """cor_tpu ``init_mlp_block`` / ``mlp_block``: lin1 -> GELU -> lin2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Dense(dim, hidden)
        self.lin2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_block(self, x)


class MlpStack(nn.Module):
    """cor_tpu ``init_mlp_stack`` / ``mlp_stack``: ``num_layers`` Dense
    layers with ReLU between them and none after the last (the SAM mask
    decoder's hypernetworks and IoU head)."""

    def __init__(self, in_dim: int, hidden: int, out_dim: int, num_layers: int):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
        self.layers = nn.ModuleList(Dense(dims[i], dims[i + 1]) for i in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
