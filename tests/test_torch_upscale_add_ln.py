"""The port's K5′ (``add_layer_norm``) and K9 (``fused_upscale2_hyper``)
against cor_tpu's Pallas kernels, and against their own plain versions on the
card.

On the CPU the wrappers run their plain PyTorch versions; those are held
against cor_tpu's kernels run as cor_tpu's own tests run them on the CPU
(Pallas interpret mode, or cor_tpu's XLA fallback), at cor_tpu's tolerances:
K5′ atol = rtol = 1e-5 in fp32 (tests/test_pallas_kernels.py:39, the gradient
tests/test_kernel_vjp.py:80), K9 1e-4 (tests/test_pallas_kernels.py:58).
bf16 K5′ is held within one bf16 rounding of the output (max |Δ| / max |ref|
<= 2e-2, chip_smoke.py's KERNEL_TOL); bf16 K9 at 1e-4, as fp32: both
packages feed the same rounded operands into fp32 arithmetic (measured:
3e-7 relative).

The tests marked ``gpu`` hold each CUDA kernel against its plain version on
the card, and the fp32 convolutions under torch's default flags against the
CPU; they skip without a CUDA card. A machine with a card but without jax
runs them with

    python -m pytest tests/test_torch_upscale_add_ln.py -m gpu --noconftest

which is why this file imports jax and cor_tpu only inside the CPU tests.
"""

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.common import gelu_erf_as
from cor_tpu_torch.ops.diff import with_plain_vjp
from cor_tpu_torch.ops.kernels.layernorm import (
    add_layer_norm,
    add_layer_norm_plain,
    layer_norm,
    layer_norm_plain,
)
from cor_tpu_torch.ops.kernels.upscale import fused_upscale2_hyper, fused_upscale2_hyper_plain

TOL = dict(atol=1e-5, rtol=1e-5)  # K5′ fp32
K9_TOL = dict(atol=1e-4, rtol=1e-4)  # K9, fp32 and bf16
BF16_REL = 2e-2  # one bf16 rounding of the output at |y| <= 4


@pytest.fixture(scope="module", autouse=True)
def warm_cpu_exp():
    """One multi-threaded torch.exp before the tests: in this torch CPU
    build, a process's first vectorized exp has come out up to 1.5e-4
    relative off in one thread's chunk (measured in 5 of 10 fresh
    processes; never on a later call), which the GELU and K9 tests would
    read as the port's error."""
    torch.exp(torch.linspace(-50.0, 0.0, 1 << 20))


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def jnp_bf16(a):
    import jax.numpy as jnp

    return jnp.asarray(a).astype(jnp.bfloat16)


def torch_bf16_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ---------------------------------------------------------------------------
# K5′: LayerNorm(x + y)
# ---------------------------------------------------------------------------


def add_ln_inputs(rng, shape):
    C = shape[-1]
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(C).astype(np.float32),
            rng.standard_normal(C).astype(np.float32))


@pytest.mark.parametrize("shape", [(2, 128, 256), (3, 7, 96)],
                         ids=["pallas-interpret", "xla-fallback"])
def test_add_layer_norm_plain_matches_pallas_fp32(rng, shape):
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import add_layer_norm_pallas

    arrs = add_ln_inputs(rng, shape)
    want = np.asarray(add_layer_norm_pallas(*map(jnp.asarray, arrs), eps=1e-6))
    t = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_allclose(add_layer_norm_plain(*t, 1e-6).numpy(), want, **TOL)
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    before = (add_layer_norm.launches, add_layer_norm.launches_fp32)
    np.testing.assert_allclose(add_layer_norm(*t, 1e-6).numpy(), want, **TOL)
    assert (add_layer_norm.launches, add_layer_norm.launches_fp32) == before


@pytest.mark.parametrize("route", ["wrapper", "plain-vjp"])
def test_add_layer_norm_grad_matches_jax(rng, route):
    """torch.autograd through the CPU wrapper, and through the card's
    backward (``with_plain_vjp`` of the plain version, its forward standing
    in for the kernel), against jax.grad of add_layer_norm_pallas, for x,
    y, scale and bias, loss sum(out^2)."""
    import jax
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import add_layer_norm_pallas

    arrs = add_ln_inputs(rng, (8, 128))
    want = jax.grad(lambda *a: jnp.sum(add_layer_norm_pallas(*a) ** 2), argnums=(0, 1, 2, 3))(
        *map(jnp.asarray, arrs))
    t = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    fn = add_layer_norm if route == "wrapper" else with_plain_vjp(add_layer_norm_plain,
                                                                  add_layer_norm_plain)
    got = torch.autograd.grad(fn(*t, 1e-6).square().sum(), t)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_add_layer_norm_plain_matches_pallas_bf16(rng):
    """bf16 x and y at a shape cor_tpu runs in its kernel (interpret mode):
    both sum in fp32 unrounded and round the output once."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import add_layer_norm_pallas

    x, y, s, b = add_ln_inputs(rng, (2, 128, 256))
    want = add_layer_norm_pallas(jnp_bf16(x), jnp_bf16(y), jnp.asarray(s), jnp.asarray(b))
    got = add_layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16(),
                         torch.from_numpy(s), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    assert rel_err(torch_bf16_np(got), want) <= BF16_REL


def test_add_layer_norm_known_difference_at_the_fallback_shape(rng):
    """The known difference (ROADMAP Queue 3): at a shape where cor_tpu falls
    back to XLA (C % 128 != 0), its fallback computes layer_norm(x + y) on
    the bf16 sum; the port keeps the kernel's unrounded fp32 sum at every
    shape. The port equals layer_norm(x.float() + y.float()) rounded once,
    and stays within one bf16 rounding of cor_tpu's fallback."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import add_layer_norm_pallas

    x, y, s, b = add_ln_inputs(rng, (3, 7, 96))
    xt, yt = torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16()
    got = add_layer_norm(xt, yt, torch.from_numpy(s), torch.from_numpy(b))
    unrounded = layer_norm_plain(xt.float() + yt.float(), torch.from_numpy(s),
                                 torch.from_numpy(b)).to(torch.bfloat16)
    assert torch.equal(got, unrounded)
    fallback = add_layer_norm_pallas(jnp_bf16(x), jnp_bf16(y), jnp.asarray(s), jnp.asarray(b))
    assert rel_err(torch_bf16_np(got), fallback) <= BF16_REL


# ---------------------------------------------------------------------------
# K9: the last upscale, exact GELU and the hypernetwork product
# ---------------------------------------------------------------------------


def test_gelu_erf_as_matches_cor_tpu():
    """The port's copy of cor_tpu's _gelu_exact (erf by Abramowitz-Stegun)."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.upscale import _gelu_exact

    z = np.linspace(-10.0, 10.0, 200_001, dtype=np.float32)
    np.testing.assert_allclose(gelu_erf_as(torch.from_numpy(z)).numpy(),
                               np.asarray(_gelu_exact(jnp.asarray(z))), atol=1e-6, rtol=0)


def upscale_inputs(rng, B, H, W, C, O, N):
    """The inputs of cor_tpu's own K9 test (tests/test_pallas_kernels.py:43-47)."""
    return (rng.standard_normal((B, H, W, C)).astype(np.float32),
            (rng.standard_normal((C, 2, 2, O)) * 0.1).astype(np.float32),
            (rng.standard_normal(O) * 0.1).astype(np.float32),
            rng.standard_normal((B, N, O)).astype(np.float32))


K9_SHAPES = [(2, 8, 8, 64, 32, 3), (2, 8, 8, 64, 32, 1), (2, 8, 8, 64, 32, 4),
             (2, 4, 8, 64, 32, 3)]
K9_IDS = ["oracle", "n1", "n4", "h4-w8"]


@pytest.mark.parametrize("shape", K9_SHAPES, ids=K9_IDS)
def test_fused_upscale2_hyper_plain_matches_pallas_fp32(rng, shape):
    import jax
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.upscale import fused_upscale2_hyper as j_upscale

    B, H, W, C, O, N = shape
    x, w, b, h = upscale_inputs(rng, *shape)
    want = np.asarray(j_upscale(*map(jnp.asarray, (x, w, b, h))))
    # the XLA oracle of tests/test_pallas_kernels.py:49-53, with jax.nn.gelu
    y = jnp.einsum("bhwc,cpqo->bhpwqo", x, w).reshape(B, 2 * H, 2 * W, O) + b
    oracle = np.asarray(jnp.einsum("bnc,bhwc->bnhw", h, jax.nn.gelu(y, approximate=False)))
    t = [torch.from_numpy(a) for a in (x, w, b, h)]
    got = fused_upscale2_hyper_plain(*t)
    assert got.dtype == torch.float32 and got.shape == (B, N, 2 * H, 2 * W)
    np.testing.assert_allclose(got.numpy(), want, **K9_TOL)
    np.testing.assert_allclose(got.numpy(), oracle, **K9_TOL)
    before = (fused_upscale2_hyper.launches, fused_upscale2_hyper.launches_fp32)
    np.testing.assert_allclose(fused_upscale2_hyper(*t).numpy(), want, **K9_TOL)
    assert (fused_upscale2_hyper.launches, fused_upscale2_hyper.launches_fp32) == before


@pytest.mark.parametrize("shape", K9_SHAPES[:1] + K9_SHAPES[3:], ids=["oracle", "h4-w8"])
def test_fused_upscale2_hyper_plain_matches_pallas_bf16(rng, shape):
    """bf16 x and hyper (w and b fp32, rounded and widened by both): the
    same rounded operands into fp32 arithmetic in both packages."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.upscale import fused_upscale2_hyper as j_upscale

    x, w, b, h = upscale_inputs(rng, *shape)
    want = np.asarray(j_upscale(jnp_bf16(x), jnp.asarray(w), jnp.asarray(b), jnp_bf16(h)))
    got = fused_upscale2_hyper(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                               torch.from_numpy(b), torch.from_numpy(h).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **K9_TOL)


def test_fused_upscale2_hyper_refuses_autograd():
    x, w, b, h = (torch.from_numpy(a) for a in upscale_inputs(np.random.default_rng(0),
                                                              1, 2, 2, 16, 8, 1))
    with pytest.raises(RuntimeError, match="no backward"):
        fused_upscale2_hyper(x.requires_grad_(True), w, b, h)
    with torch.no_grad():
        assert fused_upscale2_hyper(x, w, b, h).shape == (1, 1, 4, 4)


def meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, device="meta", dtype=dtype)


@pytest.mark.parametrize("C,O,N,B,item", [
    (24, 32, 4, 2, "@K9-shape"), (272, 32, 4, 2, "@K9-shape"), (64, 12, 4, 2, "@K9-shape"),
    (64, 72, 4, 2, "@K9-shape"), (64, 32, 17, 2, "@K9-shape"), (64, 32, 4, 65536, "@K9-shape"),
])
def test_fused_upscale2_hyper_refuses_other_shapes(C, O, N, B, item):
    """Shapes the kernel does not take raise before any launch, naming the
    ROADMAP row that would port them."""
    with pytest.raises(ValueError, match=f"ROADMAP Queue 2, {item}"):
        fused_upscale2_hyper(meta(B, 4, 4, C), meta(C, 2, 2, O), meta(O), meta(B, N, O))


def test_fused_upscale2_hyper_refuses_dtypes_and_layouts():
    x, w, b, h = meta(2, 4, 4, 64), meta(64, 2, 2, 32), meta(32), meta(2, 4, 32)
    f16, bf16 = torch.float16, torch.bfloat16
    with pytest.raises(TypeError, match="@fp16"):
        fused_upscale2_hyper(meta(2, 4, 4, 64, dtype=f16), w, b, meta(2, 4, 32, dtype=f16))
    with pytest.raises(TypeError, match="all of one dtype"):
        fused_upscale2_hyper(meta(2, 4, 4, 64, dtype=bf16), w, b, h)
    with pytest.raises(ValueError, match="w must be"):
        fused_upscale2_hyper(x, meta(64, 4, 32), b, h)
    with pytest.raises(ValueError, match="contiguous"):
        fused_upscale2_hyper(meta(2, 4, 64, 4).transpose(2, 3), w, b, h)
    # a shape the kernel takes, on a device without one
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_upscale2_hyper(x, w, b, h)


def test_add_layer_norm_refuses_devices_without_a_kernel():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        add_layer_norm(meta(4, 128), meta(4, 128), meta(128), meta(128))


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in full fp32
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def counts(fn):
    return fn.launches, fn.launches_fp32


def one_more(before, dtype):
    return (before[0] + (dtype == torch.bfloat16), before[1] + (dtype == torch.float32))


DTYPES = [torch.bfloat16, torch.float32]
DT_IDS = ["bf16", "fp32"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("rows,C", [(16 * 576, 768), (8 * 4096, 256), (1001, 1152), (21, 96)])
def test_add_layer_norm_kernel_matches_plain(cuda_device, rows, C, dtype):
    """K5's shapes (the towers', the SAM decoder's, SO400M's; ragged rows)
    and a shape cor_tpu sends to XLA (C 96): one launch per call; fp32 at
    1e-5, bf16 within one bf16 rounding of the output."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (2 * torch.randn(rows, C, generator=g, device=cuda_device) + 0.5).to(dtype)
    y = torch.randn(rows, C, generator=g, device=cuda_device).to(dtype)
    s = 1 + 0.1 * torch.randn(C, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(C, generator=g, device=cuda_device)
    before = counts(add_layer_norm)
    got = add_layer_norm(x, y, s, b)
    torch.cuda.synchronize()
    assert counts(add_layer_norm) == one_more(before, dtype)
    want = add_layer_norm_plain(x, y, s, b)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert rel_err(got.float().cpu(), want.float().cpu()) <= BF16_REL


@pytest.mark.gpu
def test_add_layer_norm_kernel_takes_mixed_input_dtypes(cuda_device):
    """x bf16 with y fp32, and bf16 scale and bias: the output in x's
    dtype, the sum in fp32."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(300, 768, generator=g, device=cuda_device).bfloat16()
    y = torch.randn(300, 768, generator=g, device=cuda_device)
    s, b = (torch.randn(768, generator=g, device=cuda_device).bfloat16() for _ in range(2))
    got = add_layer_norm(x, y, s, b)
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float().cpu(), add_layer_norm_plain(x, y, s, b).float().cpu()) <= BF16_REL
    got32 = add_layer_norm(y, x, s, b)
    torch.testing.assert_close(got32, add_layer_norm_plain(y, x, s, b), **TOL)


@pytest.mark.gpu
def test_add_layer_norm_kernel_backward_is_the_plain_versions(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    leaves = [torch.randn(*shape, generator=g, device=cuda_device)
              for shape in ((512, 256), (512, 256), (256,), (256,))]
    dout = torch.randn(512, 256, generator=g, device=cuda_device)
    grads = []
    for fn in (add_layer_norm, add_layer_norm_plain):
        ts = [t.clone().requires_grad_(True) for t in leaves]
        before = counts(add_layer_norm)
        out = fn(*ts)
        assert counts(add_layer_norm)[1] == before[1] + (fn is add_layer_norm)
        grads.append(torch.autograd.grad(out, ts, dout))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.gpu
def test_layer_norm_kernel_unchanged_beside_add_layer_norm(cuda_device):
    """K5 and K5′ share one templated kernel: K5′ with y = 0 is K5."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(4096, 256, generator=g, device=cuda_device).bfloat16()
    s, b = torch.randn(256, generator=g, device=cuda_device), torch.zeros(256, device=cuda_device)
    assert torch.equal(add_layer_norm(x, torch.zeros_like(x), s, b), layer_norm(x, s, b))


K9_CARD_SHAPES = [(2, 8, 8, 64, 32, 3), (40, 128, 128, 64, 32, 4), (40, 128, 128, 64, 32, 1),
                  (3, 5, 100, 64, 32, 4), (2, 7, 48, 16, 8, 1), (2, 9, 9, 256, 64, 16),
                  (1, 3, 1, 32, 16, 2)]
K9_CARD_IDS = ["oracle", "decoder-n4", "decoder-n1", "w100", "w48-min", "max", "w1"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("shape", K9_CARD_SHAPES, ids=K9_CARD_IDS)
def test_fused_upscale2_hyper_kernel_matches_plain(cuda_device, shape, dtype):
    """The oracle's shape, the decoder's (x [40, 128, 128, 64], O 32, N 4
    and 1), ragged tiles (W 100: a 64-column tile and a 36-column one; W
    48: 48 of 64 rows; W 1) and the largest C, O and N: one launch per
    call, fp32 and bf16 at 1e-4."""
    B, H, W, C, O, N = shape
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(B, H, W, C, generator=g, device=cuda_device).to(dtype)
    w = 0.1 * torch.randn(C, 2, 2, O, generator=g, device=cuda_device)
    b = 0.1 * torch.randn(O, generator=g, device=cuda_device)
    h = torch.randn(B, N, O, generator=g, device=cuda_device).to(dtype)
    before = counts(fused_upscale2_hyper)
    got = fused_upscale2_hyper(x, w, b, h)
    torch.cuda.synchronize()
    assert counts(fused_upscale2_hyper) == one_more(before, dtype)
    assert got.shape == (B, N, 2 * H, 2 * W) and got.dtype == torch.float32
    torch.testing.assert_close(got, fused_upscale2_hyper_plain(x, w, b, h), **K9_TOL)


@pytest.mark.gpu
def test_fused_upscale2_hyper_kernel_refuses_autograd(cuda_device):
    x = torch.randn(1, 4, 4, 64, device=cuda_device, requires_grad=True)
    w, b, h = (torch.randn(*s, device=cuda_device) for s in ((64, 2, 2, 32), (32,), (1, 3, 32)))
    before = counts(fused_upscale2_hyper)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_upscale2_hyper(x, w, b, h)
    assert counts(fused_upscale2_hyper) == before


# ---------------------------------------------------------------------------
# P6 on the card: fp32 convolutions in full fp32 under torch's defaults
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_fp32_convolutions_under_default_flags_match_the_cpu():
    """The fp32 SAM neck (conv2d 1x1 and 3x3 at SAM-base's widths) and the
    decoder's upscale (sam_decoder._conv_transpose_2x), forward and backward,
    under torch's default cuDNN flags (TF32 allowed), against the CPU: the
    outputs at cor_tpu's fp32 decoder tolerance (atol = rtol = 1e-4,
    tests/test_pallas_kernels.py:80), the gradients (sums over 8,192
    positions, some elements cancelling to near 0) at max |d| / max |cpu| <=
    1e-5. With TF32 both miss: 3e-4 to 5e-4 of max |cpu| (chip_smoke.py phase
    38). No warning; the flag is left as found."""
    import warnings

    from cor_tpu_torch.models.sam_decoder import ConvTranspose2x, _conv_transpose_2x
    from cor_tpu_torch.ops.common import conv2d

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert torch.backends.cudnn.allow_tf32  # torch's default: TF32 convolutions allowed
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 64, 64, 768, generator=g)
    w1 = torch.randn(256, 768, 1, 1, generator=g) / 768 ** 0.5
    w2 = torch.randn(256, 256, 3, 3, generator=g) / 48
    up = ConvTranspose2x(256, 64)
    with torch.no_grad():
        up.w.copy_(torch.randn(256, 2, 2, 64, generator=g) / 16)
        up.b.copy_(0.1 * torch.randn(64, generator=g))

    def run(device):
        xs = x.to(device).requires_grad_(True)
        ws = [w.to(device).requires_grad_(True) for w in (w1, w2)]
        mod = ConvTranspose2x(256, 64).to(device)
        mod.load_state_dict(up.state_dict())
        neck = conv2d(conv2d(xs, ws[0]), ws[1], padding=1)
        u = _conv_transpose_2x(mod, neck)
        grads = torch.autograd.grad(u.square().sum(), [xs, *ws, mod.w])
        return [t.detach().cpu() for t in (neck, u, *grads)]

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = run(torch.device("cuda"))
    assert torch.backends.cudnn.allow_tf32
    want = run(torch.device("cpu"))
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    for a, b in zip(got[2:], want[2:]):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-5
