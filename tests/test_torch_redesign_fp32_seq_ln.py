"""The fp32 sequence attention (K4@fp32, K4′@fp32) and the LayerNorm (K5, K5′)
redesigned for Hopper.

A CUDA kernel cannot run on the CPU, so these tests hold numpy emulations of
the two new designs' arithmetic against ``cor_tpu``'s kernels (Pallas
interpret mode, or its XLA fallback, as ``cor_tpu``'s own tests run them):

- K5 and K5′ sum in the new order: lane l owns the 16-byte chunks l, l + 32,
  ... of a row (8 bf16 or 4 fp32 values each; one value in the scalar
  instantiation) and adds its values in fp32 in order, then a butterfly of
  shuffles adds the lanes; fp32 within 1e-5 of ``layer_norm_pallas`` and
  ``add_layer_norm_pallas``, bf16 within one bf16 ulp of their fp32 result;
- K4/K4′ in fp32 as the new kernel computes: 64-key tiles, the online
  softmax in the log2 domain, every product in 3xTF32 (round-to-nearest,
  ties away, TF32 halves; small·small dropped) with P's halves split as the
  kernel splits them, within 1e-5 of ``attention_seq_qkv_pallas`` and
  ``attention_seq_pallas`` in fp32;
- ``tools/kernel_bits.py`` lists the new timed cases and the fp32 towers.

The tests marked ``gpu`` hold the kernels against their plain versions on
the card (launch counts included):

    python -m pytest tests/test_torch_redesign_fp32_seq_ln.py -m gpu --noconftest
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.kernels.layernorm import (
    add_layer_norm,
    add_layer_norm_plain,
    layer_norm,
    layer_norm_plain,
)
from cor_tpu_torch.ops.kernels.seq_attention import (
    attention_seq,
    attention_seq_plain,
    attention_seq_qkv,
    attention_seq_qkv_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)  # cor_tpu's fp32 kernel tolerance (K5, K4/K4′)
BF16_TOL = dict(atol=2e-2, rtol=0)  # the bf16 LayerNorm's: one ulp at |y| < 4
F32 = np.float32
_STARTED = []  # when this file's first test began


@pytest.fixture(autouse=True, scope="module")
def _file_clock():
    _STARTED.append(time.perf_counter())
    yield


# ---------------------------------------------------------------------------
# emulations of the new designs (numpy, fp32 arithmetic)
# ---------------------------------------------------------------------------


def bf16_round(x: np.ndarray) -> np.ndarray:
    """fp32 -> the nearest bf16 (ties to even), as fp32."""
    return torch.from_numpy(np.ascontiguousarray(x, F32)).to(torch.bfloat16).float().numpy()


def butterfly(parts: np.ndarray) -> np.ndarray:
    """[..., 32] lanes' fp32 partials -> the sum every lane holds after the
    shuffles xor 16, 8, 4, 2, 1."""
    lanes = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        parts = (parts + parts[..., lanes ^ off]).astype(F32)
    return parts[..., 0]


def ln_emulated(x, scale, bias, eps, vec, y=None):
    """LayerNorm of x [rows, C] (fp32 values; + y, summed in fp32) as the
    redesigned kernel sums: lane l owns chunks l, l + 32, ... of ``vec``
    values; each lane adds its values in order, then the butterfly; y =
    (v - mean) * rstd * scale + bias, in fp32."""
    v = np.asarray(x, F32) if y is None else (np.asarray(x, F32) + np.asarray(y, F32))
    rows, C = v.shape
    chunks = C // vec
    items = -(-chunks // 32)
    pad = np.zeros((rows, items * 32 * vec), F32)
    pad[:, :C] = v
    vals = pad.reshape(rows, items, 32, vec)
    ch = np.arange(items)[:, None] * 32 + np.arange(32)[None, :]
    valid = (ch < chunks)[None, :, :, None] & np.ones((1, 1, 1, vec), bool)
    acc = np.zeros((rows, 32), F32)
    for i in range(items):
        for e in range(vec):
            acc = np.where(valid[:, i, :, e], acc + vals[:, i, :, e], acc).astype(F32)
    mean = (butterfly(acc) / F32(C)).astype(F32)[:, None]
    acc = np.zeros((rows, 32), F32)
    for i in range(items):
        for e in range(vec):
            d = (vals[:, i, :, e] - mean).astype(F32)
            acc = np.where(valid[:, i, :, e], acc + d * d, acc).astype(F32)
    var = (butterfly(acc) / F32(C)).astype(F32)
    rstd = (F32(1) / np.sqrt(var + F32(eps), dtype=F32)).astype(F32)[:, None]
    n = ((v - mean) * rstd).astype(F32)
    return (n * np.asarray(scale, F32) + np.asarray(bias, F32)).astype(F32)


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: round to a 10-bit mantissa, ties away from zero."""
    b = np.ascontiguousarray(x, F32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(F32)


def mm_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a [M, K] . b [K, N] in 3xTF32: small.big + big.small, then + big.big,
    each product summed in float64 and rounded to fp32."""
    ab, bb = tf32_rna(a), tf32_rna(b)
    as_, bs = tf32_rna(a - ab), tf32_rna(b - bb)
    f64 = np.float64
    small = (as_.astype(f64) @ bb.astype(f64)).astype(F32) + \
        (ab.astype(f64) @ bs.astype(f64)).astype(F32)
    return (small.astype(F32) + (ab.astype(f64) @ bb.astype(f64)).astype(F32)).astype(F32)


def attention_emulated(q, k, v):
    """softmax(q k^T / sqrt(D)) v of one head (q, k, v [N, D] fp32) as the
    redesigned kernel computes it: 64-key tiles, the online softmax in the
    log2 domain, products in 3xTF32, P unrounded."""
    N, D = q.shape
    scale_log2 = F32(1.4426950408889634 / np.sqrt(np.float32(D)))
    m = np.full((N, 1), -np.inf, F32)
    lsum = np.zeros((N, 1), F32)
    o = np.zeros((N, D), F32)
    for k0 in range(0, N, 64):
        kt, vt = k[k0:k0 + 64], v[k0:k0 + 64]
        s = (mm_3xtf32(q, kt.T) * scale_log2).astype(F32)
        m_new = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp2(m - m_new).astype(F32)
        p = np.exp2(s - m_new).astype(F32)
        lsum = (lsum * alpha + p.sum(axis=1, keepdims=True, dtype=F32)).astype(F32)
        o = (o * alpha + mm_3xtf32(p, vt)).astype(F32)
        m = m_new
    return (o * (F32(1) / lsum)).astype(F32)


# ---------------------------------------------------------------------------
# on the CPU: the emulations against cor_tpu's kernels
# ---------------------------------------------------------------------------


def ln_inputs(seed, C, rows=64, add=False):
    rng = np.random.default_rng(seed)
    x = (2 * rng.standard_normal((rows, C)) + 0.5).astype(F32)
    s = (1 + 0.1 * rng.standard_normal(C)).astype(F32)
    b = (0.1 * rng.standard_normal(C)).astype(F32)
    y = rng.standard_normal((rows, C)).astype(F32) if add else None
    return x, s, b, y


def cor_tpu_ln(x, s, b, y=None):
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import add_layer_norm_pallas, layer_norm_pallas

    if y is None:
        return np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                            eps=1e-6))
    return np.asarray(add_layer_norm_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
                                            jnp.asarray(b), eps=1e-6))


def within_bf16_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """|got - want| within one bf16 ulp at |want| (8 significant bits) beyond
    the fp32 tolerance (which sets the bound where |want| is near 0)."""
    e = np.floor(np.log2(np.maximum(np.abs(want), np.finfo(F32).tiny)))
    ulp = np.exp2(e - 7)
    return bool(np.all(np.abs(got - want) <= ulp + TOL["atol"] + TOL["rtol"] * np.abs(want)))


LN_COLS = [256, 768, 1152, 1280, 100]


@pytest.mark.parametrize("add", [False, True], ids=["K5", "K5'"])
@pytest.mark.parametrize("C", LN_COLS)
def test_layer_norm_new_sum_order_matches_cor_tpu(C, add):
    """fp32 (4 values a chunk; C 100 too) and the scalar instantiation (one
    value a lane, lane-strided: a misaligned tensor) within 1e-5 of cor_tpu;
    bf16 inputs and weights (8 values a chunk where C % 8 == 0, else the
    scalar case), the output rounded once, within one bf16 ulp (beyond the
    fp32 tolerance) of cor_tpu's fp32 result on the same values."""
    x, s, b, y = ln_inputs(C, C, add=add)
    want = cor_tpu_ln(x, s, b, y)
    for vec in (4, 1):
        np.testing.assert_allclose(ln_emulated(x, s, b, 1e-6, vec, y), want, **TOL)
    xb, sb, bb = bf16_round(x), bf16_round(s), bf16_round(b)
    yb = None if y is None else bf16_round(y)
    want_b = cor_tpu_ln(xb, sb, bb, yb)
    vec = 8 if C % 8 == 0 else 1
    got_b = bf16_round(ln_emulated(xb, sb, bb, 1e-6, vec, yb))
    assert within_bf16_ulp(got_b, want_b), C
    # fp32 y beside bf16 x (K5′'s mixed widths): the sum in fp32, unrounded
    if add:
        got_m = bf16_round(ln_emulated(xb, sb, bb, 1e-6, vec, y))
        want_m = cor_tpu_ln(xb, sb, bb, y)
        assert within_bf16_ulp(got_m, want_m), C


def test_layer_norm_plain_is_the_oracle_of_the_emulation():
    """The plain version (the kernels' oracle on the card) and the emulation
    of the new order agree to 1e-5 in fp32 at a sam_huge-wide row."""
    x, s, b, y = ln_inputs(7, 1280, rows=16, add=True)
    t = [torch.from_numpy(a) for a in (x, s, b, y)]
    np.testing.assert_allclose(ln_emulated(x, s, b, 1e-6, 4),
                               layer_norm_plain(t[0], t[1], t[2], 1e-6).numpy(), **TOL)
    np.testing.assert_allclose(ln_emulated(x, s, b, 1e-6, 4, y),
                               add_layer_norm_plain(t[0], t[3], t[1], t[2], 1e-6).numpy(), **TOL)


@pytest.fixture(scope="module")
def cor_tpu_attention():
    """cor_tpu's two K4 entries in fp32 (jitted once per shape)."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.seq_attention import attention_seq_pallas, attention_seq_qkv_pallas

    def fused(qkv, heads):
        return np.asarray(attention_seq_qkv_pallas(jnp.asarray(qkv), num_heads=heads))

    def bhnd(q, k, v, heads):
        return np.asarray(attention_seq_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                               heads))

    return fused, bhnd


@pytest.mark.parametrize("D", [64, 72])
@pytest.mark.parametrize("N", [729, 64, 5])
def test_fp32_attention_as_the_kernel_computes_matches_cor_tpu(cor_tpu_attention, N, D):
    """Both entries: qkv [1, N, 3C] (2 heads) through attention_seq_qkv_pallas,
    and its [B, H, N, D] split through attention_seq_pallas, against the
    emulation of the 3xTF32 kernel, at 1e-5."""
    fused, bhnd = cor_tpu_attention
    heads, C = 2, 2 * D
    rng = np.random.default_rng(N + D)
    qkv = rng.standard_normal((1, N, 3 * C)).astype(F32)
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(1, N, heads, D).transpose(0, 2, 1, 3)
               for i in range(3))
    emu = np.stack([attention_emulated(q[0, h], k[0, h], v[0, h]) for h in range(heads)])[None]
    np.testing.assert_allclose(emu, bhnd(*(np.ascontiguousarray(t) for t in (q, k, v)), heads),
                               **TOL)
    np.testing.assert_allclose(emu.transpose(0, 2, 1, 3).reshape(1, N, C), fused(qkv, heads),
                               **TOL)


def test_3xtf32_split_keeps_fp32_accuracy():
    """The emulated products (rna halves, small·small dropped) stay within
    2^-20 relative of float64 on unit-scale operands, where one TF32 product
    alone misses by ~1e-3."""
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((64, 72)).astype(F32), rng.standard_normal((72, 64)).astype(F32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    assert np.max(np.abs(mm_3xtf32(a, b) - exact) / scale) < 2.0**-20
    one = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64)
    assert np.max(np.abs(one - exact) / scale) > 2.0**-14


def test_kernel_bits_lists_the_new_timed_cases_and_the_fp32_towers():
    """tools/kernel_bits.py --time: K4@fp32 at ViT-B's 64 and K4′@fp32 at
    SO400M's 72, vision and text, through both entries; K5 and K5′ at the
    five main-path shapes in bf16 and fp32; the towers' query encode in fp32
    beside bf16 at buckets 1, 4 and 16. K5 and K5′ leave the bit-for-bit
    list for the timed one."""
    from cor_tpu_torch.tools import kernel_bits as kb

    labels = [label for label, _ in kb.timed_cases("cpu")]
    assert len(labels) == len(set(labels))
    for n in (576, 64):
        assert f"K4@fp32 d64 [16, {n}, 2304]" in labels
        assert f"K4′@fp32 [B, H, N, D] d64 [16, 12, {n}, 64]" in labels
    for n in (729, 64):
        assert f"K4@fp32 d72 [16, {n}, 3456]" in labels
        assert f"K4′@fp32 [B, H, N, D] d72 [16, 16, {n}, 72]" in labels
    for shape in ("[9216, 768]", "[32768, 768]", "[32768, 256]", "[11664, 1152]",
                  "[32768, 1280]"):
        for kind in ("K5", "K5@fp32", "K5′", "K5′@fp32"):
            assert f"{kind} {shape}" in labels
    towers = [label for label, _ in kb.tower_cases("meta")]
    for name in ("ViT-B-16-SigLIP-384", "ViT-SO400M-14-SigLIP-384"):
        for b in (1, 4, 16):
            assert f"query encode {name} bucket {b}" in towers
            assert f"query encode {name} fp32 bucket {b}" in towers
    assert {"cor_layer_norm", "cor_add_layer_norm"} <= set(kb._TIMED)
    assert not {"cor_layer_norm", "cor_add_layer_norm"} & set(kb._COMPARED)
    assert not {"cor_layer_norm", "cor_add_layer_norm"} & set(kb._OPTIONAL)


def test_this_file_reports_its_time():
    """The CPU tests above (the emulations and cor_tpu's graphs) report
    their time: about half a minute alone, the minute this file may add to a
    tier-1 run at most."""
    took = time.perf_counter() - _STARTED[0]
    print(f"tests/test_torch_redesign_fp32_seq_ln.py CPU tests: {took:.1f} s")
    assert 0 < took < 300


# ---------------------------------------------------------------------------
# on the card: the redesigned kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def fp32_device(cuda_device):
    """The card with torch's fp32 matmuls and convolutions in full fp32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["qkv", "bhnd"])
@pytest.mark.parametrize("D", [64, 72, 80])
@pytest.mark.parametrize("N", [729, 576, 100, 64, 5, 1])
def test_fp32_seq_attention_matches_plain(fp32_device, N, D, entry):
    """K4@fp32 / K4′@fp32 (3xTF32 on wgmma) against the plain fp32 version
    with TF32 off, at 1e-5, through both entries; one launch each."""
    heads, C = 4, 4 * D
    g = torch.Generator(device=fp32_device).manual_seed(N * 100 + D)
    qkv = torch.randn(2, N, 3 * C, generator=g, device=fp32_device)
    if entry == "qkv":
        fn, args, plain = attention_seq_qkv, (qkv, heads), attention_seq_qkv_plain
    else:
        fn, plain = attention_seq, attention_seq_plain
        args = (*(qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                  .contiguous() for i in range(3)), heads)
    before = fn.launches_fp32
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches_fp32 == before + 1
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    torch.testing.assert_close(got, plain(*args), **TOL)


# K5's main-path shapes and ragged widths (rows 1 and 1001)
LN_SHAPES = [(9216, 768), (32768, 768), (32768, 256), (11664, 1152), (32768, 1280),
             (1, 1), (1001, 1), (1, 100), (1001, 100), (1, 257), (1001, 257), (1, 2048),
             (1001, 2048)]
LN_IDS = [f"{r}x{c}" for r, c in LN_SHAPES]


def ln_card_inputs(device, rows, C, dtype, w_dtype, y_dtype=None, misalign=False):
    g = torch.Generator(device=device).manual_seed(rows + C)
    rnd = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    x = (2 * rnd(rows, C) + 0.5).to(dtype)
    if misalign:  # a view one element into its storage: not 16-byte aligned
        buf = torch.empty(rows * C + 1, dtype=dtype, device=device)
        buf[1:] = x.flatten()
        x = buf[1:].view(rows, C)
        assert x.is_contiguous() and x.data_ptr() % 16 != 0
    s, b = (1 + 0.1 * rnd(C)).to(w_dtype), (0.1 * rnd(C)).to(w_dtype)
    y = None if y_dtype is None else rnd(rows, C).to(y_dtype)
    return x, s, b, y


def ln_close(got, want, dtype):
    """fp32 at 1e-5; bf16 at 2e-2 (one ulp at |y| < 4), or one bf16 ulp of
    the plain value where that is larger: the two round one fp32 value each,
    summed in other orders, so a value next to a rounding boundary may land
    one ulp apart."""
    assert got.dtype == dtype and torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
        return
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
    excess = (g - w).abs() - torch.clamp(ulp, min=BF16_TOL["atol"])
    assert excess.max().item() <= 0, (excess.max().item(), (excess > 0).sum().item())


DTYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
          (torch.float32, torch.float32), (torch.float32, torch.bfloat16)]
DTYPE_IDS = ["bf16", "bf16-w32", "fp32", "fp32-wbf16"]


@pytest.mark.gpu
@pytest.mark.parametrize("misalign", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype,w_dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("rows,C", LN_SHAPES, ids=LN_IDS)
def test_layer_norm_kernel_matches_plain(fp32_device, rows, C, dtype, w_dtype, misalign):
    """K5 in both dtypes and weight dtypes: the vector instantiation at whole
    16-byte rows, the scalar one at ragged C or a misaligned view; one
    launch each, counted by x's dtype."""
    x, s, b, _ = ln_card_inputs(fp32_device, rows, C, dtype, w_dtype, misalign=misalign)
    count = "launches_fp32" if dtype == torch.float32 else "launches"
    before = getattr(layer_norm, count)
    got = layer_norm(x, s, b, 1e-6)
    torch.cuda.synchronize()
    assert getattr(layer_norm, count) == before + 1
    ln_close(got, layer_norm_plain(x, s, b, 1e-6), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("misalign", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("y_dtype", [torch.bfloat16, torch.float32], ids=["ybf16", "y32"])
@pytest.mark.parametrize("dtype,w_dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("rows,C", LN_SHAPES, ids=LN_IDS)
def test_add_layer_norm_kernel_matches_plain(fp32_device, rows, C, dtype, w_dtype, y_dtype,
                                             misalign):
    """K5′ (the sum in fp32, unrounded) at the same shapes, with y in either
    dtype beside x; one launch each."""
    x, s, b, y = ln_card_inputs(fp32_device, rows, C, dtype, w_dtype, y_dtype, misalign)
    count = "launches_fp32" if dtype == torch.float32 else "launches"
    before = getattr(add_layer_norm, count)
    got = add_layer_norm(x, y, s, b, 1e-6)
    torch.cuda.synchronize()
    assert getattr(add_layer_norm, count) == before + 1
    ln_close(got, add_layer_norm_plain(x, y, s, b, 1e-6), dtype)
