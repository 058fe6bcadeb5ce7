"""The fp32 SAM ViT attention (K6@fp32, K7@fp32) redesigned for Hopper:
3xTF32 on wgmma, 128-row blocks, the bias of the global blocks' key columns
in registers, the lse that K6b@fp32 reads.

A CUDA kernel cannot run on the CPU, so these tests hold a numpy emulation
of the new kernel's arithmetic against ``cor_tpu``'s kernels in fp32
(Pallas interpret mode, as ``cor_tpu``'s own tests run them):

- q * scale in fp32; S = (q * scale) k^T over 64-key tiles in 3xTF32 (rna
  TF32 halves, small·big + big·small + big·big, small·small dropped); the
  bias added as (s + rel_h[i, j // W]) + rel_w[i, j % W]; keys past N
  masked; the online softmax in fp32 in the log2 domain; P unrounded, split
  into its halves for P·V in 3xTF32; the division by the row sum once at
  the end; the lse (m + log2 l) * ln 2;
- K6 (``vit_attention_relpos_pallas``) on 8 x 8 and 5 x 13 grids and a 14 x
  14 window, at head_dim 64 and 80 (cor_tpu's lane-pad shim at 80), at
  cor_tpu's K6 tolerance 2e-4; the emulated lse against the log-sum-exp of
  cor_tpu's fp32 logits;
- K7 over the windows of a 28 x 28 grid cropped to 25 x 27, each window's
  tokens read by strides as the kernel reads them: against cor_tpu's
  ``vit_attention_relpos_windows_pallas`` at 64, and at 80 (where cor_tpu's
  K7 takes no lane-padded head) against its K6 on the partitioned windows;
- ``tools/kernel_bits.py`` lists K7@fp32 and the fp32 image encode.

The tests marked ``gpu`` hold the kernel against its plain version on the
card (TF32 off), with launch counts, the same bits with and without the
lse, and K6b@fp32 from the new statistics:

    python -m pytest tests/test_torch_redesign_fp32_vit.py -m gpu --noconftest
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.kernels import vit_attention as va
from cor_tpu_torch.ops.kernels.vit_attention import (
    vit_attention_relpos,
    vit_attention_relpos_bwd,
    vit_attention_relpos_bwd_plain,
    vit_attention_relpos_plain,
    vit_attention_relpos_windows,
    vit_attention_relpos_windows_plain,
    vit_attention_relpos_with_lse,
)

TOL = dict(atol=2e-4, rtol=2e-4)  # cor_tpu's fp32 K6/K7 tolerance
LSE_TOL = dict(atol=2e-5, rtol=0)
FP32_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)  # cor_tpu's fp32 K6b tolerance
F32 = np.float32
LOG2E = F32(1.4426950408889634)
LN2 = F32(0.6931471805599453)
_STARTED = []  # when this file's first test began


@pytest.fixture(autouse=True, scope="module")
def _file_clock():
    _STARTED.append(time.perf_counter())
    yield


# ---------------------------------------------------------------------------
# the emulation of the new kernel (numpy, fp32 arithmetic)
# ---------------------------------------------------------------------------


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


def head_emulated(q, k, v, rh, rw, W):
    """One (image or window, head) as the kernel computes it: q, k, v [N, D],
    rh [N, H], rw [N, W] fp32 -> (out [N, D], lse [N])."""
    N, D = q.shape
    qs = (q * F32(D**-0.5)).astype(F32)
    keys = np.arange(-(-N // 64) * 64)
    jh, jw = keys // W, keys % W
    m = np.full((N, 1), -np.inf, F32)
    lsum = np.zeros((N, 1), F32)
    o = np.zeros((N, D), F32)
    for k0 in range(0, N, 64):
        kt = np.zeros((64, D), F32)
        vt = np.zeros((64, D), F32)
        n = min(64, N - k0)
        kt[:n], vt[:n] = k[k0:k0 + n], v[k0:k0 + n]
        s = mm_3xtf32(qs, kt.T)
        tile = slice(k0, k0 + 64)
        valid = keys[tile] < N
        bh = rh[:, np.minimum(jh[tile], rh.shape[1] - 1)]
        bw = rw[:, jw[tile]]
        s = np.where(valid[None, :], ((s + bh).astype(F32) + bw).astype(F32) * LOG2E,
                     -np.inf).astype(F32)
        m_new = np.maximum(m, s.max(axis=1, keepdims=True))
        alpha = np.exp2(m - m_new).astype(F32)
        p = np.exp2(s - m_new).astype(F32)
        lsum = (lsum * alpha + p.sum(axis=1, keepdims=True, dtype=F32)).astype(F32)
        o = (o * alpha + mm_3xtf32(p, vt)).astype(F32)
        m = m_new
    lse = ((m[:, 0] + np.log2(lsum[:, 0])) * LN2).astype(F32)
    return (o * (F32(1) / lsum)).astype(F32), lse


def k6_emulated(qkv, rel_h, rel_w, heads, hw):
    """K6@fp32: qkv [B, N, 3C], rel_h [B, heads, N, H], rel_w [B, heads, N,
    W] -> (out [B, N, C], lse [B, heads, N])."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    out = np.zeros((B, N, C), F32)
    lse = np.zeros((B, heads, N), F32)
    for b in range(B):
        for h in range(heads):
            q, k, v = (qkv[b, :, i * C + h * D:i * C + (h + 1) * D] for i in range(3))
            out[b, :, h * D:(h + 1) * D], lse[b, h] = head_emulated(
                q, k, v, rel_h[b, h], rel_w[b, h], hw[1])
    return out, lse


def k7_emulated(qkv, rel_h, rel_w, heads, ws, hw):
    """K7@fp32 as the kernel addresses it: qkv [B, Hp, Wp, 3C], the factors
    [B, heads, Hp * Wp, ws]; token i of window (wi, wj) read at grid row wi
    ws + i // ws, column wj ws + i % ws; written into the grid cropped to
    hw, the pad rows and columns dropped."""
    B, Hp, Wp, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    H, W = hw
    out = np.zeros((B, H, W, C), F32)
    i = np.arange(ws * ws)
    for b in range(B):
        for wi in range(Hp // ws):
            for wj in range(Wp // ws):
                y, x = wi * ws + i // ws, wj * ws + i % ws
                rows = qkv[b, y, x]  # [ws * ws, 3C]: by strides
                keep = (y < H) & (x < W)
                for h in range(heads):
                    q, k, v = (rows[:, j * C + h * D:j * C + (h + 1) * D] for j in range(3))
                    o, _ = head_emulated(q, k, v, rel_h[b, h, y * Wp + x],
                                         rel_w[b, h, y * Wp + x], ws)
                    out[b, y[keep], x[keep], h * D:(h + 1) * D] = o[keep]
    return out


# ---------------------------------------------------------------------------
# on the CPU: the emulation against cor_tpu's kernels
# ---------------------------------------------------------------------------


def k6_inputs(seed, B, H, W, heads=2, D=64):
    rng = np.random.default_rng(seed)
    N, C = H * W, heads * D
    return (rng.standard_normal((B, N, 3 * C)).astype(F32),
            (0.3 * rng.standard_normal((B, heads, N, H))).astype(F32),
            (0.3 * rng.standard_normal((B, heads, N, W))).astype(F32))


def indicators(H, W):
    n = np.arange(H * W)
    return ((np.arange(H)[:, None] == (n // W)[None, :]).astype(F32),
            (np.arange(W)[:, None] == (n % W)[None, :]).astype(F32))


@pytest.fixture(scope="module")
def cor_tpu_k6():
    """cor_tpu's K6 in fp32 (Pallas interpret mode), as attention_2d_fused
    calls it: indicator matrices, the true scale, and at head_dim 80 each
    head lane-padded to 128 (cor_tpu's shim)."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.lane_pad import crop_heads, pad_qkv_heads
    from cor_tpu.ops.pallas.vit_attention import vit_attention_relpos_pallas

    def run(qkv, rel_h, rel_w, heads, hw):
        D = qkv.shape[-1] // 3 // heads
        eh, ew = indicators(*hw)
        x = jnp.asarray(qkv)
        if 128 % D:
            x = pad_qkv_heads(x, heads, D)
        out = vit_attention_relpos_pallas(x, jnp.asarray(rel_h), jnp.asarray(rel_w),
                                          jnp.asarray(eh), jnp.asarray(ew), heads,
                                          scale=D**-0.5)
        if 128 % D:
            out = crop_heads(out, heads, D)
        return np.asarray(out)

    return run


@pytest.fixture(scope="module")
def cor_tpu_lse():
    """The log-sum-exp of cor_tpu's fp32 logits (ops/attention.py
    attention_2d's: q * scale against k in fp32, the decomposed bias added
    on the [.., H, W, H, W] view) [B, heads, N]."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def lse(qkv, rel_h, rel_w):
        B, N, C3 = qkv.shape
        heads, H, W = rel_h.shape[1], rel_h.shape[-1], rel_w.shape[-1]
        D = C3 // 3 // heads
        x = qkv.reshape(B, N, 3, heads, D).transpose(2, 0, 3, 1, 4)
        q, k = x[0].reshape(B * heads, N, D), x[1].reshape(B * heads, N, D)
        attn = jnp.einsum("bqd,bkd->bqk", q * D**-0.5, k, preferred_element_type=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST)
        rh = rel_h.reshape(B * heads, H, W, H)
        rw = rel_w.reshape(B * heads, H, W, W)
        attn = attn.reshape(B * heads, H, W, H, W) + rh[..., :, None] + rw[..., None, :]
        return jax.nn.logsumexp(attn.reshape(B, heads, N, N), axis=-1)

    return lambda *xs: np.asarray(lse(*(jnp.asarray(x) for x in xs)))


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("B,H,W", [(2, 8, 8), (1, 5, 13), (2, 14, 14)],
                         ids=["grid8", "rect", "window14"])
def test_k6_emulated_matches_cor_tpu(cor_tpu_k6, cor_tpu_lse, B, H, W, D):
    """K6@fp32 as the new kernel computes it against cor_tpu's K6 in fp32
    (out within 2e-4), and its lse against the log-sum-exp of cor_tpu's fp32
    logits (within 2e-5); the plain version, the kernel's oracle on the card,
    agrees with the emulation within 2e-5."""
    qkv, rel_h, rel_w = k6_inputs(H * W + D, B, H, W, D=D)
    out, lse = k6_emulated(qkv, rel_h, rel_w, 2, (H, W))
    np.testing.assert_allclose(out, cor_tpu_k6(qkv, rel_h, rel_w, 2, (H, W)), **TOL)
    np.testing.assert_allclose(lse, cor_tpu_lse(qkv, rel_h, rel_w), **LSE_TOL)
    t = [torch.from_numpy(a) for a in (qkv, rel_h, rel_w)]
    p_out, p_lse = vit_attention_relpos_plain(*t, 2, (H, W), with_lse=True)
    np.testing.assert_allclose(out, p_out.numpy(), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse, p_lse.numpy(), **LSE_TOL)


def k7_inputs(seed, B, Hp, ws, heads=2, D=64):
    rng = np.random.default_rng(seed)
    C = heads * D
    return (rng.standard_normal((B, Hp, Hp, 3 * C)).astype(F32),
            (0.3 * rng.standard_normal((B, heads, Hp * Hp, ws))).astype(F32),
            (0.3 * rng.standard_normal((B, heads, Hp * Hp, ws))).astype(F32))


def cor_tpu_k7(qkv, rel_h, rel_w, heads, ws, hw, k6):
    """cor_tpu's K7 in fp32 on the port's operands, cropped to hw. Head_dim
    64: ``vit_attention_relpos_windows_pallas`` on its layout (each window
    column group padded to wpad = 16 tokens, the factors' key axis to 32,
    the indicator matrices as attention_2d_fused builds them); head_dim 80
    (which cor_tpu's K7 does not take): its K6 on the partitioned windows,
    the function its fallback computes."""
    B, Hp, Wp, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    H, W = hw
    nwi, nwj = Hp // ws, Wp // ws
    if D == 64:
        import jax.numpy as jnp

        from cor_tpu.ops.pallas.vit_attention import vit_attention_relpos_windows_pallas

        wpad, Kp = -(-ws // 8) * 8, -(-ws // 32) * 32
        x = np.zeros((B, Hp, nwj, wpad, C3), F32)
        x[:, :, :, :ws] = qkv.reshape(B, Hp, nwj, ws, C3)
        f = []
        for r in (rel_h, rel_w):
            fr = np.zeros((B, heads, Hp, nwj, wpad, Kp), F32)
            fr[:, :, :, :, :ws, :ws] = r.reshape(B, heads, Hp, nwj, ws, ws)
            f.append(fr)
        rows, cols = np.divmod(np.arange(ws * wpad), wpad)
        eh = (rows[:, None] == np.arange(Kp)[None, :]).astype(F32)
        ew = (cols[:, None] == np.arange(Kp)[None, :]).astype(F32)
        out = np.asarray(vit_attention_relpos_windows_pallas(
            *(jnp.asarray(a) for a in (x, *f, eh, ew)), heads, ws))
        return out[:, :H, :, :ws].reshape(B, H, Wp, C)[:, :, :W]

    def part(a):
        rest = a.shape[3:]
        return a.reshape(B, nwi, ws, nwj, ws, *rest).swapaxes(2, 3).reshape(
            B * nwi * nwj, ws * ws, *rest)

    fr = [part(r.reshape(B, heads, Hp, Wp, ws).transpose(0, 2, 3, 1, 4)).transpose(0, 2, 1, 3)
          for r in (rel_h, rel_w)]
    out = k6(part(qkv), *fr, heads, (ws, ws))
    out = out.reshape(B, nwi, nwj, ws, ws, C).swapaxes(2, 3).reshape(B, Hp, Wp, C)
    return out[:, :H, :W]


@pytest.mark.parametrize("D", [64, 80])
def test_k7_emulated_by_strides_matches_cor_tpu(cor_tpu_k6, D):
    """K7@fp32 as the new kernel computes it (a window's tokens read by
    strides off the padded grid, written into the cropped grid) over the 14
    x 14 windows of a 28 x 28 grid cropped to 25 x 27, against cor_tpu's K7
    (64) or K6 on the partitioned windows (80) within 2e-4, and against the
    port's plain K7 within 2e-5."""
    qkv, rel_h, rel_w = k7_inputs(D, 1, 28, 14, D=D)
    got = k7_emulated(qkv, rel_h, rel_w, 2, 14, (25, 27))
    np.testing.assert_allclose(got, cor_tpu_k7(qkv, rel_h, rel_w, 2, 14, (25, 27), cor_tpu_k6),
                               **TOL)
    plain = vit_attention_relpos_windows_plain(
        *(torch.from_numpy(a) for a in (qkv, rel_h, rel_w)), 2, 14, (25, 27))
    np.testing.assert_allclose(got, plain.numpy(), atol=2e-5, rtol=2e-5)


def test_kernel_bits_times_k7_at_fp32_and_the_fp32_image_encode():
    """tools/kernel_bits.py --time: K7@fp32 at both encoders' padded grids
    beside K7 in bf16, and the fp32 SAM image encode (K6@fp32's caller) at
    SAM-base batch 1 and 8 and sam_huge batch 1 beside the bf16 one; the
    case lists build nothing until a case is made."""
    from cor_tpu_torch.tools import kernel_bits as kb

    labels = [label for label, _ in kb.timed_cases("cpu")]
    assert len(labels) == len(set(labels))
    for D, C3 in ((64, 2304), (80, 3840)):
        assert f"K7 d{D} [2, 70, 70, {C3}]" in labels
        assert f"K7@fp32 d{D} [2, 70, 70, {C3}]" in labels
    encodes = [label for label, _ in kb.encode_cases("cpu")]
    for name, b in (("sam_base", 1), ("sam_base", 8), ("sam_huge", 1)):
        assert f"image encode {name} batch {b}" in encodes
        assert f"image encode {name} fp32 batch {b}" in encodes
    assert {"cor_vit_attention_relpos", "cor_vit_attention_relpos_windows"} <= set(kb._COMPARED)


def test_this_file_reports_its_time():
    """The CPU tests above (the emulations and cor_tpu's interpret-mode
    kernels) report their time: the minute this file may add to a tier-1
    run at most."""
    took = time.perf_counter() - _STARTED[0]
    print(f"tests/test_torch_redesign_fp32_vit.py CPU tests: {took:.1f} s")
    assert 0 < took < 300


# ---------------------------------------------------------------------------
# on the card: the redesigned kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def fp32_device():
    """The card with torch's fp32 matmuls and convolutions in full fp32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def card_inputs(device, B, H, W, d, seed=11):
    g = torch.Generator(device=device).manual_seed(seed)
    N, heads = H * W, (12 if d == 64 else 16)
    rnd = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    return (rnd(B, N, 3 * heads * d), 0.3 * rnd(B, heads, N, H), 0.3 * rnd(B, heads, N, W),
            rnd(B, N, heads * d), heads)


# the main path's shapes (global [2, 4096], windowed [50, 196]) and ragged
# grids: W = 64 with an odd H (the last block's second warpgroup past N), a
# single key tile, W = 63 with H = 64 (a bias too large for two K/V stages)
GRIDS = [(2, 64, 64), (50, 14, 14), (1, 8, 8), (2, 5, 13), (1, 24, 20), (1, 3, 64),
         (1, 64, 63)]
GRID_IDS = ["global", "windowed", "grid8", "rect", "other", "rows3", "w63"]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", GRIDS, ids=GRID_IDS)
def test_fp32_k6_matches_plain(fp32_device, B, H, W, d):
    """K6@fp32 at head_dim 64 and 80: one fp32 launch each, out within 2e-4
    of the plain version (TF32 off), the same bits with the lse as without,
    the lse within 2e-5 of the plain one."""
    qkv, rel_h, rel_w, _, heads = card_inputs(fp32_device, B, H, W, d)
    args = (qkv, rel_h, rel_w, heads, (H, W))
    before = (vit_attention_relpos.launches, vit_attention_relpos.launches_fp32)
    got = vit_attention_relpos(*args)
    out, lse = vit_attention_relpos_with_lse(*args)
    torch.cuda.synchronize()
    assert (vit_attention_relpos.launches, vit_attention_relpos.launches_fp32) == (
        before[0], before[1] + 2)
    assert torch.equal(got, out)
    want, want_lse = vit_attention_relpos_plain(*args, with_lse=True)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(lse, want_lse, **LSE_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("Hp,hw", [(70, (64, 64)), (28, (25, 27)), (14, (14, 14))],
                         ids=["encoder", "cropped", "one"])
def test_fp32_k7_matches_plain(fp32_device, Hp, hw, d):
    """K7@fp32 at the encoders' padded grid [2, 70, 70, 3C] cropped to 64 x
    64, a 28 x 28 grid cropped to 25 x 27 and a single window: one fp32
    launch, within 2e-4 of the plain version, and within 1e-6 of K6@fp32 on
    the partitioned windows (the same arithmetic)."""
    heads = 12 if d == 64 else 16
    g = torch.Generator(device=fp32_device).manual_seed(5)
    C = heads * d
    qkv = torch.randn(2, Hp, Hp, 3 * C, generator=g, device=fp32_device)
    rel_h, rel_w = (0.3 * torch.randn(2, heads, Hp * Hp, 14, generator=g, device=fp32_device)
                    for _ in range(2))
    args = (qkv, rel_h, rel_w, heads, 14, hw)
    before = vit_attention_relpos_windows.launches_fp32
    got = vit_attention_relpos_windows(*args)
    torch.cuda.synchronize()
    assert vit_attention_relpos_windows.launches_fp32 == before + 1
    torch.testing.assert_close(got, vit_attention_relpos_windows_plain(*args), **TOL)
    part = lambda x: va._partition(x, 14)  # noqa: E731
    rel_win = [part(r.reshape(2, heads, Hp, Hp, 14).permute(0, 2, 3, 1, 4)).transpose(1, 2)
               .contiguous() for r in (rel_h, rel_w)]
    nw = Hp // 14
    k6 = vit_attention_relpos(part(qkv).contiguous(), *rel_win, heads, (14, 14))
    k6 = k6.reshape(2, nw, nw, 14, 14, C).permute(0, 1, 3, 2, 4, 5).reshape(2, Hp, Hp, C)
    torch.testing.assert_close(got, k6[:, :hw[0], :hw[1]], atol=1e-6, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", [(2, 64, 64), (50, 14, 14)], ids=["global", "windowed"])
def test_k6b_fp32_runs_from_the_new_statistics(fp32_device, B, H, W, d):
    """K6b@fp32 given the new forward's out and lse at the main path's
    shapes: dqkv, drel_h and drel_w within atol 1e-5 / rtol 1e-4 of the exact
    plain backward (TF32 off)."""
    qkv, rel_h, rel_w, do, heads = card_inputs(fp32_device, B, H, W, d, seed=17)
    out, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, (H, W))
    got = vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, heads, (H, W), out=out, lse=lse)
    torch.cuda.synchronize()
    want = vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, heads, (H, W))
    for name, a, b in zip(("dqkv", "drel_h", "drel_w"), got, want):
        torch.testing.assert_close(a, b, **FP32_GRAD_TOL, msg=name)
