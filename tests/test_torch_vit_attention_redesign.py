"""The SAM ViT attention kernels redesigned for Hopper: K6/K7 in bf16 (the
rel-pos attention forward, global, windowed and over the windows of a padded
grid) on wgmma, and K6b in fp32 (its backward) from the forward's
statistics.

On the CPU: K6's plain forward in fp32 returns the rows' log-sum-exp of
``cor_tpu``'s fp32 logits; a plain fp32 backward built as the new kernel
computes (a from the saved fp32 lse, delta = rowsum(do * out) over the fp32
out) stays within ``cor_tpu``'s fp32 gradient tolerance (atol 1e-5, rtol
1e-4) of ``cor_tpu``'s flash backward in fp32; ``_VitAttentionRelpos`` hands
out and lse to the backward in fp32 as in bf16; ``tools/kernel_bits.py``
lists the redesigned kernels and K6's end-to-end caller.

The tests marked ``gpu`` hold the new kernels against their plain versions
on the card:

    python -m pytest tests/test_torch_vit_attention_redesign.py -m gpu --noconftest
"""

from __future__ import annotations

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

FP32_GRAD_TOL = dict(atol=1e-5, rtol=1e-4)  # cor_tpu tests/test_kernel_vjp.py, K6b in fp32
DECODE_REL = 2e-2  # max |kernel - plain| / max |plain|: the bf16 kernels' tolerance


def vit_inputs(seed, B, H, W, heads=2, D=64):
    """qkv [B, N, 3C], bias factors [B, heads, N, H|W] (x0.3) and a
    cotangent [B, N, C] fp32 numpy, head_dim D, from ``seed``."""
    rng = np.random.default_rng(seed)
    N, C = H * W, heads * D
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    rel_h = (0.3 * rng.standard_normal((B, heads, N, H))).astype(np.float32)
    rel_w = (0.3 * rng.standard_normal((B, heads, N, W))).astype(np.float32)
    do = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, rel_h, rel_w, do


@pytest.fixture(scope="module")
def xla_lse():
    """cor_tpu's fp32 logits (ops/attention.py attention_2d: q * scale
    against k in fp32, the decomposed bias added on the [.., H, W, H, W]
    view) -> the rows' log-sum-exp [B, heads, N], jitted once per shape."""
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
@pytest.mark.parametrize("H,W", [(8, 8), (5, 13)], ids=["grid8", "rect"])
def test_plain_forward_fp32_lse_matches_cor_tpu_logits(xla_lse, D, H, W):
    """K6's plain forward in fp32 with ``with_lse`` returns the output it
    returns without, and the log-sum-exp of cor_tpu's fp32 logits (natural
    log, fp32, within 1e-5), at SAM-base's head_dim 64 and sam_huge's 80:
    the statistics the fp32 kernel now writes for K6b."""
    qkv, rel_h, rel_w, _ = vit_inputs(D + H, 2, H, W, D=D)
    args = (torch.from_numpy(qkv), torch.from_numpy(rel_h), torch.from_numpy(rel_w), 2, (H, W))
    out, lse = vit_attention_relpos_plain(*args, with_lse=True)
    assert out.dtype == torch.float32 and torch.equal(out, vit_attention_relpos_plain(*args))
    assert lse.shape == (2, 2, H * W) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), xla_lse(qkv, rel_h, rel_w), atol=1e-5, rtol=1e-5)
    out2, lse2 = vit_attention_relpos_with_lse(*args)  # the CPU: the plain version
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


def bwd_from_stats_fp32(qkv, rel_h, rel_w, do, heads, hw, out, lse):
    """The fp32 kernel's backward, plainly: a = exp(l - lse) from the
    forward's fp32 lse (natural log, as the kernel takes it), delta =
    rowsum(do * out) in fp32 over the forward's fp32 out, nothing rounded;
    then the dq pass's correction of both statistics from its own row sums
    (a_sum = rowsum(a), eps = rowsum(dl) / a_sum): dq and the bias gradients
    (less eps times their sums of a) divided by a_sum, dk and dv from lse +
    log(a_sum) and delta + eps."""
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    scale = D**-0.5
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, heads, D).transpose(1, 2)
               for i in range(3))
    qs = q * scale
    logits = (qs @ k.transpose(-1, -2)).reshape(B, heads, N, H, W)
    logits = (logits + rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, heads, N, N)
    dof = do.reshape(B, N, heads, D).transpose(1, 2)
    da = dof @ v.transpose(-1, -2)
    delta = (dof * out.reshape(B, N, heads, D).transpose(1, 2)).sum(-1, keepdim=True)
    a = torch.exp(logits - lse[..., None])
    dl = a * (da - delta)
    a_sum = a.sum(-1, keepdim=True)
    eps = dl.sum(-1, keepdim=True) / a_sum
    dq = (dl @ k) / a_sum * scale
    dl5, a5 = dl.reshape(B, heads, N, H, W), a.reshape(B, heads, N, H, W)
    drel_h = (dl5.sum(-1) - eps * a5.sum(-1)) / a_sum
    drel_w = (dl5.sum(-2) - eps * a5.sum(-2)) / a_sum
    a = torch.exp(logits - (lse[..., None] + torch.log(a_sum)))  # the dk/dv pass's
    dl = a * (da - (delta + eps))
    merge = lambda x: x.transpose(1, 2).reshape(B, N, C)  # noqa: E731
    dqkv = torch.cat([merge(dq), merge(dl.transpose(-1, -2) @ qs),
                      merge(a.transpose(-1, -2) @ dof)], dim=-1)
    return dqkv, drel_h, drel_w


@pytest.fixture(scope="module")
def cor_tpu_bwd_fp32():
    """cor_tpu's flash backward (``_vit_attention_relpos_bwd``, Pallas
    interpret mode) as K6's custom_vjp calls it, fp32, 2 heads of 64,
    jitted once per shape: (dqkv, drel_h, drel_w) as numpy."""
    import functools

    import jax
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.vit_attention import _vit_attention_relpos_bwd

    bwd = jax.jit(functools.partial(_vit_attention_relpos_bwd, num_heads=2, scale=64**-0.5))

    def run(qkv, rel_h, rel_w, do, H, W):
        n = np.arange(H * W)
        eh = (np.arange(H)[:, None] == (n // W)[None, :]).astype(np.float32)
        ew = (np.arange(W)[:, None] == (n % W)[None, :]).astype(np.float32)
        got = bwd(*(jnp.asarray(x) for x in (qkv, rel_h, rel_w, eh, ew, do)))
        return [np.asarray(g) for g in got]

    return run


@pytest.mark.parametrize("H,W", [(8, 8), (14, 14), (5, 13)], ids=["grid8", "window14", "rect"])
def test_fp32_backward_from_saved_stats_matches_cor_tpu(cor_tpu_bwd_fp32, H, W):
    """The redesigned K6b in fp32, computed plainly on the CPU: its backward
    from the forward's fp32 out and lse (delta = rowsum(do * out), both
    corrected by the dq pass's row sums) against
    cor_tpu's fp32 flash backward (exact delta), 2 heads of 64: dqkv, drel_h
    and drel_w within cor_tpu's fp32 gradient tolerance (atol 1e-5, rtol
    1e-4), as the exact plain backward is."""
    xs = vit_inputs(H * W, 2, H, W)
    ts = [torch.from_numpy(x) for x in xs]
    out, lse = vit_attention_relpos_plain(*ts[:3], 2, (H, W), with_lse=True)
    got = bwd_from_stats_fp32(*ts, 2, (H, W), out, lse)
    exact = vit_attention_relpos_bwd_plain(*ts, 2, (H, W))
    want = cor_tpu_bwd_fp32(*xs, H, W)
    for name, g, e, w in zip(("dqkv", "drel_h", "drel_w"), got, exact, want):
        assert g.dtype == e.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, **FP32_GRAD_TOL, err_msg=name)
        np.testing.assert_allclose(e.numpy(), w, **FP32_GRAD_TOL, err_msg=name)


def test_statistics_correction_absorbs_errors_in_out_and_lse():
    """Why the fp32 dq pass corrects the forward's statistics: with out off
    by 1e-3 relative (so delta is off) and lse off by 1e-3, the corrected
    backward still gives the bias gradients, dk and dv of the exact plain
    backward (within 1e-5), and dq within 1e-5 of it where only lse is off,
    while taking the statistics as they are misses them by far more."""
    xs = [torch.from_numpy(x).double() for x in vit_inputs(7, 2, 6, 5)]
    args = (*xs, 2, (6, 5))
    out, lse = vit_attention_relpos_plain(*xs[:3], 2, (6, 5), with_lse=True)
    exact = vit_attention_relpos_bwd_plain(*args)
    noise = torch.from_numpy(np.random.default_rng(8).standard_normal(out.shape))
    bad_out, bad_lse = out * (1 + 1e-3 * noise), lse + 1e-3
    got = bwd_from_stats_fp32(*args, bad_out, bad_lse)
    C = out.shape[-1]
    for name, g, e in (("dk, dv", got[0][..., C:], exact[0][..., C:]),
                       ("drel_h", got[1], exact[1]), ("drel_w", got[2], exact[2])):
        torch.testing.assert_close(g, e, atol=1e-5, rtol=0, msg=name)
    torch.testing.assert_close(bwd_from_stats_fp32(*args, out, bad_lse)[0][..., :C],
                               exact[0][..., :C], atol=1e-5, rtol=0)
    # the statistics as they are: a = exp(l - lse), delta = rowsum(do * out)
    H, W, heads, D = 6, 5, 2, 64
    q, k, v = (xs[0][..., i * C:(i + 1) * C].reshape(2, 30, heads, D).transpose(1, 2)
               for i in range(3))
    logits = ((q * D**-0.5) @ k.transpose(-1, -2)).reshape(2, heads, 30, H, W)
    logits = (logits + xs[1][..., :, None] + xs[2][..., None, :]).reshape(2, heads, 30, 30)
    dof = xs[3].reshape(2, 30, heads, D).transpose(1, 2)
    delta = (dof * bad_out.reshape(2, 30, heads, D).transpose(1, 2)).sum(-1, keepdim=True)
    dl = torch.exp(logits - bad_lse[..., None]) * (dof @ v.transpose(-1, -2) - delta)
    naive_h = dl.reshape(2, heads, 30, H, W).sum(-1)
    assert (naive_h - exact[1]).abs().max() > 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_autograd_hands_out_and_lse_to_the_backward_in_both_dtypes(monkeypatch, dtype):
    """``vit_attention_relpos`` under autograd, fp32 as bf16: the forward
    saves its output (of the compute dtype) and the rows' fp32 lse, and the
    backward passes both to ``vit_attention_relpos_bwd`` (the CPU: the plain
    path)."""
    qkv, rel_h, rel_w, do = (torch.from_numpy(a).to(dtype) for a in vit_inputs(5, 2, 4, 6))
    seen = {}

    def spy(*args, out=None, lse=None):
        seen.update(out=out, lse=lse)
        return vit_attention_relpos_bwd(*args, out=out, lse=lse)

    monkeypatch.setattr(va, "vit_attention_relpos_bwd", spy)
    leaf = qkv.clone().requires_grad_()
    y = vit_attention_relpos(leaf, rel_h, rel_w, 2, (4, 6))
    (grad,) = torch.autograd.grad(y, leaf, do)
    want_out, want_lse = vit_attention_relpos_plain(qkv, rel_h, rel_w, 2, (4, 6), with_lse=True)
    assert seen["out"].dtype == dtype and seen["lse"].dtype == torch.float32
    assert torch.equal(seen["out"], y.detach()) and torch.equal(seen["out"], want_out)
    assert torch.equal(seen["lse"], want_lse)
    torch.testing.assert_close(grad, vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, 2,
                                                                    (4, 6))[0])


def test_kernel_bits_lists_the_redesigned_kernels_and_the_encode():
    """tools/kernel_bits.py --time: K6 at 64 and 80, global and windowed,
    writing lse and not, in bf16 and fp32; K7 at both encoders' padded grid;
    K6b in fp32 at K6's four shapes beside the bf16 ones; and the SAM image
    encode (K6's
    caller) at SAM-base batch 1 and 8 and sam_huge batch 1. The case lists
    build nothing until a case is made; K6 and K7 stay in the bit-for-bit
    list (their sums keep the first design's order)."""
    from cor_tpu_torch.tools import kernel_bits as kb

    labels = [label for label, _ in kb.timed_cases("cpu")]
    for D, C3 in ((64, 2304), (80, 3840)):
        for shape in (f"[2, 4096, {C3}]", f"[50, 196, {C3}]"):
            for kind in ("K6", "K6@fp32", "K6b", "K6b@fp32"):
                assert f"{kind} d{D} {shape}" in labels
            assert f"K6 d{D} {shape} writing lse" in labels
            assert f"K6@fp32 d{D} {shape} writing lse" in labels
        assert f"K7 d{D} [2, 70, 70, {C3}]" in labels
    # K4/K4′ in bf16 (6) and fp32 (8) and K5/K5′ (20) beside these (4 x 6 +
    # 2), and K7@fp32 at both grids (2)
    assert len(labels) == len(set(labels)) == 6 + 8 + 20 + 4 * 6 + 2 + 2
    assert [label for label, _ in kb.encode_cases("cpu")][:3] == [
        "image encode sam_base batch 1", "image encode sam_base batch 8",
        "image encode sam_huge batch 1"]
    assert {"cor_vit_attention_relpos", "cor_vit_attention_relpos_windows"} <= set(kb._COMPARED)
    assert "cor_vit_attention_relpos_bwd" in kb._TIMED


@pytest.mark.parametrize("H,W", [(8, 8), (5, 13)], ids=["grid8", "rect"])
def test_float64_yardstick_matches_the_plain_backward(H, W):
    """The float64 K6b (tools/k6b_accuracy.py), against which kernel_bits
    --time and chip_smoke.py read the fp32 kernels' errors, is the function
    the plain backward computes: within cor_tpu's fp32 gradient tolerance of
    it; and its 3xTF32 products stay within 1e-6 of it."""
    from cor_tpu_torch.tools.k6b_accuracy import k6b_float64, mm_tf32x3

    ts = [torch.from_numpy(x) for x in vit_inputs(3, 2, H, W)]
    exact = k6b_float64(*ts, 2, (H, W))
    plain = vit_attention_relpos_bwd_plain(*ts, 2, (H, W))
    split = k6b_float64(*ts, 2, (H, W), mm=mm_tf32x3)
    for e, p, s in zip(exact, plain, split):
        assert e.dtype == s.dtype == torch.float64 and e.shape == p.shape
        torch.testing.assert_close(p.double(), e, **FP32_GRAD_TOL)
        torch.testing.assert_close(s, e, atol=1e-6, rtol=0)


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


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


GRIDS = [(2, 8, 8), (3, 14, 14), (1, 64, 64), (2, 5, 13), (1, 24, 20)]
GRID_IDS = ["grid8", "window14", "global", "rect", "other"]


def card_inputs(device, B, H, W, d, dtype, seed=11):
    g = torch.Generator(device=device).manual_seed(seed)
    N, heads = H * W, (12 if d == 64 else 16)
    C = heads * d
    rnd = lambda *s: torch.randn(*s, generator=g, device=device)  # noqa: E731
    return (rnd(B, N, 3 * C).to(dtype), (0.3 * rnd(B, heads, N, H)).to(dtype),
            (0.3 * rnd(B, heads, N, W)).to(dtype), rnd(B, N, C).to(dtype), heads)


@pytest.mark.gpu
@pytest.mark.parametrize("with_lse", [False, True], ids=["out", "out+lse"])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", GRIDS, ids=GRID_IDS)
def test_k6_wgmma_matches_plain(cuda_device, B, H, W, d, with_lse):
    """K6 in bf16 on wgmma at head_dim 64 and 80 through both bias paths (W
    = 64: a key tile is one grid row; any other grid), with and without the
    rows' lse: out within 2e-2 of max |plain|, finite, one launch, the same
    bits with lse as without; the lse within 2e-4 of the plain lse."""
    qkv, rel_h, rel_w, _, heads = card_inputs(cuda_device, B, H, W, d, torch.bfloat16)
    args = (qkv, rel_h, rel_w, heads, (H, W))
    before = vit_attention_relpos.launches
    if with_lse:
        got, lse = vit_attention_relpos_with_lse(*args)
    else:
        got = vit_attention_relpos(*args)
    torch.cuda.synchronize()
    assert vit_attention_relpos.launches == before + 1
    want, want_lse = vit_attention_relpos_plain(*args, with_lse=True)
    assert torch.isfinite(got.float()).all() and rel_err(got, want) <= DECODE_REL
    if with_lse:
        assert torch.equal(got, vit_attention_relpos(*args))
        torch.testing.assert_close(lse, want_lse, atol=2e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("heads,d", [(12, 64), (16, 80)], ids=["sam_base", "sam_huge"])
def test_k7_wgmma_matches_plain(cuda_device, heads, d):
    """K7 on wgmma at SAM-base's and sam_huge's padded grid [2, 70, 70, 3C]
    (windows of 14, cropped to 64 x 64): within 2e-2 of max |plain|, one
    launch, and equal to K6 on the partitioned windows."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    C, bf = heads * d, torch.bfloat16
    qkv = torch.randn(2, 70, 70, 3 * C, generator=g, device=cuda_device).to(bf)
    rel_h, rel_w = ((0.3 * torch.randn(2, heads, 4900, 14, generator=g, device=cuda_device))
                    .to(bf) for _ in range(2))
    args = (qkv, rel_h, rel_w, heads, 14, (64, 64))
    before = vit_attention_relpos_windows.launches
    got = vit_attention_relpos_windows(*args)
    torch.cuda.synchronize()
    assert vit_attention_relpos_windows.launches == before + 1
    assert rel_err(got, vit_attention_relpos_windows_plain(*args)) <= DECODE_REL
    part = lambda x: va._partition(x, 14)  # noqa: E731
    rel_win = [part(r.reshape(2, heads, 70, 70, 14).permute(0, 2, 3, 1, 4)).transpose(1, 2)
               .contiguous() for r in (rel_h, rel_w)]
    k6 = vit_attention_relpos(part(qkv).contiguous(), *rel_win, heads, (14, 14))
    k6 = k6.reshape(2, 5, 5, 14, 14, C).permute(0, 1, 3, 2, 4, 5).reshape(2, 70, 70, C)
    assert torch.equal(got, k6[:, :64, :64])


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", GRIDS, ids=GRID_IDS)
def test_fp32_k6_out_is_the_same_bits_with_lse(fp32_device, B, H, W, d):
    """K6 in fp32 writing the rows' lse (what autograd's forward now asks
    for): out the same bits as without, within cor_tpu's fp32 tolerance of
    the plain version (2e-4), the lse within 2e-5 of the plain lse."""
    qkv, rel_h, rel_w, _, heads = card_inputs(fp32_device, B, H, W, d, torch.float32)
    args = (qkv, rel_h, rel_w, heads, (H, W))
    out, lse = vit_attention_relpos_with_lse(*args)
    again = vit_attention_relpos(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    want, want_lse = vit_attention_relpos_plain(*args, with_lse=True)
    torch.testing.assert_close(out, want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", GRIDS, ids=GRID_IDS)
def test_k6b_fp32_from_forward_stats_matches_plain(fp32_device, B, H, W, d):
    """K6b in fp32 given the fp32 forward's out and lse, through both ways
    of summing the bias gradients (the row sums at W = 64, the indicator
    product elsewhere): dqkv, drel_h and drel_w within atol 1e-5 / rtol 1e-4
    of the exact plain backward (TF32 off), one fp32 launch, the same bits
    from run to run, and a refusal without out and lse."""
    qkv, rel_h, rel_w, do, heads = card_inputs(fp32_device, B, H, W, d, torch.float32)
    args = (qkv, rel_h, rel_w, do, heads, (H, W))
    out, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, (H, W))
    with pytest.raises(ValueError, match="takes the forward's out and lse"):
        vit_attention_relpos_bwd(*args)
    before = vit_attention_relpos_bwd.launches_fp32
    got = vit_attention_relpos_bwd(*args, out=out, lse=lse)
    again = vit_attention_relpos_bwd(*args, out=out, lse=lse)
    torch.cuda.synchronize()
    assert vit_attention_relpos_bwd.launches_fp32 == before + 2
    want = vit_attention_relpos_bwd_plain(*args)
    for name, a, a2, b in zip(("dqkv", "drel_h", "drel_w"), got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a, a2), name
        torch.testing.assert_close(a, b, **FP32_GRAD_TOL, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", [(2, 14, 14), (1, 64, 64)], ids=["window14", "global"])
def test_fp32_autograd_runs_k6_with_lse_then_k6b(fp32_device, B, H, W, d):
    """``vit_attention_relpos`` under autograd in fp32, as an unfrozen fp32
    training step runs it: one fp32 K6 launch (writing the lse), one fp32
    K6b launch given its out and lse, no bf16 launch; the gradients of qkv,
    rel_h and rel_w within atol 1e-5 / rtol 1e-4 of the plain backward."""
    qkv, rel_h, rel_w, do, heads = card_inputs(fp32_device, B, H, W, d, torch.float32, seed=17)
    leaves = [x.clone().requires_grad_() for x in (qkv, rel_h, rel_w)]
    fwd, bwd = vit_attention_relpos, vit_attention_relpos_bwd
    before = (fwd.launches, fwd.launches_fp32, bwd.launches, bwd.launches_fp32)
    y = vit_attention_relpos(*leaves, heads, (H, W))
    grads = torch.autograd.grad(y, leaves, do)
    torch.cuda.synchronize()
    assert (fwd.launches, fwd.launches_fp32, bwd.launches, bwd.launches_fp32) == (
        before[0], before[1] + 1, before[2], before[3] + 1)
    want = vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, heads, (H, W))
    for name, a, b in zip(("dqkv", "drel_h", "drel_w"), grads, want):
        torch.testing.assert_close(a, b, **FP32_GRAD_TOL, msg=name)
