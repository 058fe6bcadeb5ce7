"""The bf16 attention kernels redesigned for Hopper: K6b (the backward of the
SAM ViT attention with the decomposed rel-pos bias) takes the forward's
statistics, and K4/K4′ (sequence attention) runs on wgmma.

On the CPU: K6's plain forward returns the rows' log-sum-exp that K6b reads,
equal to the log-sum-exp of ``cor_tpu``'s XLA logits; a plain backward built
as the bf16 kernel computes (a from the saved lse, delta from the bf16
output) stays within the kernels' bf16 tolerance of ``cor_tpu``'s flash
backward, which measures the known difference of delta = rowsum(do * out);
``_VitAttentionRelpos`` hands its saved out and lse to the backward; and
``tools/kernel_bits.py`` finds an older ``csrc/`` whose K6 takes no lse.

The tests marked ``gpu`` hold the new kernels against their plain versions
on the card:

    python -m pytest tests/test_torch_attention_redesign.py -m gpu --noconftest
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.kernels import vit_attention as va
from cor_tpu_torch.ops.kernels.seq_attention import (
    attention_seq,
    attention_seq_plain,
    attention_seq_qkv,
    attention_seq_qkv_plain,
)
from cor_tpu_torch.ops.kernels.vit_attention import (
    vit_attention_relpos,
    vit_attention_relpos_bwd,
    vit_attention_relpos_bwd_plain,
    vit_attention_relpos_plain,
    vit_attention_relpos_with_lse,
)

DECODE_REL = 2e-2  # max |kernel - plain| / max |plain|: the bf16 kernels' tolerance


def vit_inputs(rng, B, H, W, heads=2, D=64):
    """qkv [B, N, 3C], bias factors [B, heads, N, H|W] (x0.3) and a
    cotangent [B, N, C], head_dim D."""
    N, C = H * W, heads * D
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    rel_h = (0.3 * rng.standard_normal((B, heads, N, H))).astype(np.float32)
    rel_w = (0.3 * rng.standard_normal((B, heads, N, W))).astype(np.float32)
    do = rng.standard_normal((B, N, C)).astype(np.float32)
    return qkv, rel_h, rel_w, do


def xla_lse(qkv, rel_h, rel_w, heads, hw):
    """The rows' log-sum-exp of cor_tpu's XLA logits (ops/attention.py
    attention_2d: q * scale against k in fp32, the decomposed bias added on
    the [.., H, W, H, W] view), [B, heads, N]."""
    import jax
    import jax.numpy as jnp

    H, W = hw
    B, N, C3 = qkv.shape
    D = C3 // 3 // heads
    x = jnp.asarray(qkv).reshape(B, N, 3, heads, D).transpose(2, 0, 3, 1, 4)
    q, k = x[0].reshape(B * heads, N, D), x[1].reshape(B * heads, N, D)
    attn = jnp.einsum("bqd,bkd->bqk", q * D**-0.5, k, preferred_element_type=jnp.float32)
    rh = jnp.asarray(rel_h).reshape(B * heads, H, W, H)
    rw = jnp.asarray(rel_w).reshape(B * heads, H, W, W)
    attn = attn.reshape(B * heads, H, W, H, W) + rh[..., :, None] + rw[..., None, :]
    return np.asarray(jax.nn.logsumexp(attn.reshape(B, heads, N, N), axis=-1))


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("H,W", [(8, 8), (5, 13)], ids=["grid8", "rect"])
def test_plain_forward_lse_matches_cor_tpu_logits(rng, D, H, W):
    """K6's plain forward with ``with_lse`` returns the output it returns
    without, and the log-sum-exp of cor_tpu's XLA logits (natural log, fp32),
    at SAM-base's head_dim 64 and sam_huge's 80."""
    qkv, rel_h, rel_w, _ = vit_inputs(rng, 2, H, W, D=D)
    args = (torch.from_numpy(qkv), torch.from_numpy(rel_h), torch.from_numpy(rel_w), 2, (H, W))
    out, lse = vit_attention_relpos_plain(*args, with_lse=True)
    assert torch.equal(out, vit_attention_relpos_plain(*args))
    assert lse.shape == (2, 2, H * W) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), xla_lse(qkv, rel_h, rel_w, 2, (H, W)), atol=1e-5,
                               rtol=1e-5)
    # the entry that autograd's forward runs: the plain version on the CPU
    before = vit_attention_relpos.launches
    out2, lse2 = vit_attention_relpos_with_lse(*args)
    assert vit_attention_relpos.launches == before
    assert torch.equal(out2, out) and torch.equal(lse2, lse)


def bwd_from_stats(qkv, rel_h, rel_w, do, heads, hw, out, lse):
    """The bf16 kernel's backward, plainly: a = exp(l - lse) from the
    forward's lse, delta = rowsum(do * out) in fp32 over its bf16 out, the
    kernel's rounding points (q * scale, a and dl in bf16)."""
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    dt = qkv.dtype
    scale = D**-0.5
    q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, heads, D).transpose(1, 2).float()
               for i in range(3))
    qs = (q * scale).to(dt).float()
    logits = (qs @ k.transpose(-1, -2)).reshape(B, heads, N, H, W)
    logits = (logits + rel_h.float()[..., :, None] + rel_w.float()[..., None, :])
    a = torch.exp(logits.reshape(B, heads, N, N) - lse[..., None])
    dof = do.to(dt).reshape(B, N, heads, D).transpose(1, 2).float()
    of = out.reshape(B, N, heads, D).transpose(1, 2).float()
    delta = (dof * of).sum(-1, keepdim=True)
    dl = (a * (dof @ v.transpose(-1, -2) - delta)).to(dt).float()
    merge = lambda x: x.to(dt).transpose(1, 2).reshape(B, N, C)  # noqa: E731
    dq = merge((dl @ k) * scale)
    dk = merge(dl.transpose(-1, -2) @ qs)
    dv = merge(a.to(dt).float().transpose(-1, -2) @ dof)
    dl5 = dl.reshape(B, heads, N, H, W)
    return (torch.cat([dq, dk, dv], dim=-1), dl5.sum(-1).to(rel_h.dtype),
            dl5.sum(-2).to(rel_w.dtype))


def cor_tpu_bwd(xs, H, W):
    """cor_tpu's flash backward (``_vit_attention_relpos_bwd``, Pallas
    interpret mode) as K6's custom_vjp calls it, in bf16, 2 heads of 64:
    (dqkv, drel_h, drel_w) as fp32 numpy."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.vit_attention import _vit_attention_relpos_bwd

    n = np.arange(H * W)
    eh = (np.arange(H)[:, None] == (n // W)[None, :]).astype(np.float32)
    ew = (np.arange(W)[:, None] == (n % W)[None, :]).astype(np.float32)
    got = _vit_attention_relpos_bwd(
        *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in xs[:3]),
        jnp.asarray(eh), jnp.asarray(ew),
        jnp.asarray(xs[3].float().numpy()).astype(jnp.bfloat16), 2, 64**-0.5)
    return [np.asarray(g.astype(jnp.float32)) for g in got]


@pytest.mark.parametrize("H,W", [(8, 8), (14, 14), (5, 13)], ids=["grid8", "window14", "rect"])
def test_backward_from_saved_stats_stays_within_bf16_tolerance(rng, H, W):
    """The known difference of the redesigned K6b, measured on the CPU: its
    backward built from the forward's bf16 out and lse (delta =
    rowsum(do * out)) against cor_tpu's flash backward (exact delta), bf16,
    2 heads of 64: within 2e-2 of max |cor_tpu| for dqkv, drel_h and drel_w,
    as the exact plain backward is."""
    xs = [torch.from_numpy(a).to(torch.bfloat16) for a in vit_inputs(rng, 2, H, W)]
    out, lse = vit_attention_relpos_plain(*xs[:3], 2, (H, W), with_lse=True)
    got = bwd_from_stats(*xs, 2, (H, W), out, lse)
    exact = vit_attention_relpos_bwd_plain(*xs, 2, (H, W))
    want = cor_tpu_bwd(xs, H, W)
    for name, g, e, w in zip(("dqkv", "drel_h", "drel_w"), got, exact, want):
        assert g.dtype == e.dtype == torch.bfloat16, name
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= DECODE_REL, (name, err)
        assert np.abs(e.float().numpy() - w).max() <= DECODE_REL * np.abs(w).max(), name


def test_autograd_hands_out_and_lse_to_the_backward(rng, monkeypatch):
    """``vit_attention_relpos`` under autograd: the forward saves its output
    and the rows' lse, and the backward passes both to
    ``vit_attention_relpos_bwd`` (the CPU: the plain path); without a
    gradient no lse is computed."""
    qkv, rel_h, rel_w, do = (torch.from_numpy(a) for a in vit_inputs(rng, 2, 4, 6))
    seen = {}

    def spy(*args, out=None, lse=None):
        seen.update(out=out, lse=lse)
        return vit_attention_relpos_bwd(*args, out=out, lse=lse)

    monkeypatch.setattr(va, "vit_attention_relpos_bwd", spy)
    leaf = qkv.clone().requires_grad_()
    y = vit_attention_relpos(leaf, rel_h, rel_w, 2, (4, 6))
    (grad,) = torch.autograd.grad(y, leaf, do)
    want_out, want_lse = vit_attention_relpos_plain(qkv, rel_h, rel_w, 2, (4, 6), with_lse=True)
    assert torch.equal(seen["out"], y.detach()) and torch.equal(seen["out"], want_out)
    assert torch.equal(seen["lse"], want_lse)
    torch.testing.assert_close(grad, vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, 2,
                                                                    (4, 6))[0])
    calls = []
    monkeypatch.setattr(va, "vit_attention_relpos_plain",
                        lambda *a, **k: calls.append(k) or vit_attention_relpos_plain(*a, **k))
    with torch.no_grad():
        vit_attention_relpos(qkv, rel_h, rel_w, 2, (4, 6))
    assert calls == [{}]


def test_kernel_bits_finds_a_csrc_without_lse(tmp_path):
    """tools/kernel_bits.py on a synthetic ``csrc/`` whose K6 and K6b take no
    forward statistics (the ABI before the redesign): lacking() names K6's
    lse and K6b's out and lse, at their positions, and the old entries are
    called with them dropped whatever they hold."""
    from cor_tpu_torch.ops.kernels import _build
    from cor_tpu_torch.tools import kernel_bits as kb

    text = "".join(p.read_text() for p in sorted(_build.CSRC_DIR.glob("*.cu")))
    assert kb.lacking(_build.CSRC_DIR) == {}
    old = re.sub(r"void\* out, void\* lse,", "void* out,", text)
    old = re.sub(r"const void\* out, const void\* lse,\s*", "", old)
    assert old != text
    (tmp_path / "old.cu").write_text(old)
    missing = kb.lacking(tmp_path)
    assert {n: [(p, pos) for p, pos, _ in ps] for n, ps in missing.items()} == {
        "cor_vit_attention_relpos": [("lse", 4)],
        "cor_vit_attention_relpos_bwd": [("out", 4), ("lse", 5)]}
    got = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: got.append((name, args)) or 0

    lib = kb._OldABI(Lib(), missing)
    lib.cor_vit_attention_relpos("qkv", "rh", "rw", "out", 1234, 2, 16, 128, 2, 4, 4, 0.125, 0,
                                 "s")
    assert got[-1] == ("cor_vit_attention_relpos",
                       ("qkv", "rh", "rw", "out", 2, 16, 128, 2, 4, 4, 0.125, 0, "s"))
    lib.cor_vit_attention_relpos_bwd("qkv", "rh", "rw", "do", "out", "lse", "dqkv", "dh", "dw",
                                     "stats", 2, 16, 128, 2, 4, 4, 0.125, 0, "s")
    assert got[-1][1][:8] == ("qkv", "rh", "rw", "do", "dqkv", "dh", "dw", "stats")
    # the bit-for-bit list leaves out the redesigned entries; --time takes them
    assert "cor_seq_attention" not in kb._COMPARED and "cor_seq_attention" in kb._TIMED
    assert ("cor_vit_attention_relpos_bwd" not in kb._COMPARED
            and "cor_vit_attention_relpos_bwd" in kb._TIMED)


# ---------------------------------------------------------------------------
# on the card: the redesigned kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 72, 80])
@pytest.mark.parametrize("n", [729, 64, 5])
def test_k4_wgmma_matches_plain_at_ragged_n(cuda_device, d, n):
    """K4/K4′ on wgmma through both entries at N 729 (SO400M's vision tower:
    11 tiles of 64 and 25 keys), 64 (the text towers) and 5 (one partial
    tile): within 2e-2 of max |plain|, finite, one launch each."""
    heads = 12 if d == 64 else 16
    g = torch.Generator(device=cuda_device).manual_seed(7)
    qkv = torch.randn(4, n, 3 * heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    before = attention_seq_qkv.launches
    got = attention_seq_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert attention_seq_qkv.launches == before + 1 and torch.isfinite(got.float()).all()
    assert rel_err(got, attention_seq_qkv_plain(qkv, heads)) <= DECODE_REL
    C = heads * d
    q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, d)).transpose(1, 2).contiguous()
               for i in range(3))
    got4 = attention_seq(q, k, v, heads)
    torch.cuda.synchronize()
    assert torch.isfinite(got4.float()).all()
    assert rel_err(got4, attention_seq_plain(q, k, v, heads)) <= DECODE_REL


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", [(2, 8, 8), (3, 14, 14), (1, 64, 64), (2, 5, 13), (1, 24, 20),
                                   (1, 32, 64)],
                         ids=["grid8", "window14", "global", "rect", "fold", "rows"])
def test_k6b_wgmma_matches_plain(cuda_device, B, H, W, d):
    """K6b on wgmma given K6's out and lse against the exact plain backward,
    through each way of summing the bias gradients (the indicator product
    at H + W <= 32, the register row sums at W = 64, the fold otherwise):
    dqkv, drel_h and drel_w within 2e-2 of max |plain| and finite; the same
    bits from run to run (no atomics)."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    N, heads = H * W, (12 if d == 64 else 16)
    C, bf = heads * d, torch.bfloat16
    qkv = torch.randn(B, N, 3 * C, generator=g, device=cuda_device).to(bf)
    rel_h = (0.3 * torch.randn(B, heads, N, H, generator=g, device=cuda_device)).to(bf)
    rel_w = (0.3 * torch.randn(B, heads, N, W, generator=g, device=cuda_device)).to(bf)
    do = torch.randn(B, N, C, generator=g, device=cuda_device).to(bf)
    out, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, (H, W))
    args = (qkv, rel_h, rel_w, do, heads, (H, W))
    got = vit_attention_relpos_bwd(*args, out=out, lse=lse)
    again = vit_attention_relpos_bwd(*args, out=out, lse=lse)
    torch.cuda.synchronize()
    want = vit_attention_relpos_bwd_plain(*args)
    for name, a, a2, b in zip(("dqkv", "drel_h", "drel_w"), got, again, want):
        assert torch.isfinite(a.float()).all() and torch.equal(a, a2), name
        assert rel_err(a, b) <= DECODE_REL, (name, rel_err(a, b))
