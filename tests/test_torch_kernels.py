"""cor_tpu_torch's kernel modules against cor_tpu's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against cor_tpu's kernels run the way cor_tpu's own tests run them
on the CPU (Pallas interpret mode, or cor_tpu's XLA fallback), at cor_tpu's
kernel-test tolerance (tests/test_pallas_kernels.py, test_kernel_vjp.py):
atol = rtol = 1e-5 in fp32.

The tests marked ``gpu`` hold each CUDA kernel against its plain version in
bf16 at the serving path's shapes; they skip without a CUDA card. A machine
with a card but without jax runs them with

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

which is why this file imports jax and cor_tpu only inside the CPU tests.
"""

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv, attention_seq_qkv_plain
from cor_tpu_torch.ops.kernels.vit_attention import (
    vit_attention_relpos,
    vit_attention_relpos_bwd,
    vit_attention_relpos_bwd_plain,
    vit_attention_relpos_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "shape", [(2, 64, 128), (3, 5, 64)], ids=["pallas-interpret", "xla-fallback"]
)
def test_layer_norm_plain_matches_pallas(rng, shape):
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.layernorm import layer_norm_pallas

    C = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    s = rng.standard_normal(C).astype(np.float32)
    b = rng.standard_normal(C).astype(np.float32)
    want = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), eps=1e-6))
    t = [torch.from_numpy(a) for a in (x, s, b)]
    np.testing.assert_allclose(layer_norm_plain(*t, 1e-6).numpy(), want, **TOL)
    # on a CPU tensor the wrapper is the plain version, and counts no launch
    before = layer_norm.launches
    np.testing.assert_allclose(layer_norm(*t, 1e-6).numpy(), want, **TOL)
    assert layer_norm.launches == before


@pytest.mark.parametrize("width,n", [(128, 36), (128, 64), (64, 36), (64, 64)],
                         ids=["d64-n36", "d64-n64", "d32-n36", "d32-n64"])
def test_attention_seq_qkv_plain_matches_pallas(rng, width, n):
    # width 128 / 2 heads: head_dim 64, cor_tpu's _qkv_pair_call kernel;
    # width 64 / 2 heads: head_dim 32, its attention_seq_pallas kernel
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.seq_attention import attention_seq_qkv_pallas

    qkv = rng.standard_normal((2, n, 3 * width)).astype(np.float32)
    want = np.asarray(attention_seq_qkv_pallas(jnp.asarray(qkv), num_heads=2))
    t = torch.from_numpy(qkv)
    np.testing.assert_allclose(attention_seq_qkv_plain(t, 2).numpy(), want, **TOL)
    before = attention_seq_qkv.launches
    np.testing.assert_allclose(attention_seq_qkv(t, 2).numpy(), want, **TOL)
    assert attention_seq_qkv.launches == before


def vit_inputs(rng, B, H, W, heads=2):
    """qkv [B, N, 3C] and bias factors [B, heads, N, H|W] (x0.3), head_dim 64."""
    N, C = H * W, heads * 64
    qkv = rng.standard_normal((B, N, 3 * C)).astype(np.float32)
    rel_h = (0.3 * rng.standard_normal((B, heads, N, H))).astype(np.float32)
    rel_w = (0.3 * rng.standard_normal((B, heads, N, W))).astype(np.float32)
    return qkv, rel_h, rel_w


@pytest.mark.parametrize("H,W", [(10, 10), (4, 4), (6, 5)], ids=["grid10", "window4", "rect"])
def test_vit_attention_relpos_plain_matches_pallas(rng, H, W):
    """K6's plain version against cor_tpu's kernel, called as
    attention_2d_fused calls it (indicator matrices, explicit scale)."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.vit_attention import vit_attention_relpos_pallas

    qkv, rel_h, rel_w = vit_inputs(rng, 2, H, W)
    n = np.arange(H * W)
    eh = (np.arange(H)[:, None] == (n // W)[None, :]).astype(np.float32)
    ew = (np.arange(W)[:, None] == (n % W)[None, :]).astype(np.float32)
    want = np.asarray(vit_attention_relpos_pallas(
        *map(jnp.asarray, (qkv, rel_h, rel_w, eh, ew)), 2, scale=64**-0.5))
    args = (torch.from_numpy(qkv), torch.from_numpy(rel_h), torch.from_numpy(rel_w), 2, (H, W))
    np.testing.assert_allclose(vit_attention_relpos_plain(*args).numpy(), want, **TOL)
    before = vit_attention_relpos.launches
    np.testing.assert_allclose(vit_attention_relpos(*args).numpy(), want, **TOL)
    assert vit_attention_relpos.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,W", [(8, 8), (4, 4)], ids=["grid8", "window4"])
def test_vit_attention_relpos_bwd_plain_matches_pallas(rng, H, W, dtype):
    """K6b's plain version against cor_tpu's flash-backward kernel
    (``_vit_attention_relpos_bwd``, Pallas interpret mode), as K6's
    custom_vjp calls it: C = 128, 2 heads of 64. fp32 at cor_tpu's own
    tolerance (tests/test_kernel_vjp.py); bf16 within 2e-2 of max |ref| (the
    TPU kernel's mean-shifted keys round differently in bf16)."""
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.vit_attention import _vit_attention_relpos_bwd

    qkv, rel_h, rel_w = vit_inputs(rng, 2, H, W)
    do = rng.standard_normal((2, H * W, 128)).astype(np.float32)
    n = np.arange(H * W)
    eh = (np.arange(H)[:, None] == (n // W)[None, :]).astype(np.float32)
    ew = (np.arange(W)[:, None] == (n % W)[None, :]).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xs = [torch.from_numpy(a).to(tdt) for a in (qkv, rel_h, rel_w, do)]
    want = _vit_attention_relpos_bwd(
        *(jnp.asarray(x.float().numpy()).astype(jdt) for x in xs[:3]), jnp.asarray(eh),
        jnp.asarray(ew), jnp.asarray(xs[3].float().numpy()).astype(jdt), 2, 64**-0.5)
    before = vit_attention_relpos_bwd.launches
    got = vit_attention_relpos_bwd(*xs, 2, (H, W))  # the CPU takes the plain version
    assert vit_attention_relpos_bwd.launches == before
    for g, w in zip(got, want):
        assert g.dtype == tdt
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5, rtol=1e-4)
        else:
            assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()


@pytest.mark.parametrize("H,W", [(8, 8), (4, 4), (6, 5)], ids=["grid8", "window4", "rect"])
def test_vit_attention_relpos_bwd_plain_matches_autograd(rng, H, W):
    """The plain backward is the gradient of the plain forward (fp32), and
    the differentiable ``vit_attention_relpos`` returns it."""
    qkv, rel_h, rel_w = vit_inputs(rng, 2, H, W)
    do = torch.from_numpy(rng.standard_normal((2, H * W, 128)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (qkv, rel_h, rel_w)]
    want = torch.autograd.grad(vit_attention_relpos_plain(*leaves, 2, (H, W)), leaves, do)
    got = vit_attention_relpos_bwd_plain(*(x.detach() for x in leaves), do, 2, (H, W))
    through = torch.autograd.grad(vit_attention_relpos(*leaves, 2, (H, W)), leaves, do)
    for g, t, w in zip(got, through, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)
        torch.testing.assert_close(t, g, atol=0, rtol=0)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        layer_norm(x, torch.empty(128, device="meta"), torch.empty(128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        attention_seq_qkv(torch.empty(1, 4, 384, device="meta"), 2)
    with pytest.raises(ValueError, match="no kernel"):
        rel = torch.empty(1, 2, 4, 2, device="meta")
        vit_attention_relpos(torch.empty(1, 4, 384, device="meta"), rel, rel, 2, (2, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [16 * 576, 16 * 64, 1001])
def test_layer_norm_kernel_matches_plain_bf16(cuda_device, rows):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = (2 * torch.randn(rows, 768, generator=g, device=cuda_device) + 0.5).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(768, generator=g, device=cuda_device)).to(torch.bfloat16)
    b = (0.1 * torch.randn(768, generator=g, device=cuda_device)).to(torch.bfloat16)
    before = layer_norm.launches
    got = layer_norm(x, s, b)
    torch.cuda.synchronize()
    assert layer_norm.launches == before + 1
    # one bf16 ulp at |y| <= 4 is 1.6e-2; both take fp32 statistics
    torch.testing.assert_close(got.float(), layer_norm_plain(x, s, b).float(), atol=2e-2, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [576, 64, 100])
def test_attention_seq_qkv_kernel_matches_plain_bf16(cuda_device, n):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(16, n, 3 * 768, generator=g, device=cuda_device).to(torch.bfloat16)
    before = attention_seq_qkv.launches
    got = attention_seq_qkv(qkv, 12)
    torch.cuda.synchronize()
    assert attention_seq_qkv.launches == before + 1
    # the online softmax rounds P to bf16 at other places than the plain version
    torch.testing.assert_close(
        got.float(), attention_seq_qkv_plain(qkv, 12).float(), atol=2e-2, rtol=0
    )


@pytest.mark.gpu
def test_attention_seq_qkv_kernel_refuses_other_head_dims(cuda_device):
    qkv = torch.zeros(1, 8, 3 * 1152, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        attention_seq_qkv(qkv, 16)  # SO400M: head_dim 72


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", [(1, 64, 64), (50, 14, 14)], ids=["global", "windowed"])
def test_vit_attention_relpos_kernel_matches_plain_bf16(cuda_device, B, H, W):
    """K6 at SAM-base's shapes: a global block of one image (N = 4096) and
    the 50 windows of two images (N = 196, the last key tile masked after 4
    keys). Both round q * scale and P to bf16 at the same points; the
    online softmax sums in another order: max |d| / max |plain| <= 2e-2."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    N, bf = H * W, torch.bfloat16
    qkv = torch.randn(B, N, 3 * 768, generator=g, device=cuda_device).to(bf)
    rel_h = (0.3 * torch.randn(B, 12, N, H, generator=g, device=cuda_device)).to(bf)
    rel_w = (0.3 * torch.randn(B, 12, N, W, generator=g, device=cuda_device)).to(bf)
    before = vit_attention_relpos.launches
    got = vit_attention_relpos(qkv, rel_h, rel_w, 12, (H, W))
    torch.cuda.synchronize()
    assert vit_attention_relpos.launches == before + 1
    want = vit_attention_relpos_plain(qkv, rel_h, rel_w, 12, (H, W))
    assert rel_err(got, want) <= DECODE_REL


@pytest.mark.gpu
def test_vit_attention_relpos_kernel_refuses_other_head_dims(cuda_device):
    qkv = torch.zeros(1, 16, 3 * 1280, device=cuda_device, dtype=torch.bfloat16)
    rel = torch.zeros(1, 16, 16, 4, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 64"):
        vit_attention_relpos(qkv, rel, rel, 16, (4, 4))  # sam_huge: head_dim 80


# ---------------------------------------------------------------------------
# the SAM mask decoder's kernels (K1 two-way layer, K2 final t2i attention,
# K3 upscale tail): the CUDA kernel against its plain version in bf16 at the
# decode path's widths (C 256, 8 heads, 64 x 64 grid), max |d| / max |plain|
# <= 2e-2 (the plain versions round at the kernels' points; the flash
# partials and the order of the fp32 sums differ)
# ---------------------------------------------------------------------------

DECODE_REL = 2e-2


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.fixture(scope="module")
def sam_decoder_bf16():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder

    return init_mask_decoder(CoreConfig(), 1).to("cuda", torch.bfloat16).eval()


def decode_inputs(n, N=4096, S=None, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    bf = torch.bfloat16
    return dict(
        tokens=rnd(n, 6, 256).to(bf), rows=(0.5 * rnd(S or n, N, 256)).to(bf),
        kpe=(0.5 * rnd(N, 128)).to(bf), qpe=(0.5 * rnd(N, 128)).to(bf),
    )


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["skip_pe", "pe", "store", "int8"])
def test_two_way_layer_kernel_matches_plain_bf16(sam_decoder_bf16, case):
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain

    lp = sam_decoder_bf16.transformer.layers[0 if case != "pe" else 1]
    n = 8
    x = decode_inputs(n, S=12 if case in ("store", "int8") else None)
    keys, idx, scale = x["rows"], None, None
    if case in ("store", "int8"):
        idx = torch.tensor([11, 0, 3, 3, 7, 2, 9, 5], dtype=torch.int32, device="cuda")
    if case == "int8":
        f = keys.float()
        scale = (f.abs().amax(dim=(1, 2)) / 127.0).clamp_min(1e-12)
        keys = torch.clamp(torch.round(f / scale[:, None, None]), -127, 127).to(torch.int8)
    args = (lp, x["tokens"], x["tokens"], keys, x["kpe"], x["qpe"], case != "pe")
    with torch.no_grad():
        before = two_way_layer.launches
        got_t, got_k = two_way_layer(*args, idx=idx, scale=scale)
        torch.cuda.synchronize()
        assert two_way_layer.launches == before + 4
        want_t, want_k = two_way_layer_plain(*args, idx=idx, scale=scale)
    assert rel_err(got_t, want_t) <= DECODE_REL
    assert rel_err(got_k, want_k) <= DECODE_REL


@pytest.mark.gpu
def test_t2i_flash_kv_kernel_matches_plain_bf16(sam_decoder_bf16):
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv, t2i_flash_kv_plain

    fa = sam_decoder_bf16.transformer.final_attn_t2i
    x = decode_inputs(8)
    q_tok = x["tokens"][..., :128].contiguous()
    args = (x["rows"], fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, x["kpe"], q_tok, 8)
    with torch.no_grad():
        before = t2i_flash_kv.launches
        got = t2i_flash_kv(*args)
        torch.cuda.synchronize()
        assert t2i_flash_kv.launches == before + 2
        assert rel_err(got, t2i_flash_kv_plain(*args)) <= DECODE_REL


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3])
def test_decoder_tail_kernel_matches_plain_bf16(sam_decoder_bf16, m):
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail, decoder_tail_plain

    up = sam_decoder_bf16.output_upscaling
    g = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn(4, 64, 64, 256, generator=g, device="cuda").to(torch.bfloat16)
    hyper = torch.randn(4, m, 32, generator=g, device="cuda").to(torch.bfloat16)
    args = (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b,
            hyper)
    with torch.no_grad():
        before = decoder_tail.launches
        got = decoder_tail(*args)
        torch.cuda.synchronize()
        assert decoder_tail.launches == before + 1 and got.shape == (4, m, 256, 256)
        assert rel_err(got, decoder_tail_plain(*args)) <= DECODE_REL


@pytest.mark.gpu
def test_decoder_kernels_refuse_other_geometry(sam_decoder_bf16):
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer

    lp = sam_decoder_bf16.transformer.layers[0]
    x = decode_inputs(2, N=100)
    with pytest.raises(ValueError, match="N % 64"):
        two_way_layer(lp, x["tokens"], x["tokens"], x["rows"], x["kpe"], x["qpe"], True)
    x = decode_inputs(2)
    with pytest.raises(TypeError, match="bf16"):
        two_way_layer(lp, x["tokens"].float(), x["tokens"].float(), x["rows"], x["kpe"],
                      x["qpe"], True)


# ---------------------------------------------------------------------------
# training through the kernels: K6b against its plain version; K4, K5 and K6
# pass their gradients (K6 through K6b, K4 and K5 through their plain
# versions' recompute); K1, K2 and K3 refuse to be differentiated
# ---------------------------------------------------------------------------


def bf16_leaves(g, *shapes, scale=1.0):
    return [(scale * torch.randn(*s, generator=g, device="cuda")).to(torch.bfloat16)
            .requires_grad_() for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W", [(2, 8, 8), (3, 14, 14), (1, 64, 64), (2, 5, 13)],
                         ids=["grid8", "window14", "global", "rect"])
def test_vit_attention_relpos_bwd_kernel_matches_plain_bf16(cuda_device, B, H, W):
    """K6b against its plain backward on the same bf16 inputs: dqkv, drel_h
    and drel_w within 2e-2 of their max |plain| (the kernel's fp32 sums run
    tile by tile)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    N, heads = H * W, 12
    qkv = torch.randn(B, N, 3 * 768, generator=g, device=cuda_device).to(torch.bfloat16)
    rel_h = (0.3 * torch.randn(B, heads, N, H, generator=g, device=cuda_device)).to(torch.bfloat16)
    rel_w = (0.3 * torch.randn(B, heads, N, W, generator=g, device=cuda_device)).to(torch.bfloat16)
    do = torch.randn(B, N, 768, generator=g, device=cuda_device).to(torch.bfloat16)
    before = vit_attention_relpos_bwd.launches
    got = vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, heads, (H, W))
    torch.cuda.synchronize()
    assert vit_attention_relpos_bwd.launches == before + 1
    want = vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, heads, (H, W))
    for name, a, b in zip(("dqkv", "drel_h", "drel_w"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= DECODE_REL, (name, rel_err(a, b))


def grads_of(fn, leaves, seed):
    """The gradients of sum(fn(*leaves) * r) for a fixed random r."""
    out = fn(*leaves)
    g = torch.Generator(device=out.device).manual_seed(seed)
    r = torch.randn(out.shape, generator=g, device=out.device).to(out.dtype)
    return torch.autograd.grad(out, leaves, r)


@pytest.mark.gpu
def test_kernels_pass_gradients_as_their_plain_versions(cuda_device):
    """K5, K4 and K6 on bf16 inputs that require grad: every gradient is
    non-zero and agrees with autograd through the plain version (K6's comes
    from K6b)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    cases = {
        "layer_norm": (lambda x, s, b: layer_norm(x, s, b, 1e-6),
                       lambda x, s, b: layer_norm_plain(x, s, b, 1e-6),
                       bf16_leaves(g, (64, 768), (768,), (768,))),
        "attention_seq_qkv": (lambda q: attention_seq_qkv(q, 12),
                              lambda q: attention_seq_qkv_plain(q, 12),
                              bf16_leaves(g, (2, 100, 3 * 768))),
        "vit_attention_relpos": (
            lambda q, h, w: vit_attention_relpos(q, h, w, 12, (14, 14)),
            lambda q, h, w: vit_attention_relpos_plain(q, h, w, 12, (14, 14)),
            bf16_leaves(g, (2, 196, 3 * 768)) + bf16_leaves(g, (2, 12, 196, 14),
                                                            (2, 12, 196, 14), scale=0.3)),
    }
    for name, (kernel, plain, leaves) in cases.items():
        before = kernel_counts()
        got = grads_of(kernel, leaves, 3)
        torch.cuda.synchronize()
        assert kernel_counts()[name] > before[name], name
        want = grads_of(plain, leaves, 3)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a is not None and a.abs().max() > 0, (name, i)
            assert rel_err(a, b) <= DECODE_REL, (name, i, rel_err(a, b))


def kernel_counts():
    return {"layer_norm": layer_norm.launches, "attention_seq_qkv": attention_seq_qkv.launches,
            "vit_attention_relpos": vit_attention_relpos.launches}


@pytest.mark.gpu
def test_decoder_kernels_refuse_grad(sam_decoder_bf16):
    """K1, K2 and K3 have no backward (nor have cor_tpu's): with autograd
    recording they raise, and under no_grad they run."""
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer

    x = decode_inputs(2)
    lp = sam_decoder_bf16.transformer.layers[0]
    fa = sam_decoder_bf16.transformer.final_attn_t2i
    up = sam_decoder_bf16.output_upscaling
    src = x["rows"].reshape(2, 64, 64, 256)
    hyper = torch.zeros(2, 1, 32, device="cuda", dtype=torch.bfloat16)
    calls = [
        lambda: two_way_layer(lp, x["tokens"], x["tokens"], x["rows"], x["kpe"], x["qpe"], True),
        lambda: t2i_flash_kv(x["rows"], fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b,
                             x["kpe"], x["tokens"][..., :128].contiguous(), 8),
        lambda: decoder_tail(src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w,
                             up.convt2.b, hyper),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()
    torch.cuda.synchronize()
