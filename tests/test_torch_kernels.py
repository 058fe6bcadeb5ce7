"""cor_tpu_torch's kernel modules against cor_tpu's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; those are
held here against cor_tpu's kernels run the way cor_tpu's own tests run them
on the CPU (Pallas interpret mode, or cor_tpu's XLA fallback), at cor_tpu's
kernel-test tolerance (tests/test_pallas_kernels.py, test_kernel_vjp.py):
atol = rtol = 1e-5 in fp32.

The tests marked ``gpu`` hold each CUDA kernel against its plain version in
bf16 and in fp32 (the fp32 kernels at cor_tpu's fp32 tolerances) at the
serving path's shapes; they skip without a CUDA card. A machine
with a card but without jax runs them with

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest

which is why this file imports jax and cor_tpu only inside the CPU tests.
"""

import numpy as np
import pytest
import torch

from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
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
    vit_attention_relpos_windows,
    vit_attention_relpos_windows_plain,
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


def vit_inputs(rng, B, H, W, heads=2, D=64):
    """qkv [B, N, 3C] and bias factors [B, heads, N, H|W] (x0.3), head_dim D."""
    N, C = H * W, heads * D
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


@pytest.mark.parametrize("H,W", [(4, 4), (5, 5)], ids=["grid4", "grid5"])
def test_vit_attention_relpos_bwd_plain_at_head_dim_80_matches_pallas(rng, H, W):
    """K6b's plain version at sam_huge's head_dim 80 against cor_tpu's
    flash-backward kernel reached as cor_tpu reaches it there: through the
    lane-pad shim (each head padded 80 -> 128, the scale 80^-1/2 passed),
    as the VJP of K6's custom_vjp (Pallas interpret mode). 2 heads of 80,
    fp32, at the head_dim-64 case's tolerance."""
    import jax
    import jax.numpy as jnp

    from cor_tpu.ops.pallas.lane_pad import crop_heads, pad_qkv_heads
    from cor_tpu.ops.pallas.vit_attention import vit_attention_relpos_pallas

    qkv, rel_h, rel_w = vit_inputs(rng, 2, H, W, D=80)
    do = rng.standard_normal((2, H * W, 160)).astype(np.float32)
    n = np.arange(H * W)
    eh = jnp.asarray((np.arange(H)[:, None] == (n // W)[None, :]).astype(np.float32))
    ew = jnp.asarray((np.arange(W)[:, None] == (n % W)[None, :]).astype(np.float32))

    def shim(q, rh, rw):
        out = vit_attention_relpos_pallas(pad_qkv_heads(q, 2, 80), rh, rw, eh, ew, 2,
                                          scale=80**-0.5)
        return crop_heads(out, 2, 80)

    _, vjp = jax.vjp(shim, *map(jnp.asarray, (qkv, rel_h, rel_w)))
    want = vjp(jnp.asarray(do))
    xs = [torch.from_numpy(a) for a in (qkv, rel_h, rel_w, do)]
    before = vit_attention_relpos_bwd.launches
    got = vit_attention_relpos_bwd(*xs, 2, (H, W))  # the CPU takes the plain version
    assert vit_attention_relpos_bwd.launches == before
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("hw", [10, 8], ids=["padded10", "exact8"])
def test_vit_attention_relpos_windows_plain_matches_cor_tpu(rng, hw, D):
    """K7's plain version, reached through the port's ``attention_2d_fused``
    with ``window=4`` (x padded to whole windows, the fused QKV over the
    padded grid, the factors per grid token), against cor_tpu's
    ``attention_2d_fused(..., window=4)``: at head_dim 64 its K7 (Pallas
    interpret mode), at 80 its partition + ``attention_2d`` fallback (the
    same function). A 10 x 10 grid (padded to 12 x 12: pad tokens are keys)
    and an exact 8 x 8 one, rel-pos tables filled, at cor_tpu's K6 test
    tolerance 2e-4; the port's plain K7 equals K6's plain version on the
    partitioned windows."""
    import jax
    import jax.numpy as jnp

    import cor_tpu.ops.attention as jatt
    from cor_tpu_torch.ops import attention as patt
    from cor_tpu_torch.utils.weights import load_cor_tpu_params

    C = 2 * D
    jp = jax.tree.map(np.asarray, jatt.init_attention_2d(
        jax.random.PRNGKey(4), C, 2, use_rel_pos=True, input_size=(4, 4)))
    for key in ("rel_pos_h", "rel_pos_w"):
        jp[key] = (0.3 * rng.standard_normal(jp[key].shape)).astype(np.float32)
    x = (0.5 * rng.standard_normal((2, hw, hw, C))).astype(np.float32)
    want = np.asarray(jatt.attention_2d_fused(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), 2,
                                              window=4))
    pp = load_cor_tpu_params(patt.Attention2d(C, 2, (4, 4)), jp)
    before = vit_attention_relpos_windows.launches
    with torch.no_grad():
        got = patt.attention_2d_fused(pp, torch.from_numpy(x), 2, window=4)
        # the kernel-level plain version against K6's on the windows
        xp = torch.nn.functional.pad(torch.from_numpy(x), (0, 0, 0, -hw % 4, 0, -hw % 4))
        qkv = pp.qkv(xp)
        rel_h, rel_w = patt.window_rel_pos_factors(pp, qkv[..., :C], 4, 2)
        k7 = vit_attention_relpos_windows_plain(qkv, rel_h, rel_w, 2, 4, (hw, hw))
        qkv_w, pad = patt.window_partition(qkv, 4)
        fh, fw = patt.rel_pos_factors(pp, qkv_w[..., :C].reshape(-1, 16, C), (4, 4), 2)
        k6 = vit_attention_relpos_plain(qkv_w.reshape(-1, 16, 3 * C), fh, fw, 2, (4, 4))
        k6 = patt.window_unpartition(k6.reshape(-1, 4, 4, C), 4, pad, (hw, hw))
    assert vit_attention_relpos_windows.launches == before  # the CPU takes the plain version
    assert got.shape == (2, hw, hw, C)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(k7.numpy(), k6.numpy(), atol=1e-6, rtol=1e-6)


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty(4, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        layer_norm(x, torch.empty(128, device="meta"), torch.empty(128, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        attention_seq_qkv(torch.empty(1, 4, 384, device="meta"), 2)
    with pytest.raises(ValueError, match="no kernel"):
        rel = torch.empty(1, 2, 4, 2, device="meta")
        vit_attention_relpos(torch.empty(1, 4, 384, device="meta"), rel, rel, 2, (2, 2))


def current_declarations():
    """{entry: [parameter names]} of the ``extern "C"`` entries in ``csrc/``."""
    import re

    from cor_tpu_torch.ops.kernels import _build

    text = "".join(p.read_text() for p in sorted(_build.CSRC_DIR.glob("*.cu")))
    return text, {m.group(1): [a.split()[-1].lstrip("*") for a in m.group(2).split(",")]
                  for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text)}


def test_kernel_bits_knows_where_the_optional_parameters_sit():
    """tools/kernel_bits.py drops f32 and n_tok by position for an older
    ``csrc/``: each position is that parameter's in the current entries, and
    every entry is declared with the signature's length."""
    from cor_tpu_torch.ops.kernels import _build
    from cor_tpu_torch.tools import kernel_bits as kb

    _, decls = current_declarations()
    assert set(decls) == set(_build._SIGNATURES)
    for name, sig in _build._SIGNATURES.items():
        assert len(decls[name]) == len(sig), name
    for name, params in kb._OPTIONAL.items():
        for param, pos, _ in params:
            assert decls[name][pos] == param, (name, param, decls[name])


def test_kernel_bits_calls_an_older_abi_without_n_tok(tmp_path):
    """Declarations without n_tok (the decoder's ABI at 6 tokens): the old
    entries are called with it dropped, and with another count they raise."""
    import re

    from cor_tpu_torch.tools import kernel_bits as kb

    text, _ = current_declarations()
    (tmp_path / "old.cu").write_text(re.sub(r",\s*int n_tok", "", text))
    missing = kb.lacking(tmp_path)
    decoder = {"cor_twl_tokens_in", "cor_t2i_image_pass", "cor_twl_tokens_mid",
               "cor_twl_image_i2t", "cor_t2i_combine"}
    assert {n: [p for p, _, _ in ps] for n, ps in missing.items()} == {
        n: ["n_tok"] for n in decoder}
    got = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: got.append((name, args)) or 0

    old = kb._OldABI(Lib(), missing)
    # part_m, part_l, part_acc, tiles, n, n_tok, out, f32, stream
    old.cor_t2i_combine("m", "l", "acc", 64, 40, 6, "out", 0, "s")
    assert got == [("cor_t2i_combine", ("m", "l", "acc", 64, 40, "out", 0, "s"))]
    with pytest.raises(TypeError, match="n_tok = 6"):
        old.cor_t2i_combine("m", "l", "acc", 64, 40, 9, "out", 0, "s")
    old.cor_layer_norm(1, 2)  # an entry the old ABI has as it is
    assert got[-1] == ("cor_layer_norm", (1, 2))


def test_vit_attention_relpos_windows_refuses_devices_without_a_kernel():
    """K7 on a device other than the CPU and the card raises."""
    rel = torch.empty(1, 2, 16, 2, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        vit_attention_relpos_windows(torch.empty(1, 4, 4, 384, device="meta"), rel, rel, 2, 2,
                                     (3, 3))


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
@pytest.mark.parametrize("d,n", [(64, 576), (64, 64), (64, 100), (72, 729), (72, 64), (80, 100)],
                         ids=["d64-n576", "d64-n64", "d64-n100", "d72-n729", "d72-n64",
                              "d80-n100"])
def test_attention_seq_qkv_kernel_matches_plain_bf16(cuda_device, d, n):
    """K4 / K4′ off the fused QKV at the towers' shapes: ViT-B's 12 heads
    of 64 (N 576, 64, ragged 100), SO400M's 16 heads of 72 (N 729 =
    11 * 64 + 25, 64) and 16 heads of 80."""
    heads = 12 if d == 64 else 16
    g = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn(16, n, 3 * heads * d, generator=g, device=cuda_device).to(torch.bfloat16)
    before = attention_seq_qkv.launches
    got = attention_seq_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert attention_seq_qkv.launches == before + 1
    # the online softmax rounds P to bf16 at other places than the plain version
    torch.testing.assert_close(
        got.float(), attention_seq_qkv_plain(qkv, heads).float(), atol=2e-2, rtol=0
    )


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(72, 729), (80, 100), (64, 64)])
def test_attention_seq_kernel_matches_plain_bf16(cuda_device, d, n):
    """K4′'s own entry over [B, H, N, D] (the kernel through strides)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    q, k, v = (torch.randn(4, 16, n, d, generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    before = attention_seq.launches
    got = attention_seq(q, k, v, 16)
    torch.cuda.synchronize()
    assert attention_seq.launches == before + 1
    torch.testing.assert_close(got.float(), attention_seq_plain(q, k, v, 16).float(), atol=2e-2,
                               rtol=0)


@pytest.mark.gpu
def test_attention_seq_qkv_kernel_refuses_other_head_dims(cuda_device):
    qkv = torch.zeros(1, 8, 3 * 1536, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP Queue 2, K4′"):
        attention_seq_qkv(qkv, 16)  # head_dim 96
    q = torch.zeros(1, 16, 8, 96, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="ROADMAP Queue 2, K4′"):
        attention_seq(q, q, q, 16)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,d", [(1, 64, 64, 64), (50, 14, 14, 64), (1, 64, 64, 80),
                                     (50, 14, 14, 80)],
                         ids=["global", "windowed", "global-d80", "windowed-d80"])
def test_vit_attention_relpos_kernel_matches_plain_bf16(cuda_device, B, H, W, d):
    """K6 at SAM-base's shapes (12 heads of 64) and sam_huge's (16 heads of
    80, scale 80^-1/2, dynamic shared memory): a global block of one image
    (N = 4096) and the 50 windows of two images (N = 196, the last key tile
    masked after 4 keys). Both round q * scale and P to bf16 at the same
    points; the online softmax sums in another order: max |d| / max |plain|
    <= 2e-2."""
    heads = 12 if d == 64 else 16
    g = torch.Generator(device=cuda_device).manual_seed(0)
    N, bf = H * W, torch.bfloat16
    qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=cuda_device).to(bf)
    rel_h = (0.3 * torch.randn(B, heads, N, H, generator=g, device=cuda_device)).to(bf)
    rel_w = (0.3 * torch.randn(B, heads, N, W, generator=g, device=cuda_device)).to(bf)
    before = vit_attention_relpos.launches
    got = vit_attention_relpos(qkv, rel_h, rel_w, heads, (H, W))
    torch.cuda.synchronize()
    assert vit_attention_relpos.launches == before + 1
    want = vit_attention_relpos_plain(qkv, rel_h, rel_w, heads, (H, W))
    assert rel_err(got, want) <= DECODE_REL


@pytest.mark.gpu
def test_vit_attention_relpos_kernel_refuses_other_head_dims(cuda_device):
    """K6, K6b and K7 take head_dim 64 and 80: at 80 (sam_huge) a forward
    that records a gradient runs, and its backward is K6b; any other
    head_dim raises, naming the ROADMAP row."""
    rel = torch.zeros(1, 16, 16, 4, device=cuda_device, dtype=torch.bfloat16)
    qkv = torch.zeros(1, 16, 3 * 1536, device=cuda_device, dtype=torch.bfloat16)
    do96 = torch.zeros(1, 16, 1536, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims other than 64 and 80"):
        vit_attention_relpos(qkv, rel, rel, 16, (4, 4))  # head_dim 96
    with pytest.raises(ValueError, match="head dims other than 64 and 80"):
        vit_attention_relpos_bwd(qkv, rel, rel, do96, 16, (4, 4))
    with pytest.raises(ValueError, match="head dims other than 64 and 80"):
        vit_attention_relpos_windows(qkv.reshape(1, 4, 4, -1), rel, rel, 16, 4, (4, 4))
    qkv = torch.zeros(1, 16, 3 * 1280, device=cuda_device, dtype=torch.bfloat16)
    out = vit_attention_relpos(qkv, rel, rel, 16, (4, 4))  # sam_huge: head_dim 80
    assert out.shape == (1, 16, 1280)
    before = vit_attention_relpos_bwd.launches
    leaf = qkv.clone().requires_grad_()
    vit_attention_relpos(leaf, rel, rel, 16, (4, 4)).float().sum().backward()
    torch.cuda.synchronize()
    assert vit_attention_relpos_bwd.launches == before + 1 and leaf.grad.shape == qkv.shape


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
    from cor_tpu_torch.ops.kernels.t2i_flash import FINAL_LAUNCHES, t2i_flash_kv, t2i_flash_kv_plain

    fa = sam_decoder_bf16.transformer.final_attn_t2i
    x = decode_inputs(8)
    q_tok = x["tokens"][..., :128].contiguous()
    args = (x["rows"], fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, x["kpe"], q_tok, 8)
    with torch.no_grad():
        before = t2i_flash_kv.launches
        got = t2i_flash_kv(*args)
        torch.cuda.synchronize()
        assert t2i_flash_kv.launches == before + FINAL_LAUNCHES
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


@pytest.mark.gpu
@pytest.mark.parametrize("grid,tokens,want", [(16, 6, "@grid"), (48, 9, "@grid"),
                                              (64, 33, "@T>32")])
def test_fused_decode_refuses_other_geometry_before_any_kernel(sam_decoder_bf16, grid, tokens,
                                                               want):
    """On the card, ``mask_decoder(fused=True)`` refuses what the decoder
    kernels do not take (a grid other than 64 wide, more than 32 tokens),
    naming its ROADMAP row, before any kernel is launched."""
    from cor_tpu_torch.models.sam_decoder import mask_decoder
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
    from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash, t2i_flash_kv
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer

    wrappers = (two_way_layer, t2i_flash_kv, decoder_tail, proj_q_t2i_flash, i2t_attention_fused)
    before = [w.launches for w in wrappers]
    emb = torch.zeros(1, grid, grid, 256, device="cuda", dtype=torch.bfloat16)
    sparse = torch.zeros(1, tokens - 5, 256, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(ValueError, match=want):
        mask_decoder(sam_decoder_bf16, emb, emb, sparse, emb, False)
    assert [w.launches for w in wrappers] == before


# ---------------------------------------------------------------------------
# SAM's stock prompts: K1 at 5, 7 and 8 tokens, K2 at 5 to 32, K8a and K8b
# (above 8 tokens) against their plain versions, bf16 (max |d| / max |plain|
# <= 2e-2) and fp32 (cor_tpu's fp32 tolerances: K1 and K8b 2e-4, K2 and K8a
# 5e-4), and the fused mask decode at every route
# ---------------------------------------------------------------------------


def token_inputs(T, dtype, n=4, N=4096, seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed + T)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    return dict(tokens=rnd(n, T, 256).to(dtype), rows=(0.5 * rnd(n, N, 256)).to(dtype),
                kpe=(0.5 * rnd(N, 128)).to(dtype), qpe=(0.5 * rnd(N, 128)).to(dtype),
                q_img=(0.5 * rnd(n, N, 128)).to(dtype), k_tok=rnd(n, T, 128).to(dtype),
                v_tok=rnd(n, T, 128).to(dtype))


def close_at(dtype, got, want, tol32):
    if dtype == torch.bfloat16:
        assert rel_err(got, want) <= DECODE_REL
    else:
        fp32_close(got, want, tol32)


def decoder_at(dtype):
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder

    return init_mask_decoder(CoreConfig(), 1).to("cuda", dtype).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", ["int8", "pe"])
@pytest.mark.parametrize("T", [5, 7, 8])
def test_two_way_layer_kernel_at_tokens_matches_plain(fp32_device, T, case, dtype):
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain

    dec = decoder_at(dtype)
    lp = dec.transformer.layers[0 if case == "int8" else 1]
    x = token_inputs(T, dtype)
    keys, kw = x["rows"], {}
    if case == "int8":
        f = keys.float()
        scale = (f.abs().amax(dim=(1, 2)) / 127.0).clamp_min(1e-12)
        keys = torch.clamp(torch.round(f / scale[:, None, None]), -127, 127).to(torch.int8)
        kw = dict(idx=torch.tensor([3, 0, 2, 2], dtype=torch.int32, device="cuda"), scale=scale)
    args = (lp, x["tokens"], x["tokens"], keys, x["kpe"], x["qpe"], case == "int8")
    with torch.no_grad():
        before = two_way_layer.launches + two_way_layer.launches_fp32
        got_t, got_k = two_way_layer(*args, **kw)
        torch.cuda.synchronize()
        assert two_way_layer.launches + two_way_layer.launches_fp32 == before + 4
        want_t, want_k = two_way_layer_plain(*args, **kw)
    assert got_t.shape == (4, T, 256)
    close_at(dtype, got_t, want_t, 2e-4)
    close_at(dtype, got_k, want_k, 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("T", [5, 7, 8, 9, 16, 17, 32])
def test_t2i_flash_kv_kernel_at_tokens_matches_plain(fp32_device, T, dtype):
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv, t2i_flash_kv_plain

    fa = decoder_at(dtype).transformer.final_attn_t2i
    x = token_inputs(T, dtype)
    args = (x["rows"], fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, x["kpe"],
            x["k_tok"], 8)
    with torch.no_grad():
        got = t2i_flash_kv(*args)
        torch.cuda.synchronize()
        close_at(dtype, got, t2i_flash_kv_plain(*args), 5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("T", [9, 16, 17, 32])
def test_proj_q_t2i_flash_kernel_matches_plain(fp32_device, T, dtype):
    """K8a; at 17 tokens and above its bf16 logits leave the weight block's
    space for their own."""
    from cor_tpu_torch.ops.kernels.t2i_flash import (
        LAUNCHES,
        proj_q_t2i_flash,
        proj_q_t2i_flash_plain,
    )

    lp = decoder_at(dtype).transformer.layers[1]
    t2i, i2t = lp.cross_attn_t2i, lp.cross_attn_i2t
    x = token_inputs(T, dtype)
    args = (x["rows"], t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b, i2t.q_proj.w,
            i2t.q_proj.b, x["kpe"], x["qpe"], x["k_tok"], 8)
    with torch.no_grad():
        before = proj_q_t2i_flash.launches + proj_q_t2i_flash.launches_fp32
        got_q, got_a = proj_q_t2i_flash(*args)
        torch.cuda.synchronize()
        assert proj_q_t2i_flash.launches + proj_q_t2i_flash.launches_fp32 == before + LAUNCHES
        want_q, want_a = proj_q_t2i_flash_plain(*args)
    assert got_q.shape == (4, 4096, 128) and got_a.shape == (4, T, 128)
    close_at(dtype, got_q, want_q, 5e-4)
    close_at(dtype, got_a, want_a, 5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("T", [9, 16, 32, "stability"])
def test_i2t_attention_fused_kernel_matches_plain(fp32_device, T, dtype):
    """K8b; "stability": cor_tpu's per-head case (tests/test_pallas_kernels.py:
    76-119), head 0's keys biased by +300 so that its logits sit hundreds
    above the other heads', at 9 tokens."""
    from cor_tpu_torch.ops.kernels.i2t_attention import (
        i2t_attention_fused,
        i2t_attention_fused_plain,
    )

    lp = decoder_at(dtype).transformer.layers[0]
    i2t = lp.cross_attn_i2t
    x = token_inputs(9 if T == "stability" else T, dtype)
    q_img, k_tok = x["q_img"], x["k_tok"]
    if T == "stability":
        k_tok = k_tok.float()
        k_tok[..., :16] += 300.0
        k_tok = k_tok.to(dtype)
    args = (q_img, x["rows"], k_tok, x["v_tok"], i2t.out_proj.w, i2t.out_proj.b,
            lp.norm4.scale, lp.norm4.bias, 8)
    with torch.no_grad():
        before = i2t_attention_fused.launches + i2t_attention_fused.launches_fp32
        got = i2t_attention_fused(*args)
        torch.cuda.synchronize()
        assert i2t_attention_fused.launches + i2t_attention_fused.launches_fp32 == before + 1
        want = i2t_attention_fused_plain(*args)
    assert torch.isfinite(got).all()
    close_at(dtype, got, want, 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("sparse", [0, 3, 27])
def test_mask_decoder_fused_at_tokens_matches_plain(fp32_device, monkeypatch, sparse, dtype):
    """The fused mask decode at 5, 8 (K1) and 32 tokens (K8a/K8b), every
    kernel launched as the route says, against the same decode through the
    kernels' plain versions."""
    from cor_tpu_torch.models import sam_decoder as psd
    from cor_tpu_torch.ops.kernels import decoder_tail as dt_mod
    from cor_tpu_torch.ops.kernels import i2t_attention as i2t_mod
    from cor_tpu_torch.ops.kernels import t2i_flash as t2i_mod
    from cor_tpu_torch.ops.kernels import two_way_layer as twl_mod

    dec = decoder_at(dtype)
    g = torch.Generator(device="cuda").manual_seed(sparse)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)  # noqa: E731
    img, pe, prompts = 0.5 * rnd(2, 64, 64, 256), 0.5 * rnd(1, 64, 64, 256), rnd(2, sparse, 256)
    wrappers = (twl_mod.two_way_layer, t2i_mod.t2i_flash_kv, t2i_mod.proj_q_t2i_flash,
                i2t_mod.i2t_attention_fused, dt_mod.decoder_tail)
    with torch.no_grad():
        before = [w.launches + w.launches_fp32 for w in wrappers]
        got = psd.mask_decoder(dec, img, pe, prompts, None, True)
        torch.cuda.synchronize()
        counts = [w.launches + w.launches_fp32 - b for w, b in zip(wrappers, before)]
        k2 = t2i_mod.FINAL_LAUNCHES
        k8a = 2 * t2i_mod.LAUNCHES
        assert counts == ([8, k2, 0, 0, 1] if sparse <= 3 else [0, k2, k8a, 2, 1])
        # the same decode with the kernels' plain versions in their place
        for mod, name in ((twl_mod, "two_way_layer"), (t2i_mod, "t2i_flash_kv"),
                          (t2i_mod, "proj_q_t2i_flash"), (i2t_mod, "i2t_attention_fused"),
                          (dt_mod, "decoder_tail")):
            monkeypatch.setattr(psd, name, getattr(mod, f"{name}_plain"))
        want = psd.mask_decoder(dec, img, pe, prompts, None, True)
    assert got[0].shape == (2, 3, 256, 256)
    close_at(dtype, got[0], want[0], 5e-4)


# ---------------------------------------------------------------------------
# the opt-in decode schedules: K1-dma against K1 bit for bit; K1-stack and
# K1-grid against their plain version (bf16 2e-2, fp32 cor_tpu's transformer
# tolerance 5e-4) and K1-grid's keys against two K1 launches bit for bit;
# what they refuse, before any launch; the fused decode under each flag
# ---------------------------------------------------------------------------


def schedule_inputs(dtype, T, n=4, S=8, seed=5):
    g = torch.Generator(device="cuda").manual_seed(seed + T)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    store = 0.5 * rnd(S, 4096, 256)
    scale = (store.abs().amax(dim=(1, 2)) / 127.0).clamp_min(1e-12)
    store8 = torch.clamp(torch.round(store / scale[:, None, None]), -127, 127).to(torch.int8)
    return dict(tokens=rnd(n, T, 256).to(dtype), rows=(0.5 * rnd(n, 4096, 256)).to(dtype),
                store=store.to(dtype), store8=store8, scale=scale,
                idx=torch.tensor([5, 0, 7, 2], dtype=torch.int32, device="cuda")[:n],
                pes=[(0.5 * rnd(4096, 128)).to(dtype) for _ in range(5)])


def both_launches(fn):
    return fn.launches + fn.launches_fp32


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("case", ["rows", "store", "int8"])
@pytest.mark.parametrize("T", [5, 8])
def test_two_way_layer_dma_kernel_equals_k1(fp32_device, T, case, dtype):
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_dma

    lp = decoder_at(dtype).transformer.layers[0]
    x = schedule_inputs(dtype, T)
    rows, kw = {"rows": (x["rows"], {}), "store": (x["store"], dict(idx=x["idx"])),
                "int8": (x["store8"], dict(idx=x["idx"], scale=x["scale"]))}[case]
    args = (lp, x["tokens"], x["tokens"], rows, x["pes"][0], x["pes"][1], True)
    with torch.no_grad():
        before = both_launches(two_way_layer_dma)
        got = two_way_layer_dma(*args, **kw)
        torch.cuda.synchronize()
        assert both_launches(two_way_layer_dma) == before + 4
        want = two_way_layer(*args, **kw)
        torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("indexed", [False, True], ids=["rows", "store"])
@pytest.mark.parametrize("kind", ["stack", "grid"])
def test_two_way_stack_and_grid_kernels_match_plain(fp32_device, kind, indexed, dtype):
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer
    from cor_tpu_torch.ops.kernels import two_way_stack as tws

    p = decoder_at(dtype).transformer
    x = schedule_inputs(dtype, 6)
    rows, kw = (x["store"], dict(idx=x["idx"])) if indexed else (x["rows"], {})
    pes = x["pes"]
    args = (p, x["tokens"], x["tokens"], rows, pes[:2], pes[2:4], pes[4])
    fn = tws.two_way_grid_fused if kind == "grid" else tws.two_way_stack_fused
    with torch.no_grad():
        before = both_launches(fn)
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        assert both_launches(fn) == before + 1
        want = tws.two_way_stack_plain(*args, **kw, round_between_layers=kind == "grid")
        if kind == "grid":
            t1, k1 = two_way_layer(p.layers[0], x["tokens"], x["tokens"], rows, pes[0], pes[2],
                                   True, **kw)
            k2 = two_way_layer(p.layers[1], t1, x["tokens"], k1, pes[1], pes[3], False)[1]
            torch.cuda.synchronize()
            assert torch.equal(got[1], k2)
    for g, w in zip(got, want):
        close_at(dtype, g, w, 5e-4)


@pytest.mark.gpu
def test_decode_schedules_refuse_before_any_kernel(fp32_device):
    """K1-stack and K1-grid take no int8 store (cor_tpu's neither); the three
    take K1's geometry; each refusal comes before any launch."""
    from cor_tpu_torch.ops.kernels import two_way_stack as tws
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer_dma

    p = decoder_at(torch.bfloat16).transformer
    x = schedule_inputs(torch.bfloat16, 6)
    pes = x["pes"]
    wrappers = (two_way_layer_dma, tws.two_way_stack_fused, tws.two_way_grid_fused)
    before = [both_launches(w) for w in wrappers]
    with torch.no_grad():
        for fn in (tws.two_way_stack_fused, tws.two_way_grid_fused):
            with pytest.raises(TypeError, match="int8"):
                fn(p, x["tokens"], x["tokens"], x["store8"], pes[:2], pes[2:4], pes[4],
                   idx=x["idx"])
            with pytest.raises(ValueError, match="5 to 8 tokens"):
                t9 = torch.zeros(4, 9, 256, device="cuda", dtype=torch.bfloat16)
                fn(p, t9, t9, x["rows"], pes[:2], pes[2:4], pes[4])
            with pytest.raises(ValueError, match="depth 2"):
                fn(p, x["tokens"], x["tokens"], x["rows"], pes[:1], pes[2:3], pes[4])
        with pytest.raises(ValueError, match="N % 64"):
            two_way_layer_dma(p.layers[0], x["tokens"], x["tokens"], x["rows"][:, :100],
                              pes[0][:100], pes[1][:100], True)
    assert [both_launches(w) for w in wrappers] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("flag", ["DMA_FUSED", "STACK_FUSED", "GRID_FUSED", "GRID+int8"])
def test_mask_decoder_schedules_launch_as_routed(fp32_device, monkeypatch, flag, dtype):
    """The fused mask decode of 2 candidates at 6 tokens under each flag:
    K1-dma 8 launches with K2 and K3, K1-stack or K1-grid 1 with K3; an int8
    store with GRID_FUSED runs K1. Its masks against the same decode through
    the plain versions."""
    from cor_tpu_torch.models import sam_decoder as psd
    from cor_tpu_torch.ops.kernels import decoder_tail as dt_mod
    from cor_tpu_torch.ops.kernels import t2i_flash as t2i_mod
    from cor_tpu_torch.ops.kernels import two_way_layer as twl_mod
    from cor_tpu_torch.ops.kernels import two_way_stack as tws

    monkeypatch.setattr(psd, "GRID_FUSED" if flag == "GRID+int8" else flag, True)
    dec = decoder_at(dtype)
    g = torch.Generator(device="cuda").manual_seed(7)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    pe, prompts = (0.5 * rnd(1, 64, 64, 256)).to(dtype), rnd(2, 1, 256).to(dtype)
    kw = {}
    if flag.endswith("int8"):
        store = 0.5 * rnd(3, 64, 64, 256)
        scale = (store.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
        img = torch.clamp(torch.round(store / scale[:, None, None, None]), -127, 127).to(
            torch.int8)
        kw = dict(store_idx=torch.tensor([2, 0], dtype=torch.int32, device="cuda"),
                  store_scale=scale)
        dense = None
    else:
        img, dense = (0.5 * rnd(2, 64, 64, 256)).to(dtype), (0.1 * rnd(2, 64, 64, 256)).to(dtype)
    wrappers = {"two_way_layer": twl_mod.two_way_layer,
                "two_way_layer_dma": twl_mod.two_way_layer_dma,
                "two_way_stack_fused": tws.two_way_stack_fused,
                "two_way_grid_fused": tws.two_way_grid_fused,
                "t2i_flash_kv": t2i_mod.t2i_flash_kv, "decoder_tail": dt_mod.decoder_tail}
    k2 = t2i_mod.FINAL_LAUNCHES
    want_counts = {"DMA_FUSED": {"two_way_layer_dma": 8, "t2i_flash_kv": k2, "decoder_tail": 1},
                   "STACK_FUSED": {"two_way_stack_fused": 1, "decoder_tail": 1},
                   "GRID_FUSED": {"two_way_grid_fused": 1, "decoder_tail": 1},
                   "GRID+int8": {"two_way_layer": 8, "t2i_flash_kv": k2, "decoder_tail": 1}}[flag]
    with torch.no_grad():
        before = {k: both_launches(w) for k, w in wrappers.items()}
        got = psd.mask_decoder(dec, img, pe, prompts, dense, True, **kw)
        torch.cuda.synchronize()
        counts = {k: both_launches(w) - before[k] for k, w in wrappers.items()}
        assert {k: v for k, v in counts.items() if v} == want_counts
        for mod, name in ((twl_mod, "two_way_layer"), (twl_mod, "two_way_layer_dma"),
                          (t2i_mod, "t2i_flash_kv"), (dt_mod, "decoder_tail")):
            plain = {"two_way_layer_dma": twl_mod.two_way_layer_plain}.get(
                name, getattr(mod, f"{name}_plain", None))
            monkeypatch.setattr(psd, name, plain)
        for name, rnd_l in (("two_way_stack_fused", False), ("two_way_grid_fused", True)):
            monkeypatch.setattr(psd, name, lambda *a, _r=rnd_l, **k: tws.two_way_stack_plain(
                *a, **k, round_between_layers=_r))
        want = psd.mask_decoder(dec, img, pe, prompts, dense, True, **kw)
    assert got[0].shape == (2, 3, 256, 256) and torch.isfinite(got[0].float()).all()
    close_at(dtype, got[0], want[0], 5e-4)


# ---------------------------------------------------------------------------
# training through the kernels: K6b against its plain version; K4, K5 and K6
# pass their gradients (K6 through K6b, K4 and K5 through their plain
# versions' recompute); K1, K2 and K3 refuse to be differentiated
# ---------------------------------------------------------------------------


def bf16_leaves(g, *shapes, scale=1.0):
    return [(scale * torch.randn(*s, generator=g, device="cuda")).to(torch.bfloat16)
            .requires_grad_() for s in shapes]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", [(2, 8, 8), (3, 14, 14), (1, 64, 64), (2, 5, 13)],
                         ids=["grid8", "window14", "global", "rect"])
def test_vit_attention_relpos_bwd_kernel_matches_plain_bf16(cuda_device, B, H, W, d):
    """K6b against its plain backward on the same bf16 inputs, at SAM-base's
    12 heads of 64 and sam_huge's 16 of 80 (scale 80^-1/2), given the
    forward's out and lse as autograd gives them: dqkv, drel_h and drel_w
    within 2e-2 of their max |plain| (the kernel's fp32 sums run tile by
    tile, and its delta is rowsum(do * out) over the bf16 out)."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    N, heads = H * W, (12 if d == 64 else 16)
    C, bf = heads * d, torch.bfloat16
    qkv = torch.randn(B, N, 3 * C, generator=g, device=cuda_device).to(bf)
    rel_h = (0.3 * torch.randn(B, heads, N, H, generator=g, device=cuda_device)).to(bf)
    rel_w = (0.3 * torch.randn(B, heads, N, W, generator=g, device=cuda_device)).to(bf)
    do = torch.randn(B, N, C, generator=g, device=cuda_device).to(bf)
    out, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, (H, W))
    with pytest.raises(ValueError, match="takes the forward's out and lse"):
        vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, heads, (H, W))
    before = vit_attention_relpos_bwd.launches
    got = vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, heads, (H, W), out=out, lse=lse)
    torch.cuda.synchronize()
    assert vit_attention_relpos_bwd.launches == before + 1
    want = vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, heads, (H, W))
    for name, a, b in zip(("dqkv", "drel_h", "drel_w"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.isfinite(a.float()).all(), name
        assert rel_err(a, b) <= DECODE_REL, (name, rel_err(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("D,hw", [(64, 64), (80, 64), (64, 10), (80, 14)],
                         ids=["base-64", "huge-64", "base-10", "huge-exact14"])
def test_vit_attention_relpos_windows_kernel_matches_plain_bf16(cuda_device, D, hw):
    """K7 against its plain version on the same bf16 inputs, windows of 14
    over a grid padded to whole windows (64 -> 70, 10 -> 14; 14 exact):
    within 2e-2 of max |plain|, and equal bit for bit to K6 on the
    partitioned windows (the same arithmetic); its gradient is its plain
    version's VJP."""
    from cor_tpu_torch.ops.attention import window_partition, window_unpartition

    g = torch.Generator(device=cuda_device).manual_seed(5)
    heads, ws = (12 if D == 64 else 16), 14
    C, Hp, B = heads * D, -(-hw // 14) * 14, 2
    bf = torch.bfloat16
    qkv = torch.randn(B, Hp, Hp, 3 * C, generator=g, device=cuda_device).to(bf)
    rel_h = (0.3 * torch.randn(B, heads, Hp * Hp, ws, generator=g, device=cuda_device)).to(bf)
    rel_w = (0.3 * torch.randn(B, heads, Hp * Hp, ws, generator=g, device=cuda_device)).to(bf)
    before = vit_attention_relpos_windows.launches
    got = vit_attention_relpos_windows(qkv, rel_h, rel_w, heads, ws, (hw, hw))
    torch.cuda.synchronize()
    assert vit_attention_relpos_windows.launches == before + 1 and got.shape == (B, hw, hw, C)
    want = vit_attention_relpos_windows_plain(qkv, rel_h, rel_w, heads, ws, (hw, hw))
    assert rel_err(got, want) <= DECODE_REL
    nW = (Hp // ws) ** 2
    qkv_w = window_partition(qkv, ws)[0].reshape(B * nW, ws * ws, 3 * C)
    rel = [window_partition(r.reshape(B, heads, Hp, Hp, ws).permute(0, 2, 3, 1, 4)
                            .reshape(B, Hp, Hp, heads * ws), ws)[0]
           .reshape(B * nW, ws * ws, heads, ws).transpose(1, 2).contiguous()
           for r in (rel_h, rel_w)]
    k6 = vit_attention_relpos(qkv_w, *rel, heads, (ws, ws)).reshape(B * nW, ws, ws, C)
    assert torch.equal(got, window_unpartition(k6, ws, (Hp, Hp), (hw, hw)))
    leaves = [x.clone().requires_grad_() for x in (qkv, rel_h, rel_w)]
    grads = grads_of(lambda q, h, w: vit_attention_relpos_windows(q, h, w, heads, ws, (hw, hw)),
                     leaves, 6)
    plain = grads_of(lambda q, h, w: vit_attention_relpos_windows_plain(q, h, w, heads, ws,
                                                                        (hw, hw)), leaves, 6)
    for a, b in zip(grads, plain):
        assert rel_err(a, b) <= DECODE_REL


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


# ---------------------------------------------------------------------------
# the kernels in fp32 (compute_dtype float32; 3xTF32 products) against their
# plain fp32 versions, TF32 off, at cor_tpu's fp32 tolerances (atol = rtol):
# K5, K4/K4′ 1e-5 (test_pallas_kernels.py, test_kernel_vjp.py), K6/K7 and K1
# 2e-4 (test_vit_attention_kernel.py, test_two_way_layer_kernel.py), K2 5e-4
# (its only fp32 test, through the two-way transformer), K3 2e-4
# (test_decoder_tail_kernel.py); fp32 launches are counted apart
# ---------------------------------------------------------------------------


@pytest.fixture
def fp32_device(cuda_device):
    """The card with torch's fp32 matmuls and convolutions in full fp32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield cuda_device
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp32_close(got, want, tol):
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("rows,C", [(16 * 576, 768), (8 * 4096, 256), (1001, 1152)])
def test_layer_norm_kernel_matches_plain_fp32(fp32_device, rows, C):
    g = torch.Generator(device=fp32_device).manual_seed(0)
    x = 2 * torch.randn(rows, C, generator=g, device=fp32_device) + 0.5
    s = 1 + 0.1 * torch.randn(C, generator=g, device=fp32_device)
    b = 0.1 * torch.randn(C, generator=g, device=fp32_device)
    before = (layer_norm.launches, layer_norm.launches_fp32)
    got = layer_norm(x, s, b)
    torch.cuda.synchronize()
    assert (layer_norm.launches, layer_norm.launches_fp32) == (before[0], before[1] + 1)
    fp32_close(got, layer_norm_plain(x, s, b), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(64, 576), (64, 100), (72, 729), (72, 64), (80, 100)],
                         ids=["d64-n576", "d64-n100", "d72-n729", "d72-n64", "d80-n100"])
def test_attention_seq_qkv_kernel_matches_plain_fp32(fp32_device, d, n):
    heads = 12 if d == 64 else 16
    g = torch.Generator(device=fp32_device).manual_seed(0)
    qkv = torch.randn(16, n, 3 * heads * d, generator=g, device=fp32_device)
    before = (attention_seq_qkv.launches, attention_seq_qkv.launches_fp32)
    got = attention_seq_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert (attention_seq_qkv.launches, attention_seq_qkv.launches_fp32) == (before[0],
                                                                             before[1] + 1)
    fp32_close(got, attention_seq_qkv_plain(qkv, heads), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("d,n", [(72, 729), (80, 100), (64, 64)])
def test_attention_seq_kernel_matches_plain_fp32(fp32_device, d, n):
    g = torch.Generator(device=fp32_device).manual_seed(4)
    q, k, v = (torch.randn(4, 16, n, d, generator=g, device=fp32_device) for _ in range(3))
    before = attention_seq.launches_fp32
    got = attention_seq(q, k, v, 16)
    torch.cuda.synchronize()
    assert attention_seq.launches_fp32 == before + 1
    fp32_close(got, attention_seq_plain(q, k, v, 16), 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,d", [(1, 64, 64, 64), (50, 14, 14, 64), (1, 64, 64, 80),
                                     (50, 14, 14, 80)],
                         ids=["global", "windowed", "global-d80", "windowed-d80"])
def test_vit_attention_relpos_kernel_matches_plain_fp32(fp32_device, B, H, W, d):
    heads = 12 if d == 64 else 16
    g = torch.Generator(device=fp32_device).manual_seed(0)
    N = H * W
    qkv = torch.randn(B, N, 3 * heads * d, generator=g, device=fp32_device)
    rel_h = 0.3 * torch.randn(B, heads, N, H, generator=g, device=fp32_device)
    rel_w = 0.3 * torch.randn(B, heads, N, W, generator=g, device=fp32_device)
    before = (vit_attention_relpos.launches, vit_attention_relpos.launches_fp32)
    got = vit_attention_relpos(qkv, rel_h, rel_w, heads, (H, W))
    torch.cuda.synchronize()
    assert (vit_attention_relpos.launches, vit_attention_relpos.launches_fp32) == (
        before[0], before[1] + 1)
    fp32_close(got, vit_attention_relpos_plain(qkv, rel_h, rel_w, heads, (H, W)), 2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("D,hw", [(64, 64), (80, 64), (64, 10), (80, 14)],
                         ids=["base-64", "huge-64", "base-10", "huge-exact14"])
def test_vit_attention_relpos_windows_kernel_matches_plain_fp32(fp32_device, D, hw):
    g = torch.Generator(device=fp32_device).manual_seed(5)
    heads, ws = (12 if D == 64 else 16), 14
    C, Hp, B = heads * D, -(-hw // 14) * 14, 2
    qkv = torch.randn(B, Hp, Hp, 3 * C, generator=g, device=fp32_device)
    rel_h = 0.3 * torch.randn(B, heads, Hp * Hp, ws, generator=g, device=fp32_device)
    rel_w = 0.3 * torch.randn(B, heads, Hp * Hp, ws, generator=g, device=fp32_device)
    before = vit_attention_relpos_windows.launches_fp32
    got = vit_attention_relpos_windows(qkv, rel_h, rel_w, heads, ws, (hw, hw))
    torch.cuda.synchronize()
    assert vit_attention_relpos_windows.launches_fp32 == before + 1
    fp32_close(got, vit_attention_relpos_windows_plain(qkv, rel_h, rel_w, heads, ws, (hw, hw)),
               2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("B,H,W", [(2, 8, 8), (3, 14, 14), (1, 64, 64), (2, 5, 13)],
                         ids=["grid8", "window14", "global", "rect"])
def test_vit_attention_relpos_bwd_kernel_matches_plain_fp32(fp32_device, B, H, W, d):
    """K6b in fp32 (3xTF32) against its plain fp32 backward with TF32 off, at
    the bf16 test's shapes, given the forward's out and lse as autograd
    gives them: one fp32 launch, no bf16 one; dqkv, drel_h and drel_w within
    cor_tpu's fp32 gradient tolerance for this attention
    (tests/test_kernel_vjp.py: atol 1e-5, rtol 1e-4)."""
    g = torch.Generator(device=fp32_device).manual_seed(1)
    N, heads = H * W, (12 if d == 64 else 16)
    C = heads * d
    qkv = torch.randn(B, N, 3 * C, generator=g, device=fp32_device)
    rel_h = 0.3 * torch.randn(B, heads, N, H, generator=g, device=fp32_device)
    rel_w = 0.3 * torch.randn(B, heads, N, W, generator=g, device=fp32_device)
    do = torch.randn(B, N, C, generator=g, device=fp32_device)
    out, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, (H, W))
    before = (vit_attention_relpos_bwd.launches, vit_attention_relpos_bwd.launches_fp32)
    got = vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, heads, (H, W), out=out, lse=lse)
    torch.cuda.synchronize()
    assert (vit_attention_relpos_bwd.launches, vit_attention_relpos_bwd.launches_fp32) == (
        before[0], before[1] + 1)
    want = vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, heads, (H, W))
    for name, a, b in zip(("dqkv", "drel_h", "drel_w"), got, want):
        assert a.dtype == b.dtype == torch.float32, name
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4, msg=name)


@pytest.mark.gpu
def test_vit_attention_relpos_bwd_kernel_refuses_fp16(cuda_device):
    """fp16 has no kernels: K6b raises naming its ROADMAP row before anything
    launches."""
    qkv = torch.zeros(1, 16, 3 * 128, device=cuda_device, dtype=torch.float16)
    rel = torch.zeros(1, 2, 16, 4, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bf16 or fp32 .*@fp16"):
        vit_attention_relpos_bwd(qkv, rel, rel, torch.zeros_like(qkv[..., :128]), 2, (4, 4))


@pytest.fixture(scope="module")
def sam_decoder_fp32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder

    return init_mask_decoder(CoreConfig(), 1).to("cuda").eval()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["skip_pe", "pe", "store", "int8"])
def test_two_way_layer_kernel_matches_plain_fp32(sam_decoder_fp32, fp32_device, case):
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain

    lp = sam_decoder_fp32.transformer.layers[0 if case != "pe" else 1]
    n = 8
    x = {k: v.float() for k, v in decode_inputs(
        n, S=12 if case in ("store", "int8") else None).items()}
    keys, idx, scale = x["rows"], None, None
    if case in ("store", "int8"):
        idx = torch.tensor([11, 0, 3, 3, 7, 2, 9, 5], dtype=torch.int32, device="cuda")
    if case == "int8":
        scale = (keys.abs().amax(dim=(1, 2)) / 127.0).clamp_min(1e-12)
        keys = torch.clamp(torch.round(keys / scale[:, None, None]), -127, 127).to(torch.int8)
    args = (lp, x["tokens"], x["tokens"], keys, x["kpe"], x["qpe"], case != "pe")
    with torch.no_grad():
        before = (two_way_layer.launches, two_way_layer.launches_fp32)
        got_t, got_k = two_way_layer(*args, idx=idx, scale=scale)
        torch.cuda.synchronize()
        assert (two_way_layer.launches, two_way_layer.launches_fp32) == (before[0],
                                                                         before[1] + 4)
        want_t, want_k = two_way_layer_plain(*args, idx=idx, scale=scale)
    fp32_close(got_t, want_t, 2e-4)
    fp32_close(got_k, want_k, 2e-4)


@pytest.mark.gpu
def test_t2i_flash_kv_kernel_matches_plain_fp32(sam_decoder_fp32, fp32_device):
    from cor_tpu_torch.ops.kernels.t2i_flash import FINAL_LAUNCHES, t2i_flash_kv, t2i_flash_kv_plain

    fa = sam_decoder_fp32.transformer.final_attn_t2i
    x = {k: v.float() for k, v in decode_inputs(8).items()}
    q_tok = x["tokens"][..., :128].contiguous()
    args = (x["rows"], fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, x["kpe"], q_tok, 8)
    with torch.no_grad():
        before = t2i_flash_kv.launches_fp32
        got = t2i_flash_kv(*args)
        torch.cuda.synchronize()
        assert t2i_flash_kv.launches_fp32 == before + FINAL_LAUNCHES
        fp32_close(got, t2i_flash_kv_plain(*args), 5e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3])
def test_decoder_tail_kernel_matches_plain_fp32(sam_decoder_fp32, fp32_device, m):
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail, decoder_tail_plain

    up = sam_decoder_fp32.output_upscaling
    g = torch.Generator(device="cuda").manual_seed(1)
    src = torch.randn(4, 64, 64, 256, generator=g, device="cuda")
    hyper = torch.randn(4, m, 32, generator=g, device="cuda")
    args = (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b,
            hyper)
    with torch.no_grad():
        before = decoder_tail.launches_fp32
        got = decoder_tail(*args)
        torch.cuda.synchronize()
        assert decoder_tail.launches_fp32 == before + 1 and got.shape == (4, m, 256, 256)
        fp32_close(got, decoder_tail_plain(*args), 2e-4)
