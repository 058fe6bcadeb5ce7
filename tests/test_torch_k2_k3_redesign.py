"""K2 (the SAM decoder's final token -> image attention, csrc/t2i_final.cu on
K1's t2i pass, csrc/twl_t2i.cuh) and K3 (the upscale tail,
csrc/decoder_tail.cu), redesigned for Hopper as persistent kernels on wgmma.

On the CPU: the new packs (K2's ring blocks; K3's resident W1 and W2 in the
core-matrix layout) lay the original weights out; every instantiation's
shared memory fits the 232,448 B a block may take (both dtypes, 5 to 32
tokens) and is what the sources' headers state; kernel_bits times K2 and K3
at the fused decode's shapes, and runs K2 on an older library through the
shared image pass and the combine; the fused mask decode from an int8 store
(K1's layers, K2 and K3 through their plain versions), at 5 and 8 tokens and
with multimask_output (3 maps), against cor_tpu's on the same weights. The
tests marked ``gpu`` hold the new kernels against their plain versions on
the card (TF32 off), graph replays against eager calls, and a grid whose
tiles do not divide evenly into items:

    python -m pytest tests/test_torch_k2_k3_redesign.py -m gpu --noconftest
"""

from __future__ import annotations

import copy
import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.ops.kernels import decoder_tail as pdt
from cor_tpu_torch.ops.kernels import t2i_flash as pt2i
from cor_tpu_torch.tools import kernel_bits as kb

DECODE_REL = 2e-2  # bf16 kernels against their plain versions, relative to the max
FP32_TOL = {"t2i_flash_kv": 5e-4, "decoder_tail": 2e-4}  # cor_tpu's fp32 tolerances
MASK_REL_BF16 = 0.05  # cor_tpu's own bound on its bf16 tail (test_decoder_tail_kernel.py)
CSRC = Path(pt2i.__file__).resolve().parents[2] / "csrc"


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def no_grad():
    """The kernels and their plain versions refuse autograd."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_k2_k3_redesign.py: {time.perf_counter() - t0:.1f} s")


def unblock(flat: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """A [rows][cols] matrix back out of wgmma's core-matrix layout (element
    (o, k) at ((o / 8) * cols / 8 + k / 8) * 64 + (o % 8) * 8 + k % 8)."""
    return flat.reshape(rows // 8, cols // 8, 8, 8).permute(0, 2, 1, 3).reshape(rows, cols)


def test_k2_pack_lays_k_and_v_out_as_its_ring_blocks():
    """K2's bf16 pack: [k | v] [256, 256], its fp32 bias, and the same weight
    as the ring's 8 blocks [128][64] (k's 4, then v's), each a TMA bulk copy
    (fp32 has no block layout: its producer splits the weight as it
    streams it)."""
    g = torch.Generator().manual_seed(3)
    wk, wv = torch.randn(128, 256, generator=g), torch.randn(128, 256, generator=g)
    bk, bv = torch.randn(128, generator=g), torch.randn(128, generator=g)
    w, b = pt2i._pack(wk, bk, wv, bv, torch.device("cpu"), torch.bfloat16)
    blocks = pt2i._final_blocks(wk, bk, wv, bv, w)
    assert torch.equal(w, torch.cat([wk, wv]).to(torch.bfloat16)) and b.dtype == torch.float32
    assert blocks.shape == (256 * 256,)
    for blk in range(8):
        c, kb4 = pt2i.FINAL_CHUNK_ORDER[blk // 4], blk % 4
        got = unblock(blocks[blk * 128 * 64:(blk + 1) * 128 * 64], 128, 64)
        assert torch.equal(got, w[c * 128:(c + 1) * 128, kb4 * 64:(kb4 + 1) * 64])
    assert pt2i._final_blocks(wk, bk, wv, bv, w) is blocks  # kept beside the pack


def test_k3_pack_holds_w1_and_w2_as_shared_memory_does():
    """K3's bf16 pack: w1t [(p, q, o1), 256] and w2t [(r, s, o2), 64], then
    both again in the core-matrix layout, one after the other, as the
    kernel's shared memory holds them (W1 [256][256], position pq's 64 rows
    at pq * 32 KiB; W2 [128][64])."""
    g = torch.Generator().manual_seed(4)
    w1, w2 = torch.randn(256, 2, 2, 64, generator=g), torch.randn(64, 2, 2, 32, generator=g)
    vecs = [torch.randn(s, generator=g) for s in (64, 64, 64, 32)]
    w1t, w2t, vec = pdt._pack(w1, vecs[0], vecs[1], vecs[2], w2, vecs[3], torch.device("cpu"),
                              torch.bfloat16)
    blocks = pdt._blocks(w1, *vecs[:3], w2, vecs[3], w1t, w2t)
    assert torch.equal(w1t, w1.reshape(256, 256).T.to(torch.bfloat16))
    assert torch.equal(w2t, w2.reshape(64, 128).T.to(torch.bfloat16))
    assert torch.equal(vec, torch.cat(vecs))
    assert blocks.shape == (256 * 256 + 128 * 64,)
    assert torch.equal(unblock(blocks[:256 * 256], 256, 256), w1t)
    assert torch.equal(unblock(blocks[256 * 256:], 128, 64), w2t)
    # position (p, q) = (1, 0), output channel 5: W1's row 2 * 64 + 5 at 64 KiB
    at = (2 * 64 * 256) + ((5 // 8) * 32 + 17 // 8) * 64 + (5 % 8) * 8 + 17 % 8
    assert blocks[at] == w1t[2 * 64 + 5, 17] == w1[17, 1, 0, 5].to(torch.bfloat16)
    assert pdt._blocks(w1, *vecs[:3], w2, vecs[3], w1t, w2t) is blocks  # kept beside the pack


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_shared_memory_fits_a_block(dtype):
    """K2's shared memory at every token count it takes (5 to 32: 8 held at a
    time) and K3's fit the 227 KB a block may take, and are what the sources'
    headers state."""
    for T in range(pt2i.MIN_TOKENS, pt2i.MAX_TOKENS + 1):
        assert pt2i.final_smem(dtype, T) <= pt2i.SMEM_LIMIT, T
    assert pt2i.final_smem(dtype, 32) == pt2i.final_smem(dtype, 8) > pt2i.final_smem(dtype, 5)
    col = 1 if dtype == torch.bfloat16 else 2
    doc = re.search(r"at any T: ([\d,]+) B in\n//\s+bf16, ([\d,]+) in fp32",
                    (CSRC / "t2i_final.cu").read_text())
    assert pt2i.final_smem(dtype, 32) == int(doc.group(col).replace(",", ""))
    tail = pdt.tail_smem(dtype)
    assert tail <= pdt.SMEM_LIMIT
    text = (CSRC / "decoder_tail.cu").read_text()
    stated = re.search(r"([\d,]+) B of shared memory;" if col == 1
                       else r"out from registers\. ([\d,]+) B;", text)
    assert tail == int(stated.group(1).replace(",", ""))


def test_kernel_bits_holds_the_k2_k3_cases():
    """kernel_bits times K2 at 5, 6, 8, 16 and 32 tokens and K3 with 1 and 3
    maps, both at 40 and 128 candidates in bf16 and fp32, and (``--only
    K2,K3``) the fused decode end to end; an old library without
    cor_t2i_final runs K2 through the shared image pass and the combine, and
    an old cor_decoder_tail is called without K3's block layout."""
    cpu = torch.device("cpu")
    labels = [label for label, _ in kb.k2k3_cases(cpu)]
    assert len(labels) == 2 * len(kb.K1_CANDIDATES) * (len(kb.K2_TOKENS) + len(kb.K3_MAPS)) == 28
    for sfx in ("", "@fp32"):
        for n in (40, 128):
            for T in (5, 6, 8, 16, 32):
                assert f"K2{sfx} [{n}, 4096, 256], {T} tokens" in labels
            assert f"K3{sfx} [{n}, 64, 64, 256], 1 map" in labels
            assert f"K3{sfx} [{n}, 64, 64, 256], 3 maps" in labels
    assert not any(o in label for label in labels for o in ("K1", "K4", "K5", "K6", "K7"))

    calls = []

    class Old:  # a library of the shared entries only
        def cor_t2i_image_pass(self, *a):
            calls.append(("pass", a))
            return 0

        def cor_t2i_combine(self, *a):
            calls.append(("combine", a))
            return 0

    old = kb._OldABI(Old(), {})
    # keys, n, n_tok, N, w, w_blocks, b, kpe, qt, pm, pl, pa, tickets, out, f32, stream
    args = ("keys", 3, 6, 4096, "w", "blocks", "b", "kpe", "qt", "pm", "pl", "pa", "tk", "out", 1,
            "s")
    assert old.cor_t2i_final(*args) == 0
    assert calls == [("pass", ("keys", 0, 0, 0, 3, 3, 6, 4096, "w", "b", "kpe", 0, "qt", 0, "pm",
                               "pl", "pa", 1, "s")),
                     ("combine", ("pm", "pl", "pa", 64, 3, 6, "out", 1, "s"))]
    sig = kb._build._SIGNATURES
    assert ("w_blocks", 3, None) in kb._OPTIONAL["cor_decoder_tail"]
    assert len(sig["cor_decoder_tail"]) == 13 and len(sig["cor_t2i_final"]) == 16


@pytest.fixture(scope="module")
def sam_decoder():
    """A full-width SAM mask decoder in both packages, and cor_tpu's fused
    store-indexed decode as jitted graphs, one per (multimask_output,
    dtype) (shared by this module's tests)."""
    import jax

    import cor_tpu.models.sam_decoder as jsd
    from cor_tpu_torch.utils.weights import load_cor_tpu_params

    cfg = jsd.MaskDecoderConfig()
    p = jax.tree.map(np.asarray, jsd.init_mask_decoder(jax.random.PRNGKey(2), cfg))
    port = load_cor_tpu_params(psd.MaskDecoder(psd.MaskDecoderConfig()), p)
    graphs = {mm: jax.jit(lambda p, q, pe, sparse, idx, scale, mm=mm: jsd.mask_decoder(
        p, q, pe, sparse, None, cfg, mm, fused=True, store_idx=idx, store_scale=scale))
        for mm in (False, True)}
    return p, port, graphs


@pytest.mark.parametrize("T,multimask,dtype", [(5, False, "fp32"), (8, True, "fp32"),
                                                (8, True, "bf16")])
def test_fused_decode_from_an_int8_store_matches_cor_tpu(sam_decoder, rng, T, multimask, dtype):
    """The port's fused mask decode out of an int8 store through idx (K1's two
    layers, K2 and K3, on the CPU through their plain versions) against
    cor_tpu's on the same weights, B = 2 on a 32 x 32 grid, T - 5 sparse
    prompt tokens, 1 map or 3 (multimask_output): fp32 masks and IoU within
    cor_tpu's transformer tolerance (5e-4, the decode's largest); bf16 (weights,
    PE and prompts rounded in both) IoU within DECODE_REL and masks within
    MASK_REL_BF16 of the largest |mask| (the tails' LayerNorm statistics
    differ: cor_tpu's bound on its own bf16 tail); no kernel launch counted."""
    import jax
    import jax.numpy as jnp

    from cor_tpu.retrieval import engine as jengine

    p, port, graphs = sam_decoder
    C, G = 256, 32
    sparse = rng.standard_normal((2, T - 5, C)).astype(np.float32) * 0.5
    pe = rng.standard_normal((1, G, G, C)).astype(np.float32) * 0.3
    q, scale = jengine.quantize_candidate_store(
        rng.standard_normal((3, G, G, C)).astype(np.float32) * 0.3)
    q, scale = np.asarray(q), np.asarray(scale)
    idx = np.array([2, 0], np.int32)
    if dtype == "bf16":
        bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        want = graphs[multimask](jax.tree.map(bf, p), q, bf(pe), bf(sparse), idx, scale)
        model = copy.deepcopy(port).to(torch.bfloat16)
        tb = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    else:
        want = graphs[multimask](p, q, pe, sparse, idx, scale)
        model, tb = port, t
    wrappers = (pt2i.t2i_flash_kv, pdt.decoder_tail)
    before = [w.launches + w.launches_fp32 for w in wrappers]
    masks, iou, _ = psd.mask_decoder(model, t(q), tb(pe), tb(sparse), None, multimask,
                                     store_idx=t(idx), store_scale=t(scale))
    assert [w.launches + w.launches_fp32 for w in wrappers] == before
    m = 3 if multimask else 1
    assert masks.shape == (2, m, 4 * G, 4 * G) and iou.shape == (2, m)
    want_masks, want_iou = (np.asarray(w.astype(jnp.float32)) for w in want[:2])
    if dtype == "bf16":
        assert masks.dtype == torch.bfloat16
        got_m, got_i = masks.float().numpy(), iou.float().numpy()
        assert np.abs(got_m - want_masks).max() / np.abs(want_masks).max() <= MASK_REL_BF16
        assert np.abs(got_i - want_iou).max() / np.abs(want_iou).max() <= DECODE_REL
    else:
        np.testing.assert_allclose(masks.numpy(), want_masks, atol=5e-4, rtol=5e-4)
        np.testing.assert_allclose(iou.numpy(), want_iou, atol=5e-4, rtol=5e-4)


# ---------------------------------------------------------------------------
# on the card: the new K2 and K3 against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.fixture(scope="module")
def decoders():
    """The SAM-base decoder in bf16 and fp32 on the card."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dec = init_mask_decoder(CoreConfig(), 1).eval()
    return {dt: copy.deepcopy(dec).to("cuda", dt) for dt in (torch.bfloat16, torch.float32)}


def close(got, want, dtype, tol):
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:
        assert rel_err(got, want) <= DECODE_REL, rel_err(got, want)
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def k2_args(dec, device, n, T, N=4096, seed=0):
    dt = next(dec.parameters()).dtype
    g = torch.Generator(device=device).manual_seed(seed + 100 * n + T)
    keys = (0.5 * torch.randn(n, N, 256, generator=g, device=device)).to(dt)
    kpe = (0.5 * torch.randn(N, 128, generator=g, device=device)).to(dt)
    q_tok = torch.randn(n, T, 128, generator=g, device=device).to(dt)
    fa = dec.transformer.final_attn_t2i
    return (keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe, q_tok, 8)


def k3_args(dec, device, n, m, H=64, seed=0):
    dt = next(dec.parameters()).dtype
    g = torch.Generator(device=device).manual_seed(seed + 100 * n + m)
    src = (0.5 * torch.randn(n, H, 64, 256, generator=g, device=device)).to(dt)
    hyper = torch.randn(n, m, 32, generator=g, device=device).to(dt)
    up = dec.output_upscaling
    return (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b,
            hyper)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [5, 6, 8, 9, 16, 32])
@pytest.mark.parametrize("n", [1, 3, 40, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k2_matches_plain(cuda_device, decoders, dtype, n, T):
    """K2 (one launch with the combine folded in) against t2i_flash_kv_plain
    at [n, 4096, 256]: bf16 within DECODE_REL of max |plain|, fp32 within
    cor_tpu's 5e-4 (TF32 off); finite; the same bits from call to call."""
    args = k2_args(decoders[dtype], cuda_device, n, T)
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    before = getattr(pt2i.t2i_flash_kv, counted)
    got, again = pt2i.t2i_flash_kv(*args), pt2i.t2i_flash_kv(*args)
    torch.cuda.synchronize()
    assert getattr(pt2i.t2i_flash_kv, counted) == before + 2 * pt2i.FINAL_LAUNCHES
    assert torch.equal(got, again)
    close(got, pt2i.t2i_flash_kv_plain(*args), dtype, FP32_TOL["t2i_flash_kv"])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 3, 40, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k3_matches_plain(cuda_device, decoders, dtype, n, m):
    """K3 (one launch, every map from one pass) against decoder_tail_plain at
    [n, 64, 64, 256] with m maps: bf16 within DECODE_REL of max |plain|, fp32
    within cor_tpu's 2e-4 (TF32 off); the same bits from call to call."""
    args = k3_args(decoders[dtype], cuda_device, n, m)
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    before = getattr(pdt.decoder_tail, counted)
    got, again = pdt.decoder_tail(*args), pdt.decoder_tail(*args)
    torch.cuda.synchronize()
    assert getattr(pdt.decoder_tail, counted) == before + 2
    assert got.shape == (n, m, 256, 256) and torch.equal(got, again)
    close(got, pdt.decoder_tail_plain(*args), dtype, FP32_TOL["decoder_tail"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_graph_replays_give_eager_bits(cuda_device, decoders, dtype):
    """Three CUDA-graph replays of K2 and K3 give the eager calls' bits: K2's
    per-candidate tickets are back at zero after every launch."""
    a2, a3 = k2_args(decoders[dtype], cuda_device, 40, 6), k3_args(decoders[dtype], cuda_device,
                                                                   40, 3)
    eager2, eager3 = pt2i.t2i_flash_kv(*a2), pdt.decoder_tail(*a3)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out2, out3 = pt2i.t2i_flash_kv(*a2), pdt.decoder_tail(*a3)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out2, eager2) and torch.equal(out3, eager3)
    assert not pt2i._TICKETS[cuda_device.index if cuda_device.index is not None else 0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ragged_items(cuda_device, decoders, dtype):
    """N = 64 * 65 rows (65 tiles: an odd count, which bf16's two-tile items
    do not divide) through K2 at 6 and 16 tokens, and 65 grid rows through K3
    (fp32's two-row items), against the plain versions; K2 gives the same
    bits twice (its tickets back at zero after each launch)."""
    for T in (6, 16):
        args = k2_args(decoders[dtype], cuda_device, 3, T, N=64 * 65, seed=7)
        got, again = pt2i.t2i_flash_kv(*args), pt2i.t2i_flash_kv(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        close(got, pt2i.t2i_flash_kv_plain(*args), dtype, FP32_TOL["t2i_flash_kv"])
    args = k3_args(decoders[dtype], cuda_device, 3, 3, H=65, seed=7)
    got = pdt.decoder_tail(*args)
    assert got.shape == (3, 3, 260, 256)
    close(got, pdt.decoder_tail_plain(*args), dtype, FP32_TOL["decoder_tail"])
