"""K1, the SAM decoder's two-way layer, with its image passes redesigned for
Hopper (csrc/twl_t2i.cu, twl_i2t.cu), and the pack cache that feeds it.

On the CPU: the fused decoder's two-way transformer (layer 0 out of an int8
store through idx, layer 1 on its rows, the final attention) against
cor_tpu's, at 5 and 8 tokens, in fp32 (cor_tpu's transformer tolerance,
atol = rtol = 5e-4) and bf16 (max |port - cor_tpu| / max |cor_tpu| at most
BF16_REL, about two bf16 ulps at the outputs' largest value); the shared
memory and launch geometry of the new image passes; kernel_bits' K1 cases
and its old-library aliases; ``cached_pack`` repacking after an in-place
write (P7). The tests marked ``gpu`` hold the new K1 against its plain
version on the card (TF32 off) and show a second fp32 epoch's validation
running that epoch's weights:

    python -m pytest tests/test_torch_k1_redesign.py -m gpu --noconftest
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
from cor_tpu_torch.ops.kernels import t2i_flash
from cor_tpu_torch.ops.kernels import two_way_layer as ptwl
from cor_tpu_torch.tools import kernel_bits as kb

TTOL = dict(atol=5e-4, rtol=5e-4)  # cor_tpu's, K1 + K2 through the transformer
LTOL = dict(atol=2e-4, rtol=2e-4)  # cor_tpu's, a layer
BF16_REL = 2e-2
DECODE_REL = 2e-2
N, C = 1024, 256
CSRC = Path(ptwl.__file__).resolve().parents[2] / "csrc"


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def no_grad():
    """The kernels and their plain versions refuse autograd: the tests run
    without it (the training test records its own steps)."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_k1_redesign.py: {time.perf_counter() - t0:.1f} s")


@pytest.fixture(scope="module")
def sam():
    """A full-width SAM two-way transformer in both packages, and cor_tpu's
    fused transformer as a jitted graph (shared by this module's tests)."""
    import jax

    import cor_tpu.models.sam_decoder as jsd
    from cor_tpu_torch.utils.weights import load_cor_tpu_params

    cfg = jsd.TwoWayTransformerConfig()
    p = jax.tree.map(np.asarray, jsd.init_two_way_transformer(jax.random.PRNGKey(1), cfg))
    port = load_cor_tpu_params(psd.TwoWayTransformer(psd.TwoWayTransformerConfig()), p)
    graph = jax.jit(lambda p, q, pe, tok, idx, scale: jsd.two_way_transformer(
        p, q, pe, tok, cfg, fused=True, store_idx=idx, store_scale=scale))
    return p, port, graph


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("T", [5, 8])
def test_fused_transformer_from_an_int8_store_matches_cor_tpu(sam, rng, T, dtype):
    """The port's fused two-way transformer (K1's route: layer 0 out of an
    int8 store through a permuted idx, layer 1 on its rows, then K2) against
    cor_tpu's at B = 2 on a 32 x 32 grid: queries and keys within cor_tpu's
    fp32 tolerance, or BF16_REL in bf16 (weights, PE and tokens rounded to
    bf16 in both); no kernel launch counted on the CPU."""
    import jax
    import jax.numpy as jnp

    from cor_tpu.retrieval import engine as jengine

    p, port, graph = sam
    tok = rng.standard_normal((2, T, C)).astype(np.float32) * 0.5
    pe = rng.standard_normal((1, 32, 32, C)).astype(np.float32) * 0.3
    q, scale = jengine.quantize_candidate_store(
        rng.standard_normal((3, 32, 32, C)).astype(np.float32) * 0.3)
    q, scale = np.asarray(q), np.asarray(scale)
    idx = np.array([2, 0], np.int32)
    if dtype == "bf16":
        bf = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
        want = graph(jax.tree.map(bf, p), q, bf(pe), bf(tok), idx, scale)
        model = copy.deepcopy(port).to(torch.bfloat16)
        tb = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    else:
        want = graph(p, q, pe, tok, idx, scale)
        model, tb = port, t
    before = ptwl.two_way_layer.launches + ptwl.two_way_layer.launches_fp32
    got = psd.two_way_transformer(model, t(q), tb(pe), tb(tok), store_idx=t(idx),
                                  store_scale=t(scale))
    assert ptwl.two_way_layer.launches + ptwl.two_way_layer.launches_fp32 == before
    assert got[0].shape == (2, T, C) and got[1].shape == (2, N, C)
    for g, w in zip(got, want):
        w = np.asarray(w.astype(jnp.float32))
        if dtype == "bf16":
            assert g.dtype == torch.bfloat16
            assert np.abs(g.float().numpy() - w).max() / np.abs(w).max() <= BF16_REL
        else:
            np.testing.assert_allclose(g.numpy(), w, **TTOL)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_image_passes_fit_a_block(dtype):
    """The new image passes' shared memory fits the 227 KB a block may take
    at every token count K1 takes, and is what the sources' headers state at
    8 tokens; their persistent grids cover every tile with at most one CTA
    an SM."""
    for T in ptwl.LAYER_TOKENS:
        smem = ptwl.image_pass_smem(dtype, T)
        assert max(smem.values()) <= ptwl.SMEM_LIMIT, (T, smem)
    at8 = ptwl.image_pass_smem(dtype, 8)
    t2i_doc = re.search(r"([\d,]+) B in bf16 and ([\d,]+) in fp32 at T = 8",
                        (CSRC / "twl_t2i.cu").read_text())
    i2t_doc = re.search(r"([\d,]+) B in bf16,\n// ([\d,]+) in fp32",
                        (CSRC / "twl_i2t.cu").read_text())
    col = 1 if dtype == torch.bfloat16 else 2
    assert at8["t2i"] == int(t2i_doc.group(col).replace(",", ""))
    assert at8["i2t"] == int(i2t_doc.group(col).replace(",", ""))
    for n, rows in ((1, 4096), (3, 192), (40, 4096), (128, 4096)):
        tiles = rows // ptwl.ROW_TILE
        for name, (items, ctas, threads) in ptwl.image_pass_grid(dtype, n, rows, 132).items():
            per = -(-n * tiles // items)
            assert items * per >= n * tiles and items <= n * tiles, (name, n, rows)
            assert ctas == min(items, 132) and threads <= 1024


def test_ring_blocks_lay_the_weights_out_as_the_rings_hold_them():
    """The bf16 weights' second layout in K1's pack, each block one TMA bulk
    copy: the t2i weight [k | v | q] as 12 blocks [128][64] in the order q,
    k, v, the i2t out-projection as 4 blocks [256][32], element (o, k) of a
    block at ((o / 8) * kb / 8 + k / 8) * 64 + (o % 8) * 8 + k % 8."""
    g = torch.Generator().manual_seed(5)
    w = torch.randn(384, 256, generator=g)
    got = ptwl.ring_blocks(w, 64, ptwl.T2I_CHUNK_ORDER)
    assert got.shape == (384 * 256,)
    for blk in (0, 5, 11):
        c, kb = ptwl.T2I_CHUNK_ORDER[blk // 4], blk % 4
        for o, k in ((0, 0), (9, 17), (127, 63), (64, 8)):
            at = blk * 128 * 64 + ((o // 8) * 8 + k // 8) * 64 + (o % 8) * 8 + k % 8
            assert got[at] == w[c * 128 + o, kb * 64 + k]
    wo = torch.randn(256, 128, generator=g)
    got = ptwl.ring_blocks(wo, 32)
    for kb, o, k in ((0, 0, 0), (3, 255, 31), (2, 17, 9)):
        assert got[kb * 256 * 32 + ((o // 8) * 4 + k // 8) * 64 + (o % 8) * 8 + k % 8] == \
            wo[o, kb * 32 + k]


def test_kernel_bits_holds_the_k1_cases():
    """kernel_bits times K1 (bf16 and fp32, layer 0 from an int8 store and
    layer 1 on rows, at 5, 6 and 8 tokens, 40 and 128 candidates) and the
    fused decode end to end; an old library without K1's own entries serves
    them by the shared ones it ran K1 through."""
    cpu = torch.device("cpu")
    labels = [label for label, _ in kb.k1_cases(cpu)]
    assert len(labels) == 2 * 2 * len(kb.K1_TOKENS) * len(kb.K1_CANDIDATES) == 24
    for sfx in ("", "@fp32"):
        for T in (5, 6, 8):
            for n in (40, 128):
                assert f"K1{sfx} layer 0 int8 store [{n}, 4096], {T} tokens" in labels
                assert f"K1{sfx} layer 1 rows [{n}, 4096], {T} tokens" in labels
    assert [label for label, _ in kb.decode_cases(cpu)] == [
        f"fused decode{sfx} [{n}, 4096], 6 tokens" for sfx in ("", " fp32") for n in (40, 128)]

    class Old:  # a library of the shared entries only
        def cor_t2i_image_pass(self, *a):
            return ("t2i", a)

        def cor_twl_image_i2t(self, *a):
            return ("i2t", a)

        def cor_twl_tokens_in(self, *a):
            return ("in", a)

        def cor_twl_tokens_mid(self, *a):
            return ("mid", a)

    old = kb._OldABI(Old(), {})
    args = tuple(range(20))
    assert old.cor_twl_t2i(*args) == ("t2i", args[:9] + args[10:])
    assert old.cor_twl_i2t(*args[:19]) == ("i2t", args[:12] + args[13:19])
    assert old.cor_twl_tokens_in_cluster(*args[:14]) == ("in", args[:14])
    assert old.cor_twl_tokens_mid_cluster(*args[:16]) == ("mid", args[:16])


def test_cached_pack_repacks_after_an_in_place_write():
    """P7: a pack is kept while its tensors are the same and unwritten, and
    made again once one of them is written in place (an optimizer's step, a
    checkpoint's ``copy_``) or replaced."""
    holder = torch.nn.Linear(4, 3)
    made = []

    def pack():
        made.append(holder.weight.detach().clone())
        return made[-1]

    ts = list(holder.parameters())
    first = t2i_flash.cached_pack(holder, "_pack", ts, "cpu", torch.float32, pack)
    assert t2i_flash.cached_pack(holder, "_pack", ts, "cpu", torch.float32, pack) is first
    with torch.no_grad():
        holder.weight.add_(1.0)
    second = t2i_flash.cached_pack(holder, "_pack", ts, "cpu", torch.float32, pack)
    assert second is not first and torch.equal(second, first + 1.0) and len(made) == 2
    with torch.no_grad():
        holder.bias.copy_(torch.zeros(3))
    third = t2i_flash.cached_pack(holder, "_pack", ts, "cpu", torch.float32, pack)
    assert third is not second and len(made) == 3
    assert t2i_flash.cached_pack(holder, "_pack", ts, "cpu", torch.float32, pack) is third
    other = [torch.nn.Parameter(p.detach().clone()) for p in ts]
    assert t2i_flash.cached_pack(holder, "_pack", other, "cpu", torch.float32, pack) is not third
    assert t2i_flash.cached_pack(holder, "_pack", other, "cpu", torch.bfloat16, pack) is made[-1]
    assert len(made) == 5
    with torch.inference_mode():  # per-call copies under inference mode keep no version
        copies = [p.detach().clone() for p in ts]
        assert t2i_flash.cached_pack(holder, "_pack", copies, "cpu", torch.float32, pack) \
            is made[-1]
        assert t2i_flash.cached_pack(holder, "_pack", copies, "cpu", torch.float32, pack) \
            is made[-1] and len(made) == 6


# ---------------------------------------------------------------------------
# on the card: the new K1 against its plain version
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
def decoder_layers():
    """The SAM-base decoder's two layers in bf16 and fp32 on the card."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")

    dec = init_mask_decoder(CoreConfig(), 1).eval()
    return {dt: copy.deepcopy(dec.transformer).to("cuda", dt).layers
            for dt in (torch.bfloat16, torch.float32)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["int8 store", "bf16 store", "rows"])
@pytest.mark.parametrize("T", [5, 6, 7, 8])
@pytest.mark.parametrize("n", [1, 3, 40, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k1_matches_plain(cuda_device, decoder_layers, dtype, n, T, case):
    """K1 (four launches: the token kernels and the new image passes) against
    two_way_layer_plain at [n, 4096, 256]: layer 0 out of an int8 store or a
    store of the compute dtype through idx, layer 1 on rows; bf16 within
    DECODE_REL of max |plain|, fp32 within cor_tpu's layer tolerance (2e-4)
    with TF32 off; finite; the same bits from run to run."""
    g = torch.Generator(device=cuda_device).manual_seed(100 * n + T)
    rnd = lambda *s: torch.randn(*s, generator=g, device=cuda_device)  # noqa: E731
    layer = 1 if case == "rows" else 0
    lp = decoder_layers[dtype][layer]
    tokens = rnd(n, T, C).to(dtype)
    kpe, qpe = (0.5 * rnd(4096, 128)).to(dtype), (0.5 * rnd(4096, 128)).to(dtype)
    kw = {}
    if case == "rows":
        rows = (0.5 * rnd(n, 4096, C)).to(dtype)
    else:
        S = 7
        kw["idx"] = torch.randint(0, S, (n,), generator=g, device=cuda_device,
                                  dtype=torch.int32)
        if case == "int8 store":
            rows = torch.randint(-127, 128, (S, 4096, C), generator=g, device=cuda_device,
                                 dtype=torch.int8)
            kw["scale"] = (2 / 127) * (1 + 0.1 * torch.rand(S, generator=g, device=cuda_device))
        else:
            rows = (0.5 * rnd(S, 4096, C)).to(dtype)
    args = (lp, tokens, tokens, rows, kpe, qpe, layer == 0)
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    before = getattr(ptwl.two_way_layer, counted)
    got = ptwl.two_way_layer(*args, **kw)
    again = ptwl.two_way_layer(*args, **kw)
    torch.cuda.synchronize()
    assert getattr(ptwl.two_way_layer, counted) == before + 2 * ptwl.LAUNCHES
    want = ptwl.two_way_layer_plain(*args, **kw)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all() and torch.equal(a, a2)
        if dtype == torch.bfloat16:
            assert rel_err(a, w) <= DECODE_REL, rel_err(a, w)
        else:
            torch.testing.assert_close(a, w, **LTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_fused_decode_matches_the_cpu(cuda_device, dtype):
    """The whole fused mask decode out of an int8 store through idx (K1's two
    layers, K2, K3) on the card against the same decode on the CPU (the
    plain versions, fp32): masks and IoU within DECODE_REL of the CPU's max
    in bf16 and 5e-4 in fp32 (K1 + K2's tolerance, TF32 off); 8 K1 launches."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_decode_model
    from cor_tpu_torch.models.prompt_encoder import get_dense_pe
    from cor_tpu_torch.tools.decode_bench import quantize_rows

    model = init_decode_model(CoreConfig(), 0).eval()
    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.standard_normal((6, 64, 64, 256), dtype=np.float32))
    store, scales = quantize_rows(raw + model.prompt_encoder.no_mask_embed[0].detach())
    idx = torch.from_numpy(rng.integers(0, 6, 40).astype(np.int32))
    prompts = torch.from_numpy(rng.standard_normal((40, 1, 256), dtype=np.float32))
    with torch.no_grad():
        pe = get_dense_pe(model.prompt_encoder)
        want = psd.mask_decoder(model.mask_decoder, store, pe, prompts, None, False,
                                store_idx=idx, store_scale=scales)
        dec = copy.deepcopy(model.mask_decoder).to(cuda_device, dtype)
        counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
        before = getattr(ptwl.two_way_layer, counted)
        got = psd.mask_decoder(dec, store.to(cuda_device), pe.to(cuda_device, dtype),
                               prompts.to(cuda_device, dtype), None, False,
                               store_idx=idx.to(cuda_device), store_scale=scales.to(cuda_device))
        torch.cuda.synchronize()
    assert getattr(ptwl.two_way_layer, counted) == before + 2 * ptwl.LAUNCHES
    tol = DECODE_REL if dtype == torch.bfloat16 else 5e-4
    for a, w in zip(got[:2], want[:2]):
        assert torch.isfinite(a.float()).all()
        assert rel_err(a.cpu(), w) <= tol, rel_err(a.cpu(), w)


@pytest.mark.gpu
def test_second_epoch_validation_runs_that_epochs_weights(cuda_device):
    """P7 on the card: the SAM-base decoder trained in fp32 for two epochs of
    AdamW steps (the differentiable ``fused=False`` path), validated after
    each through the kernels (``fused=True``, whose packs are cached on the
    layers): the second epoch's validation equals that of a copy of the
    model, whose packs are made afresh, bit for bit, and differs from the
    first epoch's."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_decode_model
    from cor_tpu_torch.models.prompt_encoder import get_dense_pe

    model = init_decode_model(CoreConfig(), 0).to(cuda_device)
    dec = model.mask_decoder
    g = torch.Generator(device=cuda_device).manual_seed(4)
    emb = torch.randn(4, 64, 64, 256, generator=g, device=cuda_device)
    prompts = torch.randn(4, 1, 256, generator=g, device=cuda_device)
    with torch.no_grad():
        pe = get_dense_pe(model.prompt_encoder)
    opt = torch.optim.AdamW(dec.parameters(), lr=1e-3)

    def validate(d):
        with torch.no_grad():
            return psd.mask_decoder(d, emb, pe, prompts, None, False)[0]

    seen = []
    for _ in range(2):
        for _ in range(2):
            with torch.enable_grad():
                masks = psd.mask_decoder(dec, emb, pe, prompts, None, False, fused=False)[0]
                opt.zero_grad()
                masks.float().square().mean().backward()
            opt.step()
        seen.append(validate(dec))
    fresh = validate(copy.deepcopy(dec))
    torch.cuda.synchronize()
    assert torch.equal(seen[1], fresh)
    assert not torch.equal(seen[0], seen[1])
