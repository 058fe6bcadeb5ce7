"""K1-dma (the two-way layer with the rows moved by the kernels' own
asynchronous copies) and K9 (fused_upscale2_hyper), redesigned for Hopper.

K1-dma runs K1's token stages and K1's Hopper image passes with their kDma
switch (csrc/two_way_layer_dma.cu): the t2i pass's row tiles come in by the
TMA, the i2t pass's tiles by bulk copies and its new rows go out by bulk
stores. K9 (csrc/upscale.cu) is persistent with w resident in shared
memory, its x tiles streamed by the TMA and one wgmma product a tile.

On the CPU: a K1-dma layer's four launches are K1's cluster token entries
and K1-dma's image passes, handed K1's packed ring blocks; K1-dma's shared
memory (a Python mirror of the source's layout) fits the 232,448 B a block
may take at 5 to 8 tokens in both dtypes and is what the source's header
states; K9's pack and its shared-memory copy of w are a numpy re-layout of
w; K9's persistent walk covers every pixel exactly once, ragged tiles too;
its launch plan fits every shape the wrapper takes; kernel_bits times both
kernels and serves an older library's K1-dma entries without the ring
blocks. The tests marked ``gpu`` hold K1-dma to K1 bit for bit and K9 to its
plain version within 1e-4 on the card (TF32 off):

    python -m pytest tests/test_torch_dma_k9_redesign.py -m gpu --noconftest
"""

from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
from cor_tpu_torch.ops.kernels import t2i_flash as pt2i
from cor_tpu_torch.ops.kernels import two_way_layer as ptwl
from cor_tpu_torch.ops.kernels import upscale as pup
from cor_tpu_torch.tools import kernel_bits as kb

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "cor_tpu_torch" / "csrc"
K9_TOL = 1e-4  # cor_tpu's fp32 tolerance for K9 (tests/test_pallas_kernels.py:58), bf16 too


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
    print(f"\n{Path(__file__).name}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# on the CPU: K1-dma's launches and shared memory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dma_layer_runs_k1s_token_stages_and_ring_blocks(monkeypatch, dtype):
    """A K1-dma layer is K1's four launches with K1-dma's image passes: the
    token stages are K1's cluster entries with K1's arguments, and the image
    passes take K1's packed ring blocks (bf16; none in fp32) at K1's
    positions, the same pack K1's entries take."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: calls.append((name, args)) or 0

    class Stream:
        cuda_stream = 0

    monkeypatch.setattr(ptwl, "library", Lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    lp = init_mask_decoder(CoreConfig(), 1).to(dtype).eval().transformer.layers[1]
    g = torch.Generator().manual_seed(3)
    n, T, N = 2, 6, 128
    tokens = torch.randn(n, T, 256, generator=g).to(dtype)
    keys = torch.randn(n, N, 256, generator=g).to(dtype)
    pe = torch.randn(N, 128, generator=g).to(dtype)
    runs = {}
    for fn in (ptwl.two_way_layer, ptwl.two_way_layer_dma):
        calls.clear()
        launches, _, _ = ptwl.layer_launches(fn, lp, tokens, tokens, keys, pe, pe, False)
        assert [name for name, _ in launches] == ["tokens_in", "image_t2i", "tokens_mid",
                                                  "image_i2t"]
        for _, go in launches:
            go()
        runs[fn.__name__] = list(calls)
    k1, dma = runs["two_way_layer"], runs["two_way_layer_dma"]
    assert [c[0] for c in dma] == ["cor_twl_tokens_in_cluster", "cor_twl_dma_image_t2i",
                                   "cor_twl_tokens_mid_cluster", "cor_twl_dma_image_i2t"]
    assert [c[0] for c in k1] == ["cor_twl_tokens_in_cluster", "cor_twl_t2i",
                                  "cor_twl_tokens_mid_cluster", "cor_twl_i2t"]
    pk = ptwl._pack(lp, torch.device("cpu"), dtype)
    bf16 = dtype == torch.bfloat16
    w_blocks = pk["w_img_blocks"].data_ptr() if bf16 else 0
    wo_blocks = pk["wo_i_blocks"].data_ptr() if bf16 else 0
    assert dma[1][1][9] == k1[1][1][9] == w_blocks
    assert dma[3][1][12] == k1[3][1][12] == wo_blocks
    # the ring blocks are K1's layout of the packed weights
    if bf16:
        assert torch.equal(pk["w_img_blocks"],
                           pt2i.ring_blocks(pk["w_img"], 64, ptwl.T2I_CHUNK_ORDER))
        assert torch.equal(pk["wo_i_blocks"], pt2i.ring_blocks(pk["wo_i"], 32))
    # every argument but the intermediate buffers (fresh each call) is K1's:
    # the inputs, the packed weights, the geometry, the flags
    kept = {t.data_ptr() for t in (tokens, keys, pe, *(v for v in pk.values() if v is not None))}
    for (_, a), (_, b) in zip(dma, k1):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(y, float) or y in kept or abs(y) < 1 << 20:
                assert x == y


def header_bytes(pattern: str) -> int:
    text = re.sub(r"\s+", " ", (CSRC / "two_way_layer_dma.cu").read_text().replace("//", ""))
    m = re.search(pattern, text)
    assert m, pattern
    return int(m.group(1).replace(",", ""))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("source", ["rows", "store", "int8 store"])
def test_dma_shared_memory_fits_at_every_token_count(dtype, source):
    """K1-dma's two image passes fit a block's 232,448 B at 5 to 8 tokens,
    in bf16 and fp32, from rows, a store through idx and an int8 store (whose
    raw tiles lie inside the row tiles: the same bytes); the t2i pass is K1's
    with an mbarrier a consumer warpgroup; the numbers are the header's."""
    for T in (5, 6, 7, 8):
        got = ptwl.dma_pass_smem(dtype, T)
        k1 = ptwl.image_pass_smem(dtype, T)
        assert max(got.values()) <= pt2i.SMEM_LIMIT == 232_448
        groups = 2 if dtype == torch.bfloat16 else 1
        assert got["t2i"] == k1["t2i"] + 8 * groups
    at8 = ptwl.dma_pass_smem(dtype, 8)
    if dtype == torch.bfloat16:
        assert header_bytes(r"bf16 t2i takes K1's ([\d,]+) B at 8 tokens \+ 16 B") == \
            at8["t2i"] - 16
        assert header_bytes(r"bf16 i2t K1's ([\d,]+) B") == at8["i2t"]
    else:
        assert header_bytes(r"fp32 t2i takes K1's ([\d,]+) B \+") == at8["t2i"] - 8
        assert header_bytes(r"once the other's stores have read it: ([\d,]+) B") == at8["i2t"]


# ---------------------------------------------------------------------------
# on the CPU: K9's pack, its copy of w, its walk and its plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,O", [(64, 32), (32, 16), (48, 40)])
def test_k9_pack_and_resident_w_are_a_numpy_relayout(C, O):
    """The wrapper's pack is w [C, 2, 2, O] as [(p, q, o), C]; the kernel's
    shared-memory copy of a pass's slice (bf16) is that pack with o padded
    to 32 or 64 by zeros, laid out as wgmma's K-major core matrices of 8 x 8:
    a numpy reshape of the padded slice."""
    g = torch.Generator().manual_seed(C + O)
    w = torch.randn(C, 2, 2, O, generator=g)
    b = torch.randn(O, generator=g)
    wt, bf = pup._pack(w, b, torch.device("cpu"), torch.bfloat16)
    assert torch.equal(wt, torch.from_numpy(w.numpy().reshape(C, 4 * O).T.copy()).bfloat16())
    assert torch.equal(bf, b)
    kop = 32 if O <= 32 else 64
    for npos, pass_ in ((4, 0), (2, 1), (1, 3)):
        if npos * kop < 64:
            continue
        got = pup.resident_w(wt, O, npos, pass_)
        sl = np.zeros((npos, kop, C), dtype=np.float32)
        sl[:, :O] = wt.float().numpy().reshape(4, O, C)[pass_ * npos:(pass_ + 1) * npos]
        n = npos * kop
        cm = sl.reshape(n // 8, 8, C // 8, 8).transpose(0, 2, 1, 3).reshape(-1)
        assert np.array_equal(got.float().numpy(), cm)


@pytest.mark.parametrize("B,H,W,ctas", [(2, 8, 8, 3), (3, 5, 40, 4), (2, 9, 130, 7),
                                         (3, 128, 128, 132), (1, 7, 7, 5), (2, 3, 200, 132)])
def test_k9_walk_covers_every_pixel_once(B, H, W, ctas):
    """The persistent walk (contiguous ranges by CTA, every other tile by
    consumer warpgroup) covers every input pixel exactly once, the ragged
    last tiles of a row and of the image too."""
    _, _, _, per_b = pup.tile_geometry(H, W)
    seen = np.zeros((B, H, W), dtype=np.int64)
    for groups in pup.cta_tiles(B * per_b, min(ctas, B * per_b)):
        for tiles in groups:
            for tile in tiles:
                for b, i, j in pup.tile_pixels(B, H, W, tile):
                    seen[b, i, j] += 1
    assert (seen == 1).all()
    # a tile holds at most 64 pixels, and the tiles of a CTA are contiguous
    assert max(len(pup.tile_pixels(B, H, W, t)) for t in range(B * per_b)) <= 64
    walk = pup.cta_tiles(B * per_b, ctas)
    flat = [t for cta in walk for t in sorted(sum(cta, []))]
    assert flat == list(range(B * per_b))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k9_plan_fits_every_shape_the_wrapper_takes(dtype):
    """The launch plan finds shared memory for every C (16 to 256), O (8 to
    64) and N (1 to 16) the wrapper takes; at the decoder's shape w stays
    whole (4 positions) with three consumer warpgroups."""
    for C in range(16, 257, 16):
        for O in range(8, 65, 8):
            for N in (1, 4, 16):
                plan = pup.upscale_plan(C, O, N, dtype)
                assert plan is not None, (C, O, N)
                assert plan["smem"] <= pup.SMEM_LIMIT and plan["stages"] >= 1
                assert plan["npos"] * plan["kop"] in (64, 128, 256)
    main = pup.upscale_plan(64, 32, 4, dtype)
    assert (main["npos"], main["groups"], main["stages"]) == (4, 3, pup.MAX_STAGES)


def test_kernel_bits_times_dma_and_k9():
    """kernel_bits times K1-dma (layer 0 from an int8 store, layer 1 on rows
    and on a store, 5, 6 and 8 tokens, 40 and 128 candidates, bf16 and fp32)
    against the old library and K1, and K9 at chip_smoke.py's shapes; an old
    library's K1-dma entries, without the ring blocks, are called without
    them."""
    cpu = torch.device("cpu")
    labels = [label for label, _ in kb.dma_cases(cpu)]
    assert len(labels) == 2 * 3 * len(kb.K1_TOKENS) * len(kb.K1_CANDIDATES) == 36
    assert "K1-dma layer 0 int8 store [40, 4096], 6 tokens" in labels
    assert "K1-dma@fp32 layer 1 store-indexed [128, 4096], 8 tokens" in labels
    k9 = [label for label, _ in kb.k9_cases(cpu)]
    assert k9[2] == "K9 x [40, 128, 128, 64], O 32, N 4" and len(k9) == 6
    assert kb.K9_SHAPES == ((2, 8, 8, 64, 32, 3), (40, 128, 128, 64, 32, 1),
                            (40, 128, 128, 64, 32, 4))
    smoke = (ROOT / "chip_smoke.py").read_text()
    assert f"K9_SHAPES = {kb.K9_SHAPES}" in smoke
    # the old library's K9 is what the wrapper runs while it is in use
    assert "upscale" in kb._WRAPPER_MODULES
    got = []

    class Lib:
        def __getattr__(self, name):
            return lambda *args: got.append((name, args)) or 0

    missing = {"cor_twl_dma_image_t2i": kb._OPTIONAL["cor_twl_dma_image_t2i"],
               "cor_twl_dma_image_i2t": kb._OPTIONAL["cor_twl_dma_image_i2t"]}
    old = kb._OldABI(Lib(), missing)
    args = tuple(range(20))
    old.cor_twl_dma_image_t2i(*args)
    old.cor_twl_dma_image_i2t(*args[:19])
    assert got == [("cor_twl_dma_image_t2i", args[:9] + args[10:]),
                   ("cor_twl_dma_image_i2t", args[:12] + args[13:19])]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [40, 128])
def test_dma_equals_k1_bit_for_bit(cuda_device, dtype, n):
    """K1-dma's outputs are K1's bit for bit at 5 to 8 tokens, from rows, a
    store through idx and an int8 store."""
    dev, N, S = cuda_device, 4096, 64
    gen = torch.Generator(device=dev).manual_seed(n)
    dec = init_mask_decoder(CoreConfig(), 1).to(dev, dtype).eval()
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    kpe, qpe = (0.5 * rnd(N, 128)).to(dtype), (0.5 * rnd(N, 128)).to(dtype)
    store8 = torch.randint(-127, 128, (S, N, 256), generator=gen, device=dev, dtype=torch.int8)
    scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(S, generator=gen, device=dev))
    store = (0.5 * rnd(S, N, 256)).to(dtype)
    keys = (0.5 * rnd(n, N, 256)).to(dtype)
    idx = torch.randint(0, S, (n,), generator=gen, device=dev, dtype=torch.int32)
    for T in (5, 6, 7, 8):
        tokens = rnd(n, T, 256).to(dtype)
        for label, rows, kw, layer in (("int8 store", store8, dict(idx=idx, scale=scales), 0),
                                       ("store", store, dict(idx=idx), 1),
                                       ("rows", keys, {}, 1)):
            args = (dec.transformer.layers[layer], tokens, tokens, rows, kpe, qpe, layer == 0)
            got = ptwl.two_way_layer_dma(*args, **kw)
            want = ptwl.two_way_layer(*args, **kw)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), (label, T)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [*kb.K9_SHAPES, (3, 5, 40, 32, 16, 2)])
def test_k9_matches_plain(cuda_device, dtype, shape):
    """K9 within 1e-4 of its plain version at every K9_SHAPES entry and at a
    shape of W < 64 with ragged tiles and O padded (16 of 32)."""
    B, H, W, C, O, N = shape
    gen = torch.Generator(device=cuda_device).manual_seed(B + W)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)  # noqa: E731
    x, h = rnd(B, H, W, C).to(dtype), rnd(B, N, O).to(dtype)
    w, b = (rnd(C, 2, 2, O) / C ** 0.5).to(dtype), 0.1 * rnd(O)
    got = pup.fused_upscale2_hyper(x, w, b, h)
    want = pup.fused_upscale2_hyper_plain(x, w, b, h)
    torch.cuda.synchronize()
    assert got.shape == (B, N, 2 * H, 2 * W)
    assert (got - want).abs().max().item() <= K9_TOL
