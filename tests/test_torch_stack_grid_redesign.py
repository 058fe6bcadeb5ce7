"""K1-stack and K1-grid, the whole-transformer decode schedules, rebuilt on
K1's and K2's Hopper passes (csrc/two_way_stack.cuh): one persistent
384-thread CTA an SM whose image stages are the t2i pass with its q chunk
(csrc/twl_t2i.cuh), K1's i2t pass (csrc/twl_i2t.cuh) and the t2i pass
without it, and whose token stages are split over a cluster of CTAs a
candidate.

On the CPU: the kernel's shared memory (one union of its stages) fits the
232,448 B a block may take at 5 to 8 tokens in both dtypes and is what the
source's header states; the wrapper hands the kernel K1's ring blocks for
each layer and K2's for the final [k | v], made again after an in-place
write; its 55 pointers keep the first version's 50 first; a decode under
each flag runs one K1-stack or K1-grid call and one K3 call (chip_smoke.py's
counts, which phases 35-36 hold the card's launches to); kernel_bits
compares and times both schedules, and serves an older library's entry with
the same arguments. The tests marked ``gpu`` hold both schedules against
their plain versions on the card (TF32 off), K1-grid's keys against two K1
launches bit for bit, the team sizes the kernel chooses, every team size
against the kernel's choice, n beyond what is resident at once, and a
CUDA-graph replay against the eager call:

    python -m pytest tests/test_torch_stack_grid_redesign.py -m gpu --noconftest
"""

from __future__ import annotations

import importlib.util
import re
import time
from pathlib import Path

import pytest
import torch

from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
from cor_tpu_torch.ops.kernels import t2i_flash as pt2i
from cor_tpu_torch.ops.kernels import two_way_layer as ptwl
from cor_tpu_torch.ops.kernels import two_way_stack as pws
from cor_tpu_torch.tools import kernel_bits as kb

DECODE_REL = 2e-2  # bf16 kernels against their plain versions, relative to the max
FP32_TOL = 5e-4  # cor_tpu's fp32 tolerance for the transformer
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "cor_tpu_torch" / "csrc"
N = 4096


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
        rep.write_line(f"tests/test_torch_stack_grid_redesign.py: {time.perf_counter() - t0:.1f} s")


def header_text() -> str:
    """two_way_stack.cuh's leading comment as one line of words."""
    lines = []
    for line in (CSRC / "two_way_stack.cuh").read_text().splitlines():
        if not line.startswith("//"):
            break
        lines.append(line[2:].strip())
    return " ".join(lines)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_shared_memory_union_fits_at_every_token_count(dtype):
    """The kernel's shared memory, the largest of its stages', fits a block at
    5 to 8 tokens: an image pass's, the t2i pass with its q chunk (K1's own,
    the largest at 8 tokens) or the i2t pass (K1's, the same at any count);
    the final pass 512 B less than the first; at 8 tokens each is what the
    header states."""
    for T in ptwl.LAYER_TOKENS:
        smem = pws.fused_smem(dtype, T)
        assert smem["kernel"] == max(v for k, v in smem.items() if k != "kernel")
        assert smem["kernel"] == max(smem["t2i"], smem["i2t"]) <= pt2i.SMEM_LIMIT, (T, smem)
        assert smem["t2i"] == ptwl.image_pass_smem(dtype, T)["t2i"]
        assert smem["i2t"] == ptwl.image_pass_smem(dtype, T)["i2t"]
        assert smem["t2i_final"] == smem["t2i"] - 128 * 4
    at8 = pws.fused_smem(dtype, 8)
    assert at8["kernel"] == at8["t2i"]
    doc = re.search(r"the t2i pass with its q chunk ([\d,]+) B in bf16 and ([\d,]+) in fp32 at "
                    r"T = 8 \(the largest\), the final t2i pass 512 B less, the i2t pass "
                    r"([\d,]+) and ([\d,]+), tokens_mid ([\d,]+), tokens_in ([\d,]+)",
                    header_text())
    num = lambda g: int(doc.group(g).replace(",", ""))  # noqa: E731
    bf16 = dtype == torch.bfloat16
    assert at8["t2i"] == num(1 if bf16 else 2)
    assert at8["i2t"] == num(3 if bf16 else 4)
    assert (at8["tokens_mid"], at8["tokens_in"]) == (num(5), num(6)) == (98_304, 59_392)


def transformer(dtype):
    return init_mask_decoder(CoreConfig(), 1).transformer.to(dtype).eval()


def test_bf16_ring_blocks_are_k1s_and_k2s():
    """The pointers the wrapper hands the kernel: the first 50 in the order of
    the entry's first version, then in bf16 each layer's image passes'
    ring blocks (K1's pack, ``two_way_layer._pack``) and the final [k | v]
    as K2's ring blocks (``t2i_flash._final_blocks`` of the same weights);
    in fp32 none (the producer splits the weights as it streams them)."""
    p = transformer(torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    bf = lambda *s: torch.randn(*s, generator=g).to(torch.bfloat16)  # noqa: E731
    n, T = 2, 6
    tokens, keys = bf(n, T, 256), bf(n, N, 256)
    kpe, qpe, kpe_f = [bf(N, 128), bf(N, 128)], [bf(N, 128), bf(N, 128)], bf(N, 128)
    ptrs = pws.launch_pointers(p, tokens, tokens, keys, kpe, qpe, kpe_f, None, torch.bfloat16)
    assert len(ptrs) == 55
    assert ptrs[0] is tokens and ptrs[2] is keys and ptrs[3] is None
    cpu = torch.device("cpu")
    for i, lp in enumerate(p.layers):
        pk = ptwl._pack(lp, cpu, torch.bfloat16)
        assert ptrs[4 + 8 * i] is pk["wtok"] and ptrs[6 + 8 * i] is pk["w_img"]
        assert ptrs[10 + 8 * i] is kpe[i] and ptrs[11 + 8 * i] is qpe[i]
        assert ptrs[50 + 2 * i] is pk["w_img_blocks"] and ptrs[51 + 2 * i] is pk["wo_i_blocks"]
    assert ptrs[20] is kpe_f
    assert ptrs[48].shape == (n, N, 256) and ptrs[49].shape == (n, T, 256)
    fa = p.final_attn_t2i
    w, _ = pt2i._pack(fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, cpu, torch.bfloat16)
    fin = pws._final_pack(p, cpu, torch.bfloat16)
    assert torch.equal(fin["wkv"], w.reshape(-1))
    k2 = pt2i._final_blocks(fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, w)
    assert ptrs[54] is fin["wkv_blocks"] and torch.equal(fin["wkv_blocks"], k2)
    # fp32: no blocks
    p32 = transformer(torch.float32)
    f32 = [x.float() for x in (tokens, keys, kpe_f)]
    ptrs = pws.launch_pointers(p32, f32[0], f32[0], f32[1], [x.float() for x in kpe],
                               [x.float() for x in qpe], f32[2], None, torch.float32)
    assert ptrs[50:] == [None] * 5


def test_final_blocks_repack_after_an_in_place_write():
    """P7 for the stack wrapper's final pack: an in-place write to the final
    attention's weight (an optimizer's step) makes its ring blocks again."""
    p = transformer(torch.bfloat16)
    cpu = torch.device("cpu")
    first = pws._final_pack(p, cpu, torch.bfloat16)
    assert pws._final_pack(p, cpu, torch.bfloat16) is first
    fa = p.final_attn_t2i
    with torch.no_grad():
        fa.v_proj.w.add_(1.0)
    second = pws._final_pack(p, cpu, torch.bfloat16)
    assert second is not first and not torch.equal(second["wkv_blocks"], first["wkv_blocks"])
    w, _ = pt2i._pack(fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, cpu, torch.bfloat16)
    assert torch.equal(second["wkv_blocks"], pt2i.ring_blocks(w, 64, pt2i.FINAL_CHUNK_ORDER))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("flag,name", [("STACK_FUSED", "two_way_stack_fused"),
                                       ("GRID_FUSED", "two_way_grid_fused")])
def test_flagged_decode_runs_one_schedule_call_and_k3(monkeypatch, flag, name):
    """A mask decode under STACK_FUSED or GRID_FUSED calls its schedule once
    and the decoder tail (K3) once, and K1 and K2 not at all: the launches
    that chip_smoke.py's ``schedule_launches`` expects on the card (one
    launch a call each)."""
    calls = {}

    def counting(fname, fn):
        def wrapped(*a, **kw):
            calls[fname] = calls.get(fname, 0) + 1
            return fn(*a, **kw)
        return wrapped

    for fname in ("two_way_stack_fused", "two_way_grid_fused", "two_way_layer",
                  "two_way_layer_dma", "decoder_tail", "t2i_flash_kv"):
        monkeypatch.setattr(psd, fname, counting(fname, getattr(psd, fname)))
    for f in ("STACK_FUSED", "GRID_FUSED", "DMA_FUSED"):
        monkeypatch.setattr(psd, f, f == flag)
    dec = init_mask_decoder(CoreConfig(), 1).eval()
    g = torch.Generator().manual_seed(1)
    img = 0.5 * torch.randn(1, 64, 64, 256, generator=g)
    pe, sparse = torch.randn(1, 64, 64, 256, generator=g), torch.randn(1, 1, 256, generator=g)
    masks, _, _ = psd.mask_decoder(dec, img, pe, sparse, 0.1 * img, False)
    assert torch.isfinite(masks).all()
    assert calls == {name: 1, "decoder_tail": 1}
    assert chip_smoke().schedule_launches(name.split("_")[2]) == {name: 1, "decoder_tail": 1}


def test_kernel_bits_holds_the_schedule_cases():
    """kernel_bits compares and times K1-stack and K1-grid (``--only
    K1-stack,K1-grid``): at 5, 6 and 8 tokens, 40 and 128 candidates, on rows
    and on a store through idx, bf16 and fp32, each case held to the old
    library's bits; the bf16 comparison runs both at 40 candidates too. An
    older library's entry takes the same arguments (its first 50 pointers)
    and the schedule alone: a team size raises."""
    cpu = torch.device("cpu")
    labels = [label for label, _ in kb.stack_cases(cpu)]
    assert len(labels) == len(set(labels)) == 2 * 2 * 3 * 2 * 2 == 48
    for sfx in ("", "@fp32"):
        for name in ("K1-stack", "K1-grid"):
            for T in (5, 6, 8):
                for n in (40, 128):
                    for rows in ("rows", "store-indexed"):
                        assert f"{name}{sfx} [{n}, 4096], {T} tokens, {rows}" in labels
    assert "cor_two_way_fused" in kb._COMPARED and "cor_two_way_fused" in kb._ENTRIES
    assert "two_way_stack" in kb._WRAPPER_MODULES
    assert not any("exclu" in line for line in kb.__doc__.splitlines() if "K1-stack" in line)

    calls = []

    class Old:
        def cor_two_way_fused(self, *a):
            calls.append(a)
            return 0

    old = kb._OldABI(Old(), {})
    args = (256, 40, 6, 4096, "ptrs", 0.17, 0.25, 1e-5, 0, "s")
    assert old.cor_two_way_fused(1, *args) == 0 and calls == [(1, *args)]
    with pytest.raises(TypeError, match="cluster 0 or 1"):
        old.cor_two_way_fused(1 | 4 << 8, *args)
    # the entry's declaration is the first version's: the same arguments
    decl = lambda text: re.search(r'extern "C" int cor_two_way_fused\(([^)]*)\)', text).group(1)  # noqa: E731
    words = lambda d: re.findall(r"\w+", d)  # noqa: E731
    assert words(decl((CSRC / "two_way_stack.cu").read_text())) == [
        "int", "cluster", "int", "S", "int", "n", "int", "n_tok", "int", "N", "const", "void",
        "const", "ptrs", "float", "self_scale", "float", "cross_scale", "float", "eps", "int",
        "f32", "void", "stream"]
    assert len(kb._build._SIGNATURES["cor_two_way_fused"]) == 11


# ---------------------------------------------------------------------------
# on the card: both schedules against their plain versions
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.fixture(scope="module")
def models():
    """The SAM-base decoder's transformer in bf16 and fp32 on the card, with
    random image-PE projections."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        p = init_mask_decoder(CoreConfig(), 1).eval().transformer.to("cuda", dt)
        g = torch.Generator(device="cuda").manual_seed(3)
        pes = [(0.5 * torch.randn(N, 128, generator=g, device="cuda")).to(dt) for _ in range(5)]
        out[dt] = (p, pes[:2], pes[2:4], pes[4])
    return out


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def close(got, want, dtype):
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:
        assert rel_err(got, want) <= DECODE_REL, rel_err(got, want)
    else:
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=FP32_TOL)


def inputs(dtype, n, T, indexed, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed + 100 * n + T)
    tokens = torch.randn(n, T, 256, generator=g, device="cuda").to(dtype)
    S = 256 if indexed else n
    rows = (0.5 * torch.randn(S, N, 256, generator=g, device="cuda")).to(dtype)
    idx = (torch.randint(0, S, (n,), generator=g, device="cuda", dtype=torch.int32)
           if indexed else None)
    return tokens, rows, idx


@pytest.mark.gpu
@pytest.mark.parametrize("T", [5, 6, 7, 8])
@pytest.mark.parametrize("n", [1, 3, 40, 129])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_schedules_match_plain(cuda_device, models, dtype, n, T):
    """K1-stack and K1-grid (one launch each) against two_way_stack_plain at
    [n, 4096, 256], on rows and on a store through idx: bf16 within
    DECODE_REL of max |plain|, fp32 within cor_tpu's 5e-4 (TF32 off);
    K1-grid's keys equal two K1 launches' bit for bit; the same bits from
    call to call."""
    p, kpe, qpe, kpe_f = models[dtype]
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    for indexed in (False, True):
        tokens, rows, idx = inputs(dtype, n, T, indexed)
        for fn, grid in ((pws.two_way_stack_fused, False), (pws.two_way_grid_fused, True)):
            before = getattr(fn, counted)
            got = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx)
            again = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx)
            torch.cuda.synchronize()
            assert getattr(fn, counted) == before + 2
            assert got[0].shape == (n, T, 256) and got[1].shape == (n, N, 256)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
            want = pws.two_way_stack_plain(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx,
                                           round_between_layers=grid)
            for g, w in zip(got, want):
                close(g, w, dtype)
            if grid:
                t1, k1 = ptwl.two_way_layer(p.layers[0], tokens, tokens, rows, kpe[0], qpe[0],
                                            True, idx=idx)
                _, k2 = ptwl.two_way_layer(p.layers[1], t1, tokens, k1, kpe[1], qpe[1], False)
                assert torch.equal(got[1], k2)


@pytest.mark.gpu
def test_team_sizes_follow_the_rule(cuda_device):
    """The CTAs of a candidate's token stages that the kernel takes on the
    card (launch_team, csrc/two_way_stack.cuh choose_cluster): on an H100's
    132 SMs (resident clusters of 2, 4, 8: 66, 30, 15), K1-stack 8, 2, 1 and
    1 at 3, 40, 128 and 300 candidates; K1-grid 8, 2, 1 in bf16 and 8, 8, 1
    in fp32 at 3, 40 and 128, the sizes tools/cluster_sweep.py timed
    fastest."""
    if torch.cuda.get_device_properties(0).multi_processor_count != 132:
        pytest.skip("the sizes are the H100's (132 SMs)")
    for dt in (torch.bfloat16, torch.float32):
        assert [pws.launch_team(pws.two_way_stack_fused, n, 6, N, dt)
                for n in (3, 40, 128, 300)] == [(8, 120), (2, 132), (1, 132), (1, 132)]
        want = [8, 2, 1] if dt == torch.bfloat16 else [8, 8, 1]
        assert [pws.launch_team(pws.two_way_grid_fused, n, 6, N, dt)[0]
                for n in (3, 40, 128)] == want


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_every_team_size_gives_the_same_bits(cuda_device, models, dtype):
    """Each team size (the CTA alone, clusters of 2, 4 and 8) gives the bits of
    the kernel's own choice, in both schedules: every sum is one warp's or
    one thread's, in the same order whatever the split."""
    p, kpe, qpe, kpe_f = models[dtype]
    tokens, rows, idx = inputs(dtype, 40, 6, True, seed=5)
    for fn in (pws.two_way_stack_fused, pws.two_way_grid_fused):
        want = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx)
        try:
            for size in (1, 2, 4, 8):
                pws.CLUSTER_SIZE[fn.__name__] = size
                got = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx)
                torch.cuda.synchronize()
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (fn.__name__, size)
        finally:
            pws.CLUSTER_SIZE[fn.__name__] = 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_beyond_what_is_resident(cuda_device, models, dtype):
    """300 candidates: more than K1-stack's co-resident CTAs take in one
    round of its grid-stride stages, and more clusters than are resident at
    once for K1-grid; against the plain version, and K1-grid's keys against
    two K1 launches."""
    p, kpe, qpe, kpe_f = models[dtype]
    tokens, rows, idx = inputs(dtype, 300, 6, False, seed=9)
    for fn, grid in ((pws.two_way_stack_fused, False), (pws.two_way_grid_fused, True)):
        got = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f)
        want = pws.two_way_stack_plain(p, tokens, tokens, rows, kpe, qpe, kpe_f,
                                       round_between_layers=grid)
        for g, w in zip(got, want):
            close(g, w, dtype)
        del want
        if grid:
            t1, k1 = ptwl.two_way_layer(p.layers[0], tokens, tokens, rows, kpe[0], qpe[0], True)
            _, k2 = ptwl.two_way_layer(p.layers[1], t1, tokens, k1, kpe[1], qpe[1], False)
            assert torch.equal(got[1], k2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_graph_replay_gives_eager_bits(cuda_device, models, dtype):
    """Three CUDA-graph replays of each schedule give the eager call's bits:
    each launch leaves its barriers as it found them."""
    p, kpe, qpe, kpe_f = models[dtype]
    tokens, rows, idx = inputs(dtype, 40, 8, True, seed=11)
    for fn in (pws.two_way_stack_fused, pws.two_way_grid_fused):
        eager = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, idx=idx)
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, eager))
