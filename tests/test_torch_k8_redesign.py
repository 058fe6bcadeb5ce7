"""K8a and K8b, the image passes of the SAM decoder's K8 route (the fused
decode above 8 tokens), redesigned for Hopper on K1's passes: K8a
(csrc/t2i_proj_q.cu) runs K1's t2i pass (csrc/twl_t2i.cuh) with its q chunk
and K2's tokens and folded combine, one launch; K8b runs K1's i2t pass
(csrc/twl_i2t.cu) at 9 to 32 tokens.

On the CPU: K8a's bf16 ring blocks are K1's for the same weights; both
passes' shared memory fits the 232,448 B a block may take at 5 to 32 tokens
in both dtypes and is what the sources' headers state; K8a is one launch, and
a decode on the K8 route launches K8a twice, K8b twice, K2 and K3 once
(chip_smoke.py's ``route_launches``); kernel_bits times K8a and K8b and the
K8 route's decode, and serves an older library's K8a by the shared image
pass and the combine and its K8b above 8 tokens by the shared body. The
tests marked ``gpu`` hold the new kernels against their plain versions on
the card (TF32 off) at 9 to 32 tokens and ragged candidate counts, and a
CUDA-graph replay of K8a and K2 against the eager calls:

    python -m pytest tests/test_torch_k8_redesign.py -m gpu --noconftest
"""

from __future__ import annotations

import copy
import importlib.util
import re
import time
from pathlib import Path

import pytest
import torch

from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
from cor_tpu_torch.ops.kernels import i2t_attention as pi2t
from cor_tpu_torch.ops.kernels import t2i_flash as pt2i
from cor_tpu_torch.ops.kernels import two_way_layer as ptwl
from cor_tpu_torch.tools import kernel_bits as kb

DECODE_REL = 2e-2  # bf16 kernels against their plain versions, relative to the max
FP32_TOL = {"proj_q_t2i_flash": 5e-4, "i2t_attention_fused": 2e-4}  # cor_tpu's fp32 tolerances
ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "cor_tpu_torch" / "csrc"


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
        rep.write_line(f"tests/test_torch_k8_redesign.py: {time.perf_counter() - t0:.1f} s")


def test_k8a_ring_blocks_are_k1s():
    """K8a's pack of a layer's t2i k, v and i2t q projections is K1's: the
    same [k | v | q] weight and bias, and in bf16 the same ring blocks (chunks
    in the order q, k, v), so the pass reads one layout for both."""
    lp = init_mask_decoder(CoreConfig(), 1).transformer.layers[1].to(torch.bfloat16)
    t2i, i2t = lp.cross_attn_t2i, lp.cross_attn_i2t
    cpu = torch.device("cpu")
    k1 = ptwl._make_pack(lp, cpu, torch.bfloat16)
    args = (t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b)
    w, b = pt2i._pack(*args, cpu, torch.bfloat16, i2t.q_proj.w, i2t.q_proj.b)
    assert torch.equal(w, k1["w_img"]) and torch.equal(b, k1["b_img"])
    blocks = pt2i._proj_q_blocks(*args, i2t.q_proj.w, i2t.q_proj.b, w)
    assert torch.equal(blocks, k1["w_img_blocks"])
    assert pt2i._proj_q_blocks(*args, i2t.q_proj.w, i2t.q_proj.b, w) is blocks  # kept
    # block 0 is q's inputs 0..63: element (o, k) at ((o / 8) * 8 + k / 8) * 64 + ...
    for o, k in ((0, 0), (127, 63), (9, 17)):
        assert blocks[((o // 8) * 8 + k // 8) * 64 + (o % 8) * 8 + k % 8] == i2t.q_proj.w[o, k]
    # K8b's bf16 out-projection blocks are K1's too
    wo, wo_blocks, bo_ln = pi2t._pack(i2t.out_proj.w, i2t.out_proj.b, lp.norm4.scale,
                                      lp.norm4.bias, cpu, torch.bfloat16)
    assert torch.equal(wo, k1["wo_i"]) and torch.equal(wo_blocks, k1["wo_i_blocks"])
    assert torch.equal(bo_ln, k1["bo_ln4"])
    assert pi2t._pack(i2t.out_proj.w.float(), i2t.out_proj.b, lp.norm4.scale, lp.norm4.bias,
                      cpu, torch.float32)[1] is None  # fp32 splits the weight as it streams it


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_shared_memory_fits_at_every_token_count(dtype):
    """K8a's and K8b's shared memory fits a block at 5 to 32 tokens and is
    what the sources' headers state; K8a's is K1's t2i pass's at 8 tokens
    with K2's ticket slots at any T above, K8b's is K1's i2t pass's up to 8
    tokens and the wide instantiation's above."""
    for T in range(pt2i.MIN_TOKENS, pt2i.MAX_TOKENS + 1):
        assert pt2i.proj_q_smem(dtype, T) <= pt2i.SMEM_LIMIT, T
        assert pi2t.i2t_smem(dtype, T) <= pt2i.SMEM_LIMIT, T
    tickets = 4 * (2 if dtype == torch.bfloat16 else 1)
    assert pt2i.proj_q_smem(dtype, 32) == ptwl.image_pass_smem(dtype, 8)["t2i"] + tickets
    assert pi2t.i2t_smem(dtype, 8) == ptwl.image_pass_smem(dtype, 8)["i2t"]
    assert pi2t.i2t_smem(dtype, 9) == pi2t.i2t_smem(dtype, 32) < pi2t.i2t_smem(dtype, 8)
    col = 1 if dtype == torch.bfloat16 else 2
    doc = re.search(r"at any T: ([\d,]+) B\n//\s+in bf16, ([\d,]+) in fp32",
                    (CSRC / "t2i_proj_q.cu").read_text())
    assert pt2i.proj_q_smem(dtype, 32) == int(doc.group(col).replace(",", ""))
    doc = re.search(r"kWide uses ([\d,]+) B in bf16,\n// ([\d,]+) in fp32",
                    (CSRC / "twl_i2t.cu").read_text())
    assert pi2t.i2t_smem(dtype, 32) == int(doc.group(col).replace(",", ""))


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k8a_is_one_launch_and_the_route_counts_it():
    """K8a is one launch a call; a fused decode above 8 tokens launches K8a
    and K8b once a layer, K2 and K3 once, and no K1 (chip_smoke.py's counts,
    which phase 34 holds each decode's launches to)."""
    assert pt2i.LAUNCHES == pt2i.FINAL_LAUNCHES == 1
    cs = chip_smoke()
    for T in (9, 16, 32):
        assert cs.route_launches(T) == {"two_way_layer": 0, "t2i_flash_kv": 1,
                                        "decoder_tail": 1, "proj_q_t2i_flash": 2,
                                        "i2t_attention_fused": 2}
    assert cs.route_launches(8)["proj_q_t2i_flash"] == cs.route_launches(8)[
        "i2t_attention_fused"] == 0


def test_kernel_bits_holds_the_k8_cases(tmp_path):
    """kernel_bits times K8a and K8b at 9, 11, 16 and 32 tokens, 40 and 128
    candidates, bf16 and fp32, and the K8 route's fused decode at 16 tokens
    (``--only K8a,K8b``); an old library without cor_t2i_proj_q runs K8a
    through the shared image pass and the combine, and an old cor_twl_i2t
    that takes at most 8 tokens is served above 8 by cor_twl_image_i2t."""
    cpu = torch.device("cpu")
    labels = [label for label, _ in kb.k8_cases(cpu)]
    assert len(labels) == len(set(labels)) == 2 * 2 * len(kb.K8_TOKENS) * 2 == 32
    for sfx in ("", "@fp32"):
        for name in ("K8a", "K8b"):
            for T in (9, 11, 16, 32):
                for n in (40, 128):
                    assert f"{name}{sfx} [{n}, 4096, 256], {T} tokens" in labels
    assert not any(o in label for label in labels for o in ("K1", "K2", "K3", "K4", "K6"))
    assert [label for label, _ in kb.k8_decode_cases(cpu)] == [
        f"fused decode{sfx} [{n}, 4096], 16 tokens, K8 route" for sfx in ("", " fp32")
        for n in (40, 128)]

    calls = []

    class Old:  # a library of the shared entries and K1's narrow i2t pass
        def cor_t2i_image_pass(self, *a):
            calls.append(("pass", a))
            return 0

        def cor_t2i_combine(self, *a):
            calls.append(("combine", a))
            return 0

        def cor_twl_image_i2t(self, *a):
            calls.append(("shared i2t", a))
            return 0

        def cor_twl_i2t(self, *a):
            calls.append(("i2t", a))
            return 0

    old = kb._OldABI(Old(), {}, narrow_i2t=True)
    # keys, n, n_tok, N, w, w_blocks, b, kpe, qpe, qt, q_img, pm, pl, pa, tickets, out, f32,
    # stream
    assert old.cor_t2i_proj_q("keys", 3, 9, 4096, "w", "blocks", "b", "kpe", "qpe", "qt", "q",
                              "pm", "pl", "pa", "tk", "out", 1, "s") == 0
    assert calls == [("pass", ("keys", 0, 0, 0, 3, 3, 9, 4096, "w", "b", "kpe", "qpe", "qt", "q",
                               "pm", "pl", "pa", 1, "s")),
                     ("combine", ("pm", "pl", "pa", 64, 3, 9, "out", 1, "s"))]
    args = tuple(range(19))
    for T, want in ((6, ("i2t", args[:6] + (6,) + args[7:])),
                    (16, ("shared i2t", args[:6] + (16,) + args[7:12] + args[13:]))):
        calls.clear()
        assert old.cor_twl_i2t(*args[:6], T, *args[7:]) == 0
        assert calls == [want]
    # the narrow entry is found in an older csrc/, not in the current one
    assert not kb.narrow_i2t(CSRC)
    (tmp_path / "twl_i2t.cu").write_text(
        (CSRC / "twl_i2t.cu").read_text().replace("n_tok > kMaxTok ||", "n_tok > kMaxT ||"))
    assert kb.narrow_i2t(tmp_path)
    assert len(kb._build._SIGNATURES["cor_t2i_proj_q"]) == 18


# ---------------------------------------------------------------------------
# on the card: the new K8a and K8b against their plain versions
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
def layers():
    """The SAM-base decoder's second layer in bf16 and fp32 on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    lp = init_mask_decoder(CoreConfig(), 1).eval().transformer.layers[1]
    return {dt: copy.deepcopy(lp).to("cuda", dt) for dt in (torch.bfloat16, torch.float32)}


def close(got, want, dtype, tol):
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all()
    if dtype == torch.bfloat16:
        assert rel_err(got, want) <= DECODE_REL, rel_err(got, want)
    else:
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)


def k8a_args(lp, device, n, T, N=4096, seed=0):
    dt = next(lp.parameters()).dtype
    g = torch.Generator(device=device).manual_seed(seed + 100 * n + T)
    keys = (0.5 * torch.randn(n, N, 256, generator=g, device=device)).to(dt)
    kpe, qpe = ((0.5 * torch.randn(N, 128, generator=g, device=device)).to(dt) for _ in range(2))
    q_tok = torch.randn(n, T, 128, generator=g, device=device).to(dt)
    t2i, i2t = lp.cross_attn_t2i, lp.cross_attn_i2t
    return (keys, t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b, i2t.q_proj.w,
            i2t.q_proj.b, kpe, qpe, q_tok, 8)


def k8b_args(lp, device, n, T, N=4096, seed=0):
    dt = next(lp.parameters()).dtype
    g = torch.Generator(device=device).manual_seed(seed + 100 * n + T + 1)
    keys = (0.5 * torch.randn(n, N, 256, generator=g, device=device)).to(dt)
    q_img = (0.5 * torch.randn(n, N, 128, generator=g, device=device)).to(dt)
    k_tok, v_tok = (torch.randn(n, T, 128, generator=g, device=device).to(dt) for _ in range(2))
    o = lp.cross_attn_i2t.out_proj
    return (q_img, keys, k_tok, v_tok, o.w, o.b, lp.norm4.scale, lp.norm4.bias, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [9, 11, 16, 32])
@pytest.mark.parametrize("n", [1, 3, 41, 129])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k8a_matches_plain(cuda_device, layers, dtype, n, T):
    """K8a (one launch, the combine folded in) against proj_q_t2i_flash_plain
    at [n, 4096, 256]: q_img and the attention, bf16 within DECODE_REL of
    max |plain|, fp32 within cor_tpu's 5e-4 (TF32 off); the same bits from
    call to call (the tickets back at zero)."""
    args = k8a_args(layers[dtype], cuda_device, n, T)
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    before = getattr(pt2i.proj_q_t2i_flash, counted)
    got, again = pt2i.proj_q_t2i_flash(*args), pt2i.proj_q_t2i_flash(*args)
    torch.cuda.synchronize()
    assert getattr(pt2i.proj_q_t2i_flash, counted) == before + 2 * pt2i.LAUNCHES
    assert got[0].shape == (n, 4096, 128) and got[1].shape == (n, T, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, w in zip(got, pt2i.proj_q_t2i_flash_plain(*args)):
        close(g, w, dtype, FP32_TOL["proj_q_t2i_flash"])


@pytest.mark.gpu
@pytest.mark.parametrize("T", [8, 9, 11, 16, 32])
@pytest.mark.parametrize("n", [1, 3, 41, 129])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_k8b_matches_plain(cuda_device, layers, dtype, n, T):
    """K8b (one launch: K1's instantiation at 8 tokens, the wide one above)
    against i2t_attention_fused_plain at [n, 4096, 256]: bf16 within
    DECODE_REL of max |plain|, fp32 within cor_tpu's 2e-4 (TF32 off); the
    same bits from call to call."""
    args = k8b_args(layers[dtype], cuda_device, n, T)
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    before = getattr(pi2t.i2t_attention_fused, counted)
    got, again = pi2t.i2t_attention_fused(*args), pi2t.i2t_attention_fused(*args)
    torch.cuda.synchronize()
    assert getattr(pi2t.i2t_attention_fused, counted) == before + 2
    assert got.shape == (n, 4096, 256) and torch.equal(got, again)
    close(got, pi2t.i2t_attention_fused_plain(*args), dtype, FP32_TOL["i2t_attention_fused"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_ragged_tiles(cuda_device, layers, dtype):
    """N = 64 * 65 rows (65 tiles: an odd count, which the two-tile items do
    not divide; K8b's warpgroups still meet at every candidate) through K8a
    and K8b at 9 and 32 tokens, against the plain versions."""
    lp = layers[dtype]
    for T in (9, 32):
        args = k8a_args(lp, cuda_device, 3, T, N=64 * 65, seed=7)
        for g, w in zip(pt2i.proj_q_t2i_flash(*args), pt2i.proj_q_t2i_flash_plain(*args)):
            close(g, w, dtype, FP32_TOL["proj_q_t2i_flash"])
        args = k8b_args(lp, cuda_device, 3, T, N=64 * 65, seed=7)
        close(pi2t.i2t_attention_fused(*args), pi2t.i2t_attention_fused_plain(*args), dtype,
              FP32_TOL["i2t_attention_fused"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_graph_replay_of_k8a_and_k2_gives_eager_bits(cuda_device, layers, dtype):
    """Three CUDA-graph replays of K8a followed by K2 (the two share their
    per-candidate tickets) give the eager calls' bits, and leave the tickets
    at zero."""
    dec = init_mask_decoder(CoreConfig(), 1).eval().to("cuda", dtype)
    fa = dec.transformer.final_attn_t2i
    a8 = k8a_args(layers[dtype], cuda_device, 40, 16)
    a2 = (a8[0], fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, a8[7], a8[9], 8)
    eager8, eager2 = pt2i.proj_q_t2i_flash(*a8), pt2i.t2i_flash_kv(*a2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out8, out2 = pt2i.proj_q_t2i_flash(*a8), pt2i.t2i_flash_kv(*a2)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out8, eager8))
        assert torch.equal(out2, eager2)
    assert not pt2i._TICKETS[cuda_device.index if cuda_device.index is not None else 0].any()
