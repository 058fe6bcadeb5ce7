"""The port's Recall@K protocol, its IoU-ranked store decode and its scan
options, against cor_tpu's on the CPU in fp32.

The reference side runs on a one-device mesh (``make_mesh(jax.devices()[:1])``):
on the tests' 8-device CPU mesh cor_tpu decodes each shard's local top k and
ranks the 8k pool, another question than the port's one-device decode. The
model is cor_tpu's tiny one (tests/helpers.py) with the port's seeded
weights as a cor_tpu tree, loaded back into the port's modules by the weight
bridge; cor_tpu's jitted graphs are shared across tests through the
module fixture. The tiny random model scores many candidates alike, so the
protocol tests nudge every gallery row by a seeded vector in both packages,
as tests/test_retrieval.py does before it compares rankings.

The test marked ``gpu`` holds the engine's store decode on the card (K1, K2,
K3) against the same decode through the kernels' plain versions:

    python -m pytest tests/test_torch_retrieve.py -m gpu --noconftest
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from cor_tpu_torch.cli import retrieve as pcli
from cor_tpu_torch.config import EvalConfig
from cor_tpu_torch.data.pipeline import DataLoader
from cor_tpu_torch.data.synthetic import SyntheticDataset
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import pooling as ppool
from cor_tpu_torch.models import prompt_encoder as ppe
from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.models import siglip as psig
from cor_tpu_torch.models import support_branch as psb
from cor_tpu_torch.models.sam_encoder import SamEncoder, SamEncoderConfig
from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail, decoder_tail_plain
from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv, t2i_flash_kv_plain
from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain
from cor_tpu_torch.retrieval import engine as pengine
from cor_tpu_torch.retrieval import protocol as pprot
from cor_tpu_torch.retrieval.index import build_gallery, save_gallery_index

SCORE_TOL = 1e-5  # the scans' and the rescore's cosines
IOU_TOL = 5e-4  # the composed decoder's tolerance (tests/test_torch_decoder.py)
DS = dict(length=10, query_img_size=64, support_img_size=32, context_length=8, vocab_size=64,
          seed=5)


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_retrieve.py: {time.perf_counter() - t0:.1f} s")


def port_config() -> pcore.CoreConfig:
    """tests.helpers.tiny_core_config in the port's classes."""
    sup = psb.SupportBranchConfig(
        prompt_dim=16, proj_hidden=24,
        siglip_override=psig.SigLIPConfig(
            psig.SigLIPVisionConfig(image_size=32, patch_size=16, width=32, depth=2, num_heads=2),
            psig.SigLIPTextConfig(context_length=8, vocab_size=64, width=32, depth=2,
                                  num_heads=2)),
        adapter_override=ppool.MaskAdapterConfig(32, 16, 8, 16, 4),
    )
    return pcore.CoreConfig(
        compute_dtype="float32",
        encoder_override=SamEncoderConfig(img_size=64, patch_size=16, embed_dim=32, depth=2,
                                          num_heads=2, out_chans=16, window_size=2,
                                          global_attn_indexes=(1,)),
        support_override=sup,
        decoder_override=psd.MaskDecoderConfig(
            transformer_dim=16, iou_head_hidden_dim=16,
            transformer=psd.TwoWayTransformerConfig(depth=2, embedding_dim=16, num_heads=2,
                                                    mlp_dim=32)),
        prompt_override=ppe.PromptEncoderConfig(16, (4, 4), (64, 64)),
    )


def memoized(fn):
    """fn with its results kept by argument: cor_tpu builds a new jitted
    graph on every call of its factories, and each compiles anew."""
    cache = {}

    def wrapper(*args, **kw):
        key = tuple(map(repr, args)) + tuple(sorted((k, repr(v)) for k, v in kw.items()))
        if key not in cache:
            cache[key] = fn(*args, **kw)
        return cache[key]

    return wrapper


@pytest.fixture(scope="module")
def ref():
    """cor_tpu's tiny config, weights and one-device mesh, its protocol's
    graph factories shared, and the port's models loaded from the same
    weights."""
    import jax

    import cor_tpu.retrieval.engine as jengine
    import cor_tpu.retrieval.protocol as jprot
    from cor_tpu.parallel import make_mesh
    from cor_tpu_torch.utils.weights import load_cor_tpu_params, to_cor_tpu_tree
    from tests.helpers import tiny_core_config

    jc, pc = tiny_core_config(), port_config()
    # the port's seeded init as a cor_tpu tree (cor_tpu's own init of the
    # tiny model runs op by op and compiles each op on a fresh process)
    params = to_cor_tpu_tree(pcore.init_core_model(pc, 0))

    def port_models():
        enc = load_cor_tpu_params(SamEncoder(pc.encoder), params["image_encoder"])
        sb = load_cor_tpu_params(psb.SupportBranch(pc.support), params["support_branch"])
        dm = load_cor_tpu_params(
            pcore.DecodeModel(ppe.PromptEncoder(pc.prompt), psd.MaskDecoder(pc.decoder)),
            {"prompt_encoder": params["prompt_encoder"], "mask_decoder": params["mask_decoder"]})
        return pprot.prepare_models(pc, enc, sb, dm, device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jprot, "make_candidate_encoder"), (jprot, "make_query_encoder"),
                          (jengine, "make_sharded_retrieve"),
                          (jengine, "make_sharded_retrieve_decode")):
            mp.setattr(mod, name, memoized(getattr(mod, name)))
        yield dict(jc=jc, pc=pc, params=params, mesh=make_mesh(jax.devices()[:1]),
                   models=port_models(), jengine=jengine, jprot=jprot)


def normed(rng, n, d) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def assert_same_ranking(got_ids, want_ids, want_vals, gap):
    """Ids agree wherever the reference's neighbours differ by more than
    ``gap`` (equal values may come in either order)."""
    for g, w, v in zip(got_ids, want_ids, want_vals):
        for i in range(len(w)):
            apart_before = i == 0 or v[i - 1] - v[i] > gap
            apart_after = i == len(w) - 1 or v[i] - v[i + 1] > gap
            if apart_before and apart_after:
                assert g[i] == w[i], (i, g, w, v)


def test_recall_at_k_matches_cor_tpu():
    from cor_tpu.retrieval.engine import recall_at_k

    rng = np.random.default_rng(0)
    retrieved = rng.integers(0, 12, (40, 10))
    targets = rng.integers(0, 12, 40)
    for ks in ((1, 5, 10), (1, 3), (10,)):
        assert pengine.recall_at_k(retrieved, targets, ks) == recall_at_k(retrieved, targets, ks)


SCAN_CASES = {
    "exact": dict(),
    "approx": dict(approx=True),
    "int8-rescore": dict(quantize=True, rescore=True),
    "int8-approx-rescore": dict(quantize=True, approx=True, rescore=True),
    "approx-rescore-target": dict(approx=True, rescore=True, recall_target=0.9, rescore_width=2),
}


@pytest.fixture(scope="module")
def clustered():
    """tests/test_retrieval.py's clustered gallery (408 classes at spread
    0.05, 4096 x 256) and 64 perturbed rows as queries."""
    rng = np.random.default_rng(7)
    centers = normed(rng, 408, 256)
    gallery = centers[rng.integers(0, 408, 4096)]
    gallery = gallery + 0.05 * rng.standard_normal(gallery.shape).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    targets = rng.integers(0, 4096, 64)
    queries = gallery[targets] + 0.02 * rng.standard_normal((64, 256)).astype(np.float32)
    return gallery, queries / np.linalg.norm(queries, axis=1, keepdims=True), targets


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_engine_scan_options_match_cor_tpu(ref, clustered, case):
    """approx (the exact top k in the port), int8, rescore and the recall
    target's defaults on the clustered gallery: ids agree across score gaps
    above 1e-5 and scores within 1e-5; the rescore's scores are the true
    fp32 cosines of the returned rows."""
    import jax.numpy as jnp

    gallery, queries, targets = clustered
    kw = SCAN_CASES[case]
    want_engine = ref["jengine"].RetrievalEngine(ref["mesh"], k=10, **kw)
    want_engine.set_gallery(gallery)
    ws, wi = map(np.asarray, want_engine.retrieve(jnp.asarray(queries)))
    engine = pengine.RetrievalEngine(k=10, device="cpu", **kw)
    engine.set_gallery(gallery)
    assert (engine.recall_target, engine.k_scan) == (want_engine.recall_target,
                                                     want_engine.k_scan)
    gs, gi = (t.numpy() for t in engine.retrieve(torch.from_numpy(queries)))
    assert gs.shape == gi.shape == (64, 10)
    np.testing.assert_allclose(gs, ws, atol=SCORE_TOL, rtol=0)
    assert_same_ranking(gi, wi, ws, SCORE_TOL)
    if kw.get("rescore"):
        np.testing.assert_allclose(gs, np.einsum("qd,qkd->qk", queries, gallery[gi]),
                                   atol=SCORE_TOL, rtol=0)
        assert (gi[:, 0] == targets).all()


@pytest.fixture(scope="module")
def store_case():
    """A 24-row gallery with a [24, 4, 4, 16] store, its int8 pair with the
    no-mask prompt baked in (cor_tpu's host quantiser), and the decoder's
    inputs in both packages."""
    from cor_tpu.models.core_model import _cast
    from cor_tpu.models.prompt_encoder import get_dense_pe

    rng = np.random.default_rng(11)
    return dict(gallery=normed(rng, 24, 16),
                store=rng.standard_normal((24, 4, 4, 16)).astype(np.float32),
                queries=normed(rng, 32, 16), cast=_cast, dense_pe=get_dense_pe)


@pytest.mark.parametrize("Q", [3, 32], ids=["one-call", "chunked"])
def test_retrieve_decode_matches_cor_tpu(ref, store_case, Q, monkeypatch):
    """The IoU-ranked store decode against cor_tpu's on one device, k 8: Q 3
    decodes 24 candidates in one call, Q 32 decodes 256 in two chunks of
    128. IoU within the composed decoder's 5e-4, ids across IoU gaps above
    it, cosines within 1e-5; a raw store quantised with the prompt baked in
    answers as the quantised pair does, which is cor_tpu's pair bit for bit."""
    import jax.numpy as jnp

    jengine, params, jc, pc = ref["jengine"], ref["params"], ref["jc"], ref["pc"]
    sc = store_case
    no_mask = params["prompt_encoder"]["no_mask_embed"][0]
    pair = jengine.quantize_candidate_store_host(sc["store"], no_mask)
    want_engine = jengine.RetrievalEngine(ref["mesh"], k=8)
    want_engine.set_gallery(sc["gallery"])
    want_engine.enable_store_decode(jc.decoder, pair)
    image_pe = sc["dense_pe"](sc["cast"](params["prompt_encoder"], jc.dtype), jc.prompt)
    ws, wiou, wi = map(np.asarray, want_engine.retrieve_decode(
        jnp.asarray(sc["queries"][:Q]), sc["cast"](params["mask_decoder"], jc.dtype), image_pe))

    models = ref["models"]
    dec = models.decode_model
    pe = ppe.get_dense_pe(dec.prompt_encoder).to(pc.dtype)
    calls = []
    monkeypatch.setattr(pengine, "mask_decoder",
                        lambda *a, **kw: calls.append(a[3].shape[0]) or psd.mask_decoder(*a, **kw))
    port_pair = pengine.quantize_candidate_store_host(sc["store"], models.no_mask_embed)
    assert all(np.array_equal(a, b) for a, b in zip(port_pair, pair))
    answers = []
    for store, bake in ((port_pair, None), (sc["store"], models.no_mask_embed)):
        engine = pengine.RetrievalEngine(k=8, device="cpu")
        engine.set_gallery(sc["gallery"])
        engine.enable_store_decode(store, no_mask_embed=bake)
        answers.append([t.numpy() for t in engine.retrieve_decode(
            torch.from_numpy(sc["queries"][:Q]), dec.mask_decoder, pe)])
    assert calls == ([24] if Q == 3 else [128, 128]) * 2
    for a, b in zip(*answers):
        np.testing.assert_array_equal(a, b)
    gs, giou, gi = answers[0]
    assert giou.shape == (Q, 8) and np.all(np.diff(giou, axis=1) <= 0)
    np.testing.assert_allclose(giou, wiou, atol=IOU_TOL, rtol=0)
    assert_same_ranking(gi, wi, wiou, IOU_TOL)
    same = gi == wi
    np.testing.assert_allclose(gs[same], ws[same], atol=SCORE_TOL, rtol=0)


def test_store_decode_refusals(ref, store_case):
    """cor_tpu's asserts as ValueErrors: a store before a gallery, a store of
    another row count, a quantised pair given a prompt to bake, a decode
    before enable_store_decode."""
    sc = store_case
    engine = pengine.RetrievalEngine(k=4, device="cpu")
    with pytest.raises(ValueError, match="set_gallery first"):
        engine.enable_store_decode(sc["store"])
    engine.set_gallery(sc["gallery"])
    with pytest.raises(ValueError, match="enable_store_decode first"):
        engine.retrieve_decode(torch.zeros(1, 16), None, None)
    with pytest.raises(ValueError, match="store rows 23 != gallery size 24"):
        engine.enable_store_decode(sc["store"][:23])
    pair = pengine.quantize_candidate_store_host(sc["store"])
    with pytest.raises(ValueError, match="baked in"):
        engine.enable_store_decode(pair, no_mask_embed=np.zeros(16, np.float32))


def test_fused_decode_refuses_more_than_65535_candidates(store_case, monkeypatch):
    """The fused decoder's entry refuses a call of more than 65,535
    candidates, naming ROADMAP Queue 2's @n>65535 row; the engine's store
    decode on the card checks its call size before it scans."""
    psd.check_fused_geometry(64, 6, 256, psd.MAX_CANDIDATES)
    with pytest.raises(ValueError, match=r"ROADMAP Queue 2, @n>65535"):
        psd.check_fused_geometry(64, 6, 256, psd.MAX_CANDIDATES + 1)
    sc = store_case
    engine = pengine.RetrievalEngine(k=8, device="cpu")
    engine.set_gallery(sc["gallery"])
    engine.enable_store_decode(pengine.quantize_candidate_store_host(sc["store"]))
    scans = []
    monkeypatch.setattr(engine, "_scores", lambda q: scans.append(q) or q)
    engine.device = torch.device("meta")  # anything but the CPU runs the check
    dec = psd.MaskDecoder(port_config().decoder)
    # 8193 queries x k 8 = 65,544 candidates, not a multiple of 128: one call
    with pytest.raises(ValueError, match=r"65544 candidates .*@n>65535"):
        engine.retrieve_decode(torch.zeros(8193, 16), dec, None)
    assert not scans


def test_quantize_candidate_store_on_the_device_equals_the_host(store_case):
    """The device quantiser gives the host quantiser's bits (and cor_tpu's)."""
    from cor_tpu.retrieval.engine import quantize_candidate_store

    sc = store_case
    bias = np.linspace(-1, 1, 16, dtype=np.float32)
    for b in (None, bias):
        q, s = pengine.quantize_candidate_store(torch.from_numpy(sc["store"]), b)
        hq, hs = pengine.quantize_candidate_store_host(sc["store"], b)
        jq, js = quantize_candidate_store(sc["store"], None if b is None else np.asarray(b))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        for got in (hq, np.asarray(jq)):
            np.testing.assert_array_equal(q.numpy(), got)
        for got in (hs, np.asarray(js)):
            np.testing.assert_array_equal(s.numpy(), got)


def jax_loader(batch=5):
    from cor_tpu.data.pipeline import DataLoader as JaxDataLoader
    from cor_tpu.data.pipeline import SyntheticDataset as JaxSyntheticDataset

    return JaxDataLoader(JaxSyntheticDataset(**DS), batch_size=batch)


def port_loader(batch=5):
    return DataLoader(SyntheticDataset(**DS), batch, num_workers=2)


def test_encode_manifest_matches_cor_tpu(ref):
    """Gallery, queries and pair ids agree; the int8 store (no-mask prompt
    baked in) within one step, its scales within 1e-5."""
    g, q, ids, (sq, ss) = pprot.encode_manifest(ref["pc"], ref["models"], port_loader(),
                                                keep_store=True)
    jg, jq, jids, (jsq, jss) = ref["jprot"].encode_manifest(ref["jc"], ref["params"],
                                                           jax_loader(), keep_store=True)
    assert g.shape == (10, 16) and sq.shape == (10, 4, 4, 16) and sq.dtype == np.int8
    np.testing.assert_allclose(g, jg, atol=1e-5, rtol=0)
    np.testing.assert_allclose(q, jq, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(ids, jids)
    assert np.abs(sq.astype(np.int32) - jsq).max() <= 1
    np.testing.assert_allclose(ss, jss, atol=0, rtol=1e-5)
    _, _, _, none = pprot.encode_manifest(ref["pc"], ref["models"], port_loader())
    assert none is None


NUDGE = 0.05 * np.random.default_rng(3).standard_normal((10, 16)).astype(np.float32)


def nudge(rows: np.ndarray, start: int) -> np.ndarray:
    out = rows + NUDGE[start:start + len(rows)]
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def nudged_encoder(make, to_port: bool):
    """A candidate-encoder factory whose gallery rows are nudged by NUDGE in
    encode order (the protocol encodes each row once, in order)."""
    def factory(cfg):
        encode, done = make(cfg), [0]

        def nudged(model, images, masks):
            pooled, ie = encode(model, images, masks)
            rows = nudge(np.asarray(pooled.cpu().numpy() if to_port else pooled), done[0])
            done[0] += len(rows)
            return (torch.from_numpy(rows) if to_port else rows), ie

        return nudged

    return factory


@pytest.mark.parametrize("scan", ["fp32", "int8"])
@pytest.mark.parametrize("rerank", [False, True], ids=["scan", "rerank"])
@pytest.mark.parametrize("route", ["one-pass", "index"])
def test_protocol_matches_cor_tpu(ref, tmp_path, monkeypatch, route, rerank, scan):
    """evaluate_retrieval and evaluate_retrieval_with_index, with and without
    the IoU rerank, over the fp32 and the int8 scan: the same recalls as
    cor_tpu's (gallery rows nudged in both, ties broken). The index route
    reads an index written in reverse order (the pair-id join) with an fp16
    store. On one device the rerank reorders the top 10 of 10: recall@10 is
    1.0 with and without it."""
    jprot, pc, jc = ref["jprot"], ref["pc"], ref["jc"]
    kw = dict(ks=(1, 5, 10), rerank=rerank, quantize=scan == "int8")
    if route == "one-pass":
        monkeypatch.setattr(pprot, "make_candidate_encoder",
                            nudged_encoder(pprot.make_candidate_encoder, True))
        monkeypatch.setattr(jprot, "make_candidate_encoder",
                            nudged_encoder(jprot.make_candidate_encoder, False))
        got = pprot.evaluate_retrieval(pc, ref["models"], port_loader(), **kw)
        want = jprot.evaluate_retrieval(jc, ref["params"], jax_loader(), ref["mesh"], **kw)
    else:
        from cor_tpu.retrieval.index import load_gallery_index as j_load

        from cor_tpu_torch.retrieval.index import load_gallery_index

        emb, ids, store = build_gallery(pc, ref["models"].image_encoder, port_loader(),
                                        with_store=True)
        rows = nudge(emb, 0)
        save_gallery_index(tmp_path, rows[::-1], ids[::-1], image_embeddings=store[::-1])
        got = pprot.evaluate_retrieval_with_index(pc, ref["models"], port_loader(),
                                                  load_gallery_index(tmp_path), **kw)
        want = jprot.evaluate_retrieval_with_index(jc, ref["params"], jax_loader(),
                                                   ref["mesh"], j_load(tmp_path), **kw)
    assert got == want
    assert got["gallery_size"] == 10.0 and got["recall@10"] == 1.0


def test_protocol_refusals(ref, tmp_path):
    """The index route raises on pair ids missing from the index and on a
    rerank without a store; keep_store without the decode model raises."""
    from cor_tpu_torch.retrieval.index import load_gallery_index

    pc, models = ref["pc"], ref["models"]
    save_gallery_index(tmp_path, np.eye(10, 16, dtype=np.float32), np.arange(10) + 1000)
    index = load_gallery_index(tmp_path)
    with pytest.raises(ValueError, match="absent from the gallery index"):
        pprot.evaluate_retrieval_with_index(pc, models, port_loader(), index, ks=(1,))
    index["pair_ids"] = np.arange(10)
    with pytest.raises(ValueError, match="--with-store"):
        pprot.evaluate_retrieval_with_index(pc, models, port_loader(), index, ks=(1,),
                                            rerank=True)
    bare = dataclasses.replace(models, decode_model=None, no_mask_embed=None)
    with pytest.raises(ValueError, match="decode model"):
        pprot.encode_manifest(pc, bare, port_loader(), keep_store=True)


@pytest.fixture
def tiny_cli(monkeypatch):
    """The CLIs' config at the tiny model keys."""
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: port_config())


def run_cli(capsys, *argv) -> dict:
    out = pcli.main([*argv, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    return out


def test_cli_retrieve_on_the_cpu(tiny_cli, tmp_path, capsys):
    """cli.retrieve --device cpu: its JSON keys (1, 5 and --k), recall@G
    1.0 with --rerank at k = G, the scan options, --dump-top1, and the
    --gallery-index route on an index from cli.index (the same seeded
    weights: its recalls without --rerank are the one-pass route's)."""
    from cor_tpu_torch.cli import index as index_cli

    base = ["--synthetic", "6", "--batch-size", "3", "--k", "6"]
    plain = run_cli(capsys, *base)
    assert set(plain) == {"recall@1", "recall@5", "recall@6", "gallery_size"}
    assert plain["gallery_size"] == 6 and plain["recall@6"] == 1.0
    rr = run_cli(capsys, *base, "--rerank", "--dump-top1")
    assert rr["recall@6"] == 1.0 and rr["top1_mask_shape"] == [4, 1, 16, 16]
    for flags in (["--int8", "--rescore"], ["--approx", "--recall-target", "0.9"]):
        r = run_cli(capsys, *base, *flags)
        assert set(r) == set(plain) and r["recall@6"] == 1.0
    index_cli.main(["--out", str(tmp_path), "--synthetic", "6", "--batch-size", "3",
                    "--with-store", "--device", "cpu"])
    capsys.readouterr()
    via_index = run_cli(capsys, *base, "--gallery-index", str(tmp_path))
    assert via_index == plain
    assert run_cli(capsys, *base, "--gallery-index", str(tmp_path), "--rerank")["recall@6"] == 1.0


@pytest.mark.parametrize("case", ["rerank-rescore", "manifest", "checkpoint", "index-no-store",
                                  "no-card"])
def test_cli_retrieve_refusals(tiny_cli, tmp_path, capsys, monkeypatch, case):
    """--rerank with --rescore exits 2 with cor_tpu's message; a manifest
    names ROADMAP item 10, a config naming a checkpoint item 5, --rerank
    against an index without a store asks for --with-store, and without a
    card the CLI exits unless told --device cpu."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv, want = {
        "rerank-rescore": (["--synthetic", "4", "--rerank", "--rescore"],
                           "--rerank and --rescore are mutually exclusive"),
        "manifest": ([], "ROADMAP Queue 1, item 10"),
        "checkpoint": (["--synthetic", "4", "--config", str(tmp_path / "cfg.yaml")],
                       "ROADMAP Queue 1, item 5"),
        "index-no-store": (["--synthetic", "4", "--rerank", "--gallery-index", str(tmp_path)],
                           "--with-store"),
        "no-card": (["--synthetic", "4"], "pass --device cpu"),
    }[case]
    (tmp_path / "cfg.yaml").write_text("load_checkpoint_path: /ckpt/best.pth\n")
    save_gallery_index(tmp_path, np.eye(4, 16, dtype=np.float32), np.arange(4))
    with pytest.raises(SystemExit) as e:
        pcli.main([*argv, *([] if case == "no-card" else ["--device", "cpu"])])
    assert e.value.code == 2
    assert want in capsys.readouterr().err


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

IOU_TOL_BF16 = 2e-2  # of max(1, |IoU|): chip_smoke.py's IOU_TOL
IOU_TOL_FP32 = 1e-4  # chip_smoke.py's DECODE_TOL32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_decoder_kernels():
    """The fused decoder with K1, K2 and K3 swapped for their plain
    versions, and TF32 off."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    psd.two_way_layer, psd.t2i_flash_kv = two_way_layer_plain, t2i_flash_kv_plain
    psd.decoder_tail = decoder_tail_plain
    try:
        yield
    finally:
        psd.two_way_layer, psd.t2i_flash_kv, psd.decoder_tail = (two_way_layer, t2i_flash_kv,
                                                                 decoder_tail)
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [16, 32], ids=["one-call", "chunked"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_store_decode_on_the_card_matches_plain_versions(cuda_device, dtype, Q):
    """RetrievalEngine.retrieve_decode on the card at the SAM-base decoder
    (a 64-row int8 store of [64, 64, 256], k 8: 128 candidates in one call,
    or 256 in two chunks of 128) against the same decode with K1, K2 and K3
    swapped for their plain versions: IoU within 2e-2 of max(1, |IoU|) in
    bf16 and 1e-4 in fp32 (TF32 off), ids across IoU gaps above that; K1 8,
    K2 1 and K3 1 launches per chunk."""
    dm = pcore.init_decode_model(pcore.CoreConfig(), 0)
    no_mask = dm.prompt_encoder.no_mask_embed.detach()[0].numpy()
    dm = pcore._cast(dm.to(cuda_device), dtype).eval()
    g = torch.Generator(device=cuda_device).manual_seed(5)
    gallery = torch.nn.functional.normalize(torch.randn(64, 256, generator=g,
                                                        device=cuda_device), dim=1)
    queries = torch.nn.functional.normalize(torch.randn(Q, 256, generator=g,
                                                        device=cuda_device), dim=1)
    store = torch.randn(64, 64, 64, 256, generator=g, device=cuda_device)
    engine = pengine.RetrievalEngine(k=8, device=cuda_device)
    engine.set_gallery(gallery.cpu().numpy())
    engine.enable_store_decode(pengine.quantize_candidate_store(store, no_mask))
    pe = ppe.get_dense_pe(dm.prompt_encoder).to(dtype)
    counted = "launches" if dtype == torch.bfloat16 else "launches_fp32"
    fns = (two_way_layer, t2i_flash_kv, decoder_tail)
    before = [getattr(f, counted) for f in fns]
    s, iou, idx = engine.retrieve_decode(queries, dm.mask_decoder, pe)
    torch.cuda.synchronize()
    chunks = Q * 8 // 128
    assert [getattr(f, counted) - b for f, b in zip(fns, before)] == [8 * chunks, chunks, chunks]
    with plain_decoder_kernels():
        ps, piou, pidx = engine.retrieve_decode(queries, dm.mask_decoder, pe)
    assert torch.isfinite(iou).all() and iou.shape == (Q, 8)
    tol = IOU_TOL_BF16 if dtype == torch.bfloat16 else IOU_TOL_FP32
    err = ((iou - piou).abs() / piou.abs().clamp(min=1)).max().item()
    assert err <= tol, err
    assert_same_ranking(idx.cpu().numpy(), pidx.cpu().numpy(), piou.cpu().numpy(),
                        2 * tol * max(1.0, piou.abs().max().item()))
