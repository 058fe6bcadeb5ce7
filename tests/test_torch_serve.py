"""cor_tpu_torch's retrieval serving against cor_tpu's, on the CPU in fp32.

The same gallery index (written by cor_tpu), the same weights (carried over
by the weight bridge) and the same ``{"synthetic": i}`` requests go through
cor_tpu's RetrievalServer (CPU mesh) and the port's. Rankings must agree
wherever adjacent scores differ by more than 1e-4, and scores within 1e-4;
decoded masks must agree wherever the logit is not within 1e-3 of 0.
"""

import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import cor_tpu.data.tokenizer as jtok
import cor_tpu.models.pooling as jpool
import cor_tpu.models.siglip as jsig
import cor_tpu.models.support_branch as jsb
from cor_tpu.data.pipeline import SyntheticDataset as JaxSyntheticDataset
from cor_tpu.models.core_model import init_core_model
from cor_tpu.retrieval import engine as jengine
from cor_tpu.retrieval.index import load_gallery_index as j_load_index
from cor_tpu.retrieval.index import save_gallery_index as j_save_index
from cor_tpu.retrieval.serve import RetrievalServer as JaxRetrievalServer
from cor_tpu_torch.cli import serve as pcli
from cor_tpu_torch.config import EvalConfig
from cor_tpu_torch.data import tokenizer as ptok
from cor_tpu_torch.data.synthetic import SyntheticDataset
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import pooling as ppool
from cor_tpu_torch.models import prompt_encoder as ppe
from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.models import siglip as psig
from cor_tpu_torch.models import support_branch as psb
from cor_tpu_torch.retrieval import engine as pengine
from cor_tpu_torch.retrieval.index import load_gallery_index, save_gallery_index
from cor_tpu_torch.retrieval.serve import RetrievalServer
from cor_tpu_torch.utils.png import png_encode_gray
from cor_tpu_torch.utils.weights import load_cor_tpu_params
from tests.helpers import TINY_ADAPTER, TINY_ENCODER, TINY_PROMPT, tiny_core_config

REPO = Path(__file__).resolve().parents[1]
VISION = dict(image_size=64, patch_size=16, width=128, depth=2, num_heads=2)
TEXT = dict(context_length=16, vocab_size=512, width=128, depth=2, num_heads=2)
ADAPTER = dict(x_in_channel=128, adapter_in_channel=32, mask_downscaling_mid_channel=8,
               adapter_mid_channel=32, num_output_maps=4)
BRANCH = dict(prompt_dim=64, proj_hidden=96)
GALLERY = 48


def core_configs():
    """A tiny CORE config in both packages (fp32), SigLIP at width 128."""
    jsup = jsb.SupportBranchConfig(
        siglip_override=jsig.SigLIPConfig(jsig.SigLIPVisionConfig(**VISION),
                                          jsig.SigLIPTextConfig(**TEXT)),
        adapter_override=jpool.MaskAdapterConfig(**ADAPTER), **BRANCH,
    )
    psup = psb.SupportBranchConfig(
        siglip_override=psig.SigLIPConfig(psig.SigLIPVisionConfig(**VISION),
                                          psig.SigLIPTextConfig(**TEXT)),
        adapter_override=ppool.MaskAdapterConfig(**ADAPTER), **BRANCH,
    )
    jc = tiny_core_config(support_override=jsup)
    pc = pcore.CoreConfig(compute_dtype="float32", encoder_override=TINY_ENCODER,
                          support_override=psup)
    return jc, pc


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """cor_tpu's params, and an index written by cor_tpu."""
    jc, pc = core_configs()
    params = jax.tree.map(np.asarray, init_core_model(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((GALLERY, BRANCH["prompt_dim"])).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    d = tmp_path_factory.mktemp("idx")
    j_save_index(d, emb, np.arange(100, 100 + GALLERY))
    return jc, pc, params, d


def assert_same_answers(got, want, tol=1e-4):
    assert [r["id"] for r in got] == [r["id"] for r in want]
    for g, w in zip(got, want):
        gs = np.array([r["score"] for r in g["results"]])
        ws = np.array([r["score"] for r in w["results"]])
        np.testing.assert_allclose(gs, ws, atol=tol, rtol=0)
        # rankings: compare pair ids wherever the reference's neighbours are
        # separated by more than the tolerance (ties may order either way)
        gid = [r["pair_id"] for r in g["results"]]
        wid = [r["pair_id"] for r in w["results"]]
        for i in range(len(wid)):
            gap_before = i == 0 or ws[i - 1] - ws[i] > tol
            gap_after = i == len(wid) - 1 or ws[i] - ws[i + 1] > tol
            if gap_before and gap_after:
                assert gid[i] == wid[i], (i, gid, wid)


SCANS = {"fp32": dict(), "int8": dict(quantize=True), "approx": dict(approx=True),
         "rescore": dict(quantize=True, rescore=True, rescore_width=3)}


@pytest.mark.parametrize("scan", list(SCANS))
def test_server_matches_cor_tpu_server(served, scan):
    """The fp32 and int8 scans, cor_tpu's approximate scan (the exact top k
    in the port) and the int8 scan with the exact rescore (on the device in
    the port, on the host in cor_tpu) answer as cor_tpu's server does."""
    jc, pc, params, idx_dir = served
    reqs = [{"id": f"r{i}", "synthetic": i} for i in range(5)]  # pads to a bucket of 8
    want = JaxRetrievalServer(jc, params, j_load_index(idx_dir), k=6,
                              **SCANS[scan]).handle_batch(reqs)
    model = load_cor_tpu_params(psb.SupportBranch(pc.support), params["support_branch"])
    server = RetrievalServer(pc, model, load_gallery_index(idx_dir), k=6, device="cpu",
                             **SCANS[scan])
    got = server.handle_batch(reqs)
    assert all(len(r["results"]) == 6 for r in got)
    assert_same_answers(got, want)
    # one request alone goes through the bucket of 1 and answers the same
    assert_same_answers([server.handle(reqs[2])], [want[2]])
    assert server.batches_encoded == 2


def test_server_isolates_malformed_requests(served, tmp_path):
    _, pc, params, idx_dir = served
    model = load_cor_tpu_params(psb.SupportBranch(pc.support), params["support_branch"])
    server = RetrievalServer(pc, model, load_gallery_index(idx_dir), k=3, device="cpu")
    mixed = server.handle_batch([
        {"id": "ok0", "synthetic": 0},
        {"id": "bad", "support_img": str(tmp_path / "missing.jpg"),
         "support_mask": str(tmp_path / "missing.png")},
        {"id": "ok2", "synthetic": 2},
    ])
    assert [m["id"] for m in mixed] == ["ok0", "bad", "ok2"]
    assert "error" in mixed[1] and "results" not in mixed[1]
    assert len(mixed[0]["results"]) == 3 and len(mixed[2]["results"]) == 3
    assert server.handle_batch([]) == []


def test_synthetic_dataset_is_bit_identical():
    for kw in (dict(query_img_size=64, support_img_size=32, context_length=8, vocab_size=64,
                    seed=5), dict(seed=0)):
        ours, theirs = SyntheticDataset(length=3, **kw), JaxSyntheticDataset(length=3, **kw)
        for i in (0, 2) if "query_img_size" in kw else (1,):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def test_gallery_index_artifact_loads_across_packages(tmp_path, rng):
    emb = rng.standard_normal((5, 8)).astype(np.float32)
    ids = np.arange(5) * 7
    store = rng.standard_normal((5, 2, 2, 3)).astype(np.float32)
    save_gallery_index(tmp_path / "port", emb, ids, image_embeddings=store)
    j_save_index(tmp_path / "jax", emb, ids, image_embeddings=store)
    a, b = j_load_index(tmp_path / "port"), load_gallery_index(tmp_path / "jax")
    for key in ("embeddings", "pair_ids", "store"):
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == json.loads(
        (tmp_path / "jax" / "meta.json").read_text())
    (tmp_path / "bad").mkdir()
    with pytest.raises(FileNotFoundError, match="meta.json"):
        load_gallery_index(tmp_path / "bad")


def test_engine_scans_match_cor_tpu(rng):
    g = rng.standard_normal((300, 32)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    js, ji = jengine.top_k_retrieve(q, g, 10)
    ps, pi = pengine.top_k_retrieve(torch.from_numpy(q), torch.from_numpy(g), 10)
    np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    gq, gs = pengine.quantize_rows_int8(g)
    jgq, jgs = jengine.quantize_rows_int8(g)
    np.testing.assert_array_equal(gq, jgq)
    np.testing.assert_array_equal(gs, jgs)
    qq, qs = pengine.quantize_queries(torch.from_numpy(q))
    jqq, jqs = jengine._quantize_queries_in_graph(q)
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq).astype(np.float32))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs))
    got = pengine.cosine_scores_int8(qq, qs, torch.from_numpy(gq), torch.from_numpy(gs))
    want = jengine.cosine_scores_int8(jqq, jqs, gq, gs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    engine = pengine.RetrievalEngine(k=10, quantize=True, device="cpu")
    engine.set_gallery(g * 3.0)  # rows are re-normalised on the way in
    s, i = engine.retrieve(torch.from_numpy(q))
    np.testing.assert_allclose(s.numpy(), got.topk(10, dim=1).values.numpy(), atol=1e-6)


def test_cli_refuses_configs_that_name_checkpoints(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("load_checkpoint_path: /ckpt/best.pth\n")
    with pytest.raises(SystemExit):
        pcli.main(["--config", str(cfg), "--gallery-index", str(tmp_path)])
    assert "load_checkpoint_path" in capsys.readouterr().err
    cfg.write_text("bogus_key: 1\n")
    with pytest.raises(ValueError, match="bogus_key"):
        pcli.main(["--config", str(cfg), "--gallery-index", str(tmp_path)])


# the no-jax runs' tiny towers and encoder, as source: head_dim 64 (ViT-B,
# SAM-base), and the largest configuration's head dims (SO400M's 72 with patch
# 14 and MLP ratio 3.7362; sam_huge's 80)
NO_JAX_BASE = """
    towers = siglip.SigLIPConfig(siglip.SigLIPVisionConfig(32, 16, 128, 1, 2),
                                 siglip.SigLIPTextConfig(8, 64, 128, 1, 2))
    adapter = pooling.MaskAdapterConfig(128, 16, 8, 16, 4)
    enc = core_model.SamEncoderConfig(64, 16, embed_dim=32, depth=2, num_heads=2,
                                      out_chans=16, window_size=3, global_attn_indexes=(1,))
"""
NO_JAX_LARGE = """
    towers = siglip.SigLIPConfig(siglip.SigLIPVisionConfig(32, 14, 144, 1, 2, 3.7362),
                                 siglip.SigLIPTextConfig(8, 64, 144, 1, 2, 3.7362))
    adapter = pooling.MaskAdapterConfig(144, 16, 8, 16, 4)
    enc = core_model.SamEncoderConfig(64, 16, embed_dim=160, depth=2, num_heads=2,
                                      out_chans=16, window_size=3, global_attn_indexes=(1,))
"""


def run_without_jax(tmp_path, models: str, train: bool, unfrozen: bool = False,
                    prompts: bool = False) -> dict:
    """Block jax and cor_tpu, import every module of the port, build a
    gallery index with ``cli.index`` at the tiny config ``models`` and serve
    from it end to end: retrieval alone, and with masks decoded
    host-streamed and from the int8 store, then run ``cli.retrieve --rerank``
    and ``tools.recall_matrix`` at a small size; with ``train``, then train one
    tiny epoch with ``cli.train`` (``unfrozen``: ``freeze_towers: false``,
    the encoder's backward through K6b's plain version, and an encode with
    ``fused_window_indexing``, K7's plain version, equal to the unflagged
    one); with ``prompts``, SAM's stock prompts (the full prompt encoder's
    points, box and mask feeding the SAM decoder at full width on a 32 x 32
    grid: K1's route at 5 and 8 tokens, K8a/K8b's at 9), and the opt-in
    decode schedules (a decode under each of sam_decoder's DMA_FUSED,
    STACK_FUSED and GRID_FUSED against K1's route, and decode_bench's run
    on the CPU for each variant). Then K5′ (add_layer_norm, forward and
    backward) and K9 (fused_upscale2_hyper) on the CPU. Returns the first
    response."""
    script = textwrap.dedent(f"""
        import contextlib, dataclasses, importlib, io, json, pkgutil, sys
        from pathlib import Path
        sys.modules["jax"] = None  # any import of jax now raises ImportError
        sys.modules["cor_tpu"] = None  # and so does any import of cor_tpu
        import numpy as np, torch
        import cor_tpu_torch
        for m in pkgutil.walk_packages(cor_tpu_torch.__path__, "cor_tpu_torch."):
            importlib.import_module(m.name)
        from cor_tpu_torch.cli import index as index_cli
        from cor_tpu_torch.config import EvalConfig
        from cor_tpu_torch.models import (
            core_model, pooling, prompt_encoder, sam_decoder, siglip, support_branch)
        from cor_tpu_torch.retrieval.index import load_gallery_index
        from cor_tpu_torch.retrieval.serve import RetrievalServer
        {textwrap.indent(textwrap.dedent(models), " " * 8).strip()}
        sup = support_branch.SupportBranchConfig(
            prompt_dim=16, proj_hidden=24, siglip_override=towers, adapter_override=adapter)
        dec = sam_decoder.MaskDecoderConfig(
            transformer_dim=16, iou_head_hidden_dim=16,
            transformer=sam_decoder.TwoWayTransformerConfig(2, 16, 2, 32))
        cfg = core_model.CoreConfig(
            compute_dtype="float32", encoder_override=enc,
            support_override=sup, decoder_override=dec,
            prompt_override=prompt_encoder.PromptEncoderConfig(16, (4, 4), (64, 64)))
        EvalConfig.core_config = lambda self: cfg
        # fp32 has kernels on the card: the entry points take it for
        # indexing, serving and training, frozen or not
        assert cfg.compute_dtype == "float32" and cfg.freeze_towers
        core_model.check_kernel_dtype(cfg, "cuda")
        core_model.check_kernel_dtype(
            core_model.CoreConfig(compute_dtype="float32", freeze_towers=False), "cuda")
        root = Path({str(tmp_path)!r})
        with contextlib.redirect_stdout(io.StringIO()):
            built = index_cli.main(["--out", str(root / "idx"), "--synthetic", "20",
                                    "--batch-size", "8", "--with-store", "--device", "cpu"])
        assert built["rows"] == 20 and built["dim"] == 16, built
        index = load_gallery_index(root / "idx")
        assert index["store"].shape == (20, 4, 4, 16), index["store"].shape
        reqs = [{{"id": i, "synthetic": i}} for i in range(3)]
        server = RetrievalServer(cfg, core_model.init_support_branch(cfg, 0), index, k=5,
                                 device="cpu")
        server.warmup((1, 2))
        out = server.handle_batch(reqs)
        assert all(len(r["results"]) == 5 and "masks" not in r for r in out), out
        for mode in ("host", "hbm"):
            server = RetrievalServer(
                cfg, core_model.init_support_branch(cfg, 0), index, k=5, device="cpu",
                decode_model=core_model.init_decode_model(cfg, 0),
                decode_dir=root / mode, store_hbm=mode == "hbm")
            dec_out = server.handle_batch(reqs)
            for r in dec_out:
                assert len(r["masks"]) == 5 and all(Path(p).is_file() for p in r["masks"]), r
            assert [r["results"] for r in dec_out] == [r["results"] for r in out]
        # the Recall@K protocol with the IoU rerank, and the scan's accuracy matrix
        from cor_tpu_torch.cli import retrieve as retrieve_cli
        from cor_tpu_torch.retrieval import protocol
        from cor_tpu_torch.tools import recall_matrix
        assert protocol.scan_recall is not None
        with contextlib.redirect_stdout(io.StringIO()):
            rec = retrieve_cli.main(["--synthetic", "6", "--batch-size", "3", "--k", "6",
                                     "--rerank", "--device", "cpu"])
            mat = recall_matrix.run(gallery_rows=600, queries=4, device="cpu")
        assert rec["recall@6"] == 1.0 and rec["gallery_size"] == 6, rec
        assert mat["sigma=0.05/qnoise=0.0"]["int8-approx+rescore"]["agree"] == 1.0, mat
        if {train!r}:
            from cor_tpu_torch.cli import train as train_cli
            from cor_tpu_torch.config import TrainConfig
            TrainConfig.core_config = lambda self: cfg
            (root / "train.yaml").write_text(
                f"epoch: 1\\nbatch_size: 1\\nnum_workers: 2\\ntrain_model_save_path: {{root / 'ck'}}\\n"
                f"freeze_towers: {{str(not {unfrozen!r}).lower()}}\\n")
            TrainConfig.core_config = lambda self: dataclasses.replace(
                cfg, freeze_towers=self.freeze_towers)
            trainer = train_cli.main(["--config", str(root / "train.yaml"), "--synthetic",
                                      "--device", "cpu"])
            assert trainer.state.step == 4 and (root / "ck" / "best_model" / "state.pt").is_file()
            start = core_model.init_image_encoder(cfg, 44).blocks[0].attn.qkv.w
            moved = not torch.equal(trainer.state.model.image_encoder.blocks[0].attn.qkv.w, start)
            assert moved == {unfrozen!r}, moved
        if {prompts!r}:
            pcfg = prompt_encoder.PromptEncoderConfig(256, (32, 32), (512, 512))
            penc = prompt_encoder.init_full_prompt_encoder(pcfg, 0)
            mdec = core_model.init_mask_decoder(core_model.CoreConfig(), 1)
            pe = prompt_encoder.dense_positional_encoding(penc.pe_layer.gaussian_matrix,
                                                          (32, 32))
            pts = (torch.rand(1, 2, 2) * 512, torch.ones(1, 2, dtype=torch.long))
            box = torch.tensor([[10.0, 20.0, 300.0, 400.0]])
            for kw, T in ((dict(masks=torch.randn(1, 128, 128, 1)), 5),
                          (dict(points=pts), 8), (dict(points=pts, boxes=box), 9)):
                sparse, dense = prompt_encoder.full_prompt_encoder(penc, pcfg, **kw)
                assert sparse.shape == (1, T - 5, 256), sparse.shape
                assert sam_decoder.layer_route(1024, T, 256, 8) == (
                    "layer" if T <= 8 else "k8")
                with torch.no_grad():
                    m, iou, _ = sam_decoder.mask_decoder(
                        mdec, torch.randn(1, 32, 32, 256), pe, sparse, dense, True)
                assert m.shape == (1, 3, 128, 128) and torch.isfinite(m).all(), m.shape
            # the opt-in decode schedules: each flag's route in fp32 gives
            # K1's route's masks; decode_bench runs each variant
            from cor_tpu_torch.tools import decode_bench
            img, dense = torch.randn(2, 32, 32, 256), None
            sparse = torch.randn(2, 1, 256)
            with torch.no_grad():
                base = sam_decoder.mask_decoder(mdec, img, pe, sparse, dense, False)[0]
                for flag in ("DMA_FUSED", "STACK_FUSED", "GRID_FUSED"):
                    setattr(sam_decoder, flag, True)
                    m = sam_decoder.mask_decoder(mdec, img, pe, sparse, dense, False)[0]
                    setattr(sam_decoder, flag, False)
                    assert torch.allclose(m, base, atol=1e-4, rtol=1e-4), flag
            for variant in ("layer", "dma", "stack", "grid"):
                res = decode_bench.run(variant, variant == "dma", store=2, chunks=1, iters=1,
                                       chunk=1, device="cpu")
                assert res["device"] == "cpu" and res["ms_per_chunk"] > 0, res
        # the last two kernels' entry points on the CPU: K5' forward and
        # backward, K9 forward
        from cor_tpu_torch.ops.kernels.layernorm import add_layer_norm
        from cor_tpu_torch.ops.kernels.upscale import fused_upscale2_hyper
        ln_in = [torch.randn(2, 5, 96).requires_grad_(True) for _ in range(2)]
        ln_out = add_layer_norm(*ln_in, torch.ones(96), torch.zeros(96))
        ln_grads = torch.autograd.grad(ln_out.square().sum(), ln_in)
        assert all(torch.isfinite(gr).all() for gr in ln_grads)
        up = fused_upscale2_hyper(torch.randn(2, 4, 4, 16), torch.randn(16, 2, 2, 8),
                                  torch.randn(8), torch.randn(2, 3, 8))
        assert up.shape == (2, 3, 8, 8) and torch.isfinite(up).all(), up.shape
        if {unfrozen!r}:
            flagged = dataclasses.replace(cfg, encoder_override=dataclasses.replace(
                enc, fused_window_indexing=True))
            x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(0))
            with torch.no_grad():
                a = core_model.init_image_encoder(flagged, 2)(x)
                b = core_model.init_image_encoder(cfg, 2)(x)
            assert torch.allclose(a, b, atol=1e-5, rtol=1e-5), (a - b).abs().max()
        used = [k for k in sys.modules
                if k in ("jax", "cor_tpu") and sys.modules[k] is not None
                or k.startswith(("jax.", "cor_tpu."))]
        assert not used, used
        print(json.dumps(out[0]))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    resp = json.loads(proc.stdout.strip().splitlines()[-1])
    assert resp["id"] == 0 and len(resp["results"]) == 5
    return resp


def test_port_runs_without_jax(tmp_path):
    """Without jax and cor_tpu: build, serve (with masks both ways) and train
    an epoch at head_dim 64, decode from SAM's stock prompts, decode under
    each opt-in schedule's flag and run decode_bench."""
    run_without_jax(tmp_path, NO_JAX_BASE, train=True, prompts=True)


def test_port_runs_without_jax_at_the_largest_head_dims(tmp_path):
    """Without jax and cor_tpu: build and serve (with masks both ways) at the
    head dims of ViT-SO400M-14-SigLIP-384 (72) and sam_huge (80), train an
    unfrozen epoch there and encode with fused_window_indexing."""
    run_without_jax(tmp_path, NO_JAX_LARGE, train=True, unfrozen=True)


# ---------------------------------------------------------------------------
# candidate-mask decode serving (--decode-masks [--store-hbm]) against
# cor_tpu's, on tiny_core_config: SigLIP at width 32, the SAM decoder at width
# 16 on a 4 x 4 grid (cor_tpu runs K8a/K8b there in place of K1, the same
# function; the port's kernel wrappers take their plain versions on the CPU)
# ---------------------------------------------------------------------------

DEC_GALLERY = 24


def decode_core_configs():
    """tests.helpers.tiny_core_config and the port's CoreConfig with the
    same support branch, prompt encoder and mask decoder."""
    psup = psb.SupportBranchConfig(
        prompt_dim=16, proj_hidden=24,
        siglip_override=psig.SigLIPConfig(
            psig.SigLIPVisionConfig(image_size=32, patch_size=16, width=32, depth=2, num_heads=2),
            psig.SigLIPTextConfig(context_length=8, vocab_size=64, width=32, depth=2,
                                  num_heads=2)),
        adapter_override=ppool.MaskAdapterConfig(**dataclasses.asdict(TINY_ADAPTER)),
    )
    dec = psd.MaskDecoderConfig(
        transformer_dim=16, iou_head_hidden_dim=16,
        transformer=psd.TwoWayTransformerConfig(depth=2, embedding_dim=16, num_heads=2,
                                                mlp_dim=32))
    pc = pcore.CoreConfig(
        compute_dtype="float32", encoder_override=TINY_ENCODER, support_override=psup,
        decoder_override=dec,
        prompt_override=ppe.PromptEncoderConfig(**dataclasses.asdict(TINY_PROMPT)))
    return tiny_core_config(), pc


@pytest.fixture(scope="module")
def decode_served(tmp_path_factory):
    """cor_tpu's params, the port's models loaded from them, and an index
    with a [G, 4, 4, 16] store written by cor_tpu."""
    jc, pc = decode_core_configs()
    params = jax.tree.map(np.asarray, init_core_model(jax.random.PRNGKey(0), jc))
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((DEC_GALLERY, 16)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    store = rng.standard_normal((DEC_GALLERY, 4, 4, 16)).astype(np.float32)
    d = tmp_path_factory.mktemp("dec_idx")
    j_save_index(d, emb, np.arange(100, 100 + DEC_GALLERY), image_embeddings=store)

    def port_models():
        sb = load_cor_tpu_params(psb.SupportBranch(pc.support), params["support_branch"])
        dm = load_cor_tpu_params(
            pcore.DecodeModel(ppe.PromptEncoder(pc.prompt), psd.MaskDecoder(pc.decoder)),
            {"prompt_encoder": params["prompt_encoder"], "mask_decoder": params["mask_decoder"]})
        return sb, dm

    return jc, pc, params, d, port_models


def read_png(path) -> np.ndarray:
    return np.asarray(Image.open(path))


def port_logits(server, reqs, rows: np.ndarray) -> np.ndarray:
    """The port's fp32 mask logits [B, k, 4g, 4g] for gallery rows [B, k]."""
    q, _, _ = server.encode_and_scan(
        *server._batch_tensors([server._assemble(r) for r in reqs]))
    feats = q[: len(reqs)].repeat_interleave(rows.shape[1], dim=0)
    flat = torch.from_numpy(rows.reshape(-1).astype(np.int32))
    if server._decode_hbm is not None:
        out = server._decode_hbm(server.decode_model, server._store_q, server._store_scales,
                                 flat, feats)
    else:
        out = server._decode(server.decode_model,
                             torch.from_numpy(np.asarray(server.store[rows.reshape(-1)])), feats)
    return out[:, 0].reshape(*rows.shape, *out.shape[-2:]).numpy()


@pytest.mark.parametrize("store_hbm", [False, True], ids=["host_streamed", "store_hbm"])
def test_decode_server_matches_cor_tpu_server(decode_served, tmp_path, store_hbm):
    jc, pc, params, idx_dir, port_models = decode_served
    # a path-traversal id and an id-less request name their files as cor_tpu does
    reqs = [{"id": f"r{i}", "synthetic": i} for i in range(3)]
    reqs += [{"id": "../../etc/x", "synthetic": 3}, {"synthetic": 4}]
    want = JaxRetrievalServer(jc, params, j_load_index(idx_dir), k=4,
                              decode_dir=str(tmp_path / "jax"),
                              store_hbm=store_hbm).handle_batch(reqs)
    sb, dm = port_models()
    server = RetrievalServer(pc, sb, load_gallery_index(idx_dir), k=4, device="cpu",
                             decode_model=dm, decode_dir=str(tmp_path / "port"),
                             store_hbm=store_hbm)
    got = server.handle_batch(reqs)
    assert_same_answers(got, want)
    for g, w in zip(got, want):
        assert [r["pair_id"] for r in g["results"]] == [r["pair_id"] for r in w["results"]]
        assert [Path(p).name for p in g["masks"]] == [Path(p).name for p in w["masks"]]
        assert all(Path(p).parent == tmp_path / "port" for p in g["masks"])
    assert Path(got[3]["masks"][0]).name.startswith("etcx_")
    assert Path(got[4]["masks"][0]).name.startswith("req1_")
    rows = np.array([[r["pair_id"] - 100 for r in g["results"]] for g in got])
    logits = port_logits(server, reqs, rows)
    assert 0 < (logits > 0).mean() < 1  # the masks are not all one value
    for b, (g, w) in enumerate(zip(got, want)):
        for j, (pg, pw) in enumerate(zip(g["masks"], w["masks"])):
            mg, mw = read_png(pg), read_png(pw)
            assert mg.shape == mw.shape == (16, 16) and set(np.unique(mg)) <= {0, 255}
            # masks are logit > 0: they may differ only where the logit is ~0
            differ = mg != mw
            assert np.all(np.abs(logits[b, j][differ]) < 1e-3), (b, j, logits[b, j][differ])
            np.testing.assert_array_equal(mg == 255, logits[b, j] > 0)
    assert server.decode_calls == 1


def test_decode_server_refuses_what_cor_tpu_refuses(decode_served, tmp_path):
    jc, pc, params, idx_dir, port_models = decode_served
    sb, dm = port_models()
    no_store = tmp_path / "no_store"
    j_save_index(no_store, np.eye(4, 16, dtype=np.float32), np.arange(4))
    cases = [(no_store, dict(decode_dir=str(tmp_path / "m"))),
             (idx_dir, dict(store_hbm=True))]
    for index_dir, kw in cases:
        with pytest.raises(ValueError) as want:
            JaxRetrievalServer(jc, params, j_load_index(index_dir), k=2, **kw)
        with pytest.raises(ValueError) as got:
            RetrievalServer(pc, sb, load_gallery_index(index_dir), k=2, device="cpu",
                            decode_model=dm, **kw)
        assert str(got.value) == str(want.value)


def test_tokenizer_copy_gives_cor_tpus_ids():
    texts = ["make the cat blue", "", "A photo of THE dog, on a red sofa!", "x " * 40,
             "naïve café — über"]
    for context_length, vocab in ((16, 512), (64, 32000)):
        ours = ptok.get_tokenizer(None, context_length, vocab)
        theirs = jtok.get_tokenizer(None, context_length, vocab)
        got, want = ours(texts), theirs(texts)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(ours(texts[0]), theirs(texts[0]))


def test_png_writer_decodes_to_native_encoders_pixels(rng):
    from cor_tpu.native import png_encode_gray as native_png_encode_gray

    masks = [(rng.random((256, 256)) > 0.5).astype(np.uint8) * 255,
             rng.integers(0, 256, (7, 13), dtype=np.uint8), np.zeros((1, 1), np.uint8)]
    for m in masks:
        ours = Image.open(io.BytesIO(png_encode_gray(m)))
        theirs = Image.open(io.BytesIO(native_png_encode_gray(m, level=1)))
        assert ours.mode == theirs.mode == "L"
        np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))
        np.testing.assert_array_equal(np.asarray(ours), m)
    with pytest.raises(ValueError, match="uint8"):
        png_encode_gray(np.zeros((2, 2), np.float32))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_fp32_is_refused_on_the_card_before_the_card_is_looked_for(tmp_path, capsys,
                                                                  monkeypatch, dtype):
    """The dtype policy of cli.serve and RetrievalServer on the card: fp32
    has kernels there (and serving never runs K6b, so a config with
    freeze_towers: false is served too), so with the card hidden cli.serve
    gets as far as looking for it; fp16 has none and is refused, naming
    ROADMAP Queue 2's @fp16 row, before the card is looked for or a model is
    built. With --device cpu / device="cpu" either runs (the tests' fp32
    configs)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"compute_dtype: {dtype}\n")
    with pytest.raises(SystemExit) as e:
        pcli.main(["--config", str(cfg), "--gallery-index", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    want = "no CUDA card is available" if dtype == "float32" else "ROADMAP Queue 2, @fp16"
    assert want in err and "--device cpu" in err
    core_cfg = dataclasses.replace(EvalConfig().core_config(), compute_dtype=dtype)
    if dtype == "float32":
        pcore.check_kernel_dtype(core_cfg, "cuda")
        pcore.check_kernel_dtype(dataclasses.replace(core_cfg, freeze_towers=False), "cuda")
    else:
        with pytest.raises(ValueError, match="ROADMAP Queue 2, @fp16"):
            RetrievalServer(core_cfg, torch.nn.Linear(1, 1), {}, device="cuda")
    pcore.check_kernel_dtype(core_cfg, "cpu")
    pcore.check_kernel_dtype(EvalConfig().core_config(), "cuda")
    with pytest.raises(ValueError, match="Invalid compute_dtype"):
        pcore.check_kernel_dtype(dataclasses.replace(core_cfg, compute_dtype="int8"), "cpu")


def test_cli_needs_a_card_unless_told_cpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        pcli.main(["--gallery-index", str(tmp_path)])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


def test_cli_serves_decode_masks_on_the_cpu(decode_served, tmp_path, capsys, monkeypatch):
    """cli.serve.main with --device cpu --decode-masks --self-test, the
    model keys of a tiny config; --store-hbm without --decode-masks exits
    with cor_tpu's message."""
    jc, pc, params, idx_dir, port_models = decode_served
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: pc)
    argv = ["--gallery-index", str(idx_dir), "--device", "cpu", "--k", "3", "--max-batch", "2",
            "--self-test", "3"]
    server = pcli.main([*argv, "--decode-masks", str(tmp_path / "m"), "--store-hbm"])
    resps = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["id"] for r in resps] == [0, 1, 2]
    for r in resps:
        assert len(r["results"]) == 3 and len(r["masks"]) == 3
        assert all(read_png(p).shape == (16, 16) for p in r["masks"])
    assert server.decode_calls == server.batches_encoded == 2 + 2  # warmup buckets 1, 2
    with pytest.raises(SystemExit) as e:
        pcli.main([*argv, "--store-hbm"])
    assert e.value.code == 2
    assert "store_hbm=True without decode_dir" in capsys.readouterr().err


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tcp_answers(port: int, reqs) -> list:
    with socket.create_connection(("127.0.0.1", port)) as s:
        f = s.makefile("r")
        out = []
        for r in reqs:
            s.sendall((json.dumps(r) + "\n").encode())
            out.append(json.loads(f.readline()))
    return out


@pytest.mark.parametrize("flags", [["--approx"], ["--int8", "--rescore"], ["--tcp"]],
                         ids=["approx", "rescore", "tcp"])
def test_cli_serves_approx_rescore_and_tcp(served, capsys, monkeypatch, flags):
    """cli.serve --device cpu with --approx (the exact top k: the plain
    scan's answers), --int8 --rescore (the exact fp32 cosines of a widened
    int8 pool: the fp32 scan's answers within 1e-4) and --tcp PORT (a client
    on loopback gets the stdio loop's answers within 1e-4)."""
    _, pc, _, idx_dir = served
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: pc)
    argv = ["--gallery-index", str(idx_dir), "--device", "cpu", "--k", "4", "--max-batch", "2"]
    pcli.main([*argv, "--self-test", "3"])
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    reqs = [{"id": i, "synthetic": i} for i in range(3)]
    if flags == ["--tcp"]:
        ev, port = threading.Event(), free_port()
        threading.Thread(target=pcli.main, args=([*argv, "--tcp", str(port)],),
                         kwargs={"ready_event": ev}, daemon=True).start()
        assert ev.wait(timeout=60) and ev.bound[1] == port
        # one request at a time: buckets of 1, where the loop batched 2
        assert_same_answers(tcp_answers(port, reqs), want)
        return
    server = pcli.main([*argv, "--self-test", "3", *flags])
    got = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert server.engine.approx == ("--approx" in flags)
    assert server.engine.k_scan == (16 if "--rescore" in flags else 4)
    if "--rescore" in flags:
        assert_same_answers(got, want)
    else:
        assert got == want


def test_serve_tcp_multi_client():
    """serve_tcp (tests/test_retrieval.py's test of cor_tpu's, on the port's):
    concurrent clients over real sockets against a stub server, every
    response routed back to the connection that sent its request, a
    malformed line answered with an error in its own slot, batches drawn
    across clients, and a half-closed pipelined client answered in full."""

    class StubServer:
        def __init__(self):
            self.batch_sizes = []
            self.lock = threading.Lock()

        def handle_batch(self, reqs):
            with self.lock:
                self.batch_sizes.append(len(reqs))
            # a slow device: the other clients' requests queue meanwhile, so
            # the next batch must take requests of several clients
            time.sleep(0.05)
            return [{"id": r.get("id"), "echo": r.get("payload")} for r in reqs]

        def handle(self, req):
            return {"id": req.get("id"), "echo": req.get("payload")}

    srv = StubServer()
    ev = threading.Event()
    threading.Thread(target=pcli.serve_tcp, args=(srv, "127.0.0.1", 0, 4, ev),
                     daemon=True).start()
    assert ev.wait(timeout=10)
    host, port = ev.bound
    n_clients, per = 4, 25
    errors = []

    def client(ci):
        try:
            with socket.create_connection((host, port)) as s:
                f = s.makefile("r")
                for r in range(per):
                    payload = f"client{ci}-req{r}"
                    s.sendall((json.dumps({"id": f"{ci}:{r}", "payload": payload}) + "\n")
                              .encode())
                    resp = json.loads(f.readline())
                    assert resp == {"id": f"{ci}:{r}", "echo": payload}, resp
        except Exception as e:  # surfaced in the main thread
            errors.append((ci, repr(e)))

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert sum(srv.batch_sizes) == n_clients * per
    assert max(srv.batch_sizes) > 1, srv.batch_sizes

    with socket.create_connection((host, port)) as s:
        f = s.makefile("r")
        s.sendall(b"this is not json\n")
        assert "error" in json.loads(f.readline())
        s.sendall((json.dumps({"id": "ok", "payload": "p"}) + "\n").encode())
        assert json.loads(f.readline()) == {"id": "ok", "echo": "p"}

    with socket.create_connection((host, port)) as s:
        f = s.makefile("r")
        m = 10
        s.sendall(b"".join((json.dumps({"id": f"hc:{r}", "payload": f"p{r}"}) + "\n").encode()
                           for r in range(m)))
        s.shutdown(socket.SHUT_WR)
        got = []
        for _ in range(m):
            line = f.readline()
            assert line, f"connection closed after {len(got)}/{m} responses"
            got.append(json.loads(line)["id"])
        assert got == [f"hc:{r}" for r in range(m)]
        assert f.readline() == ""  # then the server closes
