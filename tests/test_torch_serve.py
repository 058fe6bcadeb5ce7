"""cor_tpu_torch's retrieval serving against cor_tpu's, on the CPU in fp32.

The same gallery index (written by cor_tpu), the same weights (carried over
by the weight bridge) and the same ``{"synthetic": i}`` requests go through
cor_tpu's RetrievalServer (CPU mesh) and the port's. Rankings must agree
wherever adjacent scores differ by more than 1e-4, and scores within 1e-4.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

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
from cor_tpu_torch.data.synthetic import SyntheticDataset
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import pooling as ppool
from cor_tpu_torch.models import siglip as psig
from cor_tpu_torch.models import support_branch as psb
from cor_tpu_torch.retrieval import engine as pengine
from cor_tpu_torch.retrieval.index import load_gallery_index, save_gallery_index
from cor_tpu_torch.retrieval.serve import RetrievalServer
from cor_tpu_torch.utils.weights import load_cor_tpu_params
from tests.helpers import TINY_ENCODER, tiny_core_config

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


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_server_matches_cor_tpu_server(served, int8):
    jc, pc, params, idx_dir = served
    reqs = [{"id": f"r{i}", "synthetic": i} for i in range(5)]  # pads to a bucket of 8
    want = JaxRetrievalServer(jc, params, j_load_index(idx_dir), k=6,
                              quantize=int8).handle_batch(reqs)
    model = load_cor_tpu_params(psb.SupportBranch(pc.support), params["support_branch"])
    server = RetrievalServer(pc, model, load_gallery_index(idx_dir), k=6, quantize=int8)
    got = server.handle_batch(reqs)
    assert all(len(r["results"]) == 6 for r in got)
    assert_same_answers(got, want)
    # one request alone goes through the bucket of 1 and answers the same
    assert_same_answers([server.handle(reqs[2])], [want[2]])
    assert server.batches_encoded == 2


def test_server_isolates_malformed_requests(served, tmp_path):
    _, pc, params, idx_dir = served
    model = load_cor_tpu_params(psb.SupportBranch(pc.support), params["support_branch"])
    server = RetrievalServer(pc, model, load_gallery_index(idx_dir), k=3)
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
    engine = pengine.RetrievalEngine(k=10, quantize=True)
    engine.set_gallery(g * 3.0)  # rows are re-normalised on the way in
    s, i = engine.retrieve(torch.from_numpy(q))
    np.testing.assert_allclose(s.numpy(), got.topk(10, dim=1).values.numpy(), atol=1e-6)


@pytest.mark.parametrize("flag", [
    ["--decode-masks", "out"], ["--store-hbm"], ["--rescore"], ["--approx"], ["--tcp", "9000"],
])
def test_cli_refuses_later_slice_flags(tmp_path, capsys, flag):
    with pytest.raises(SystemExit) as e:
        pcli.main(["--gallery-index", str(tmp_path), *flag])
    assert e.value.code == 2
    assert "ROADMAP Queue 1" in capsys.readouterr().err


def test_cli_refuses_configs_that_name_checkpoints(tmp_path, capsys):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("load_checkpoint_path: /ckpt/best.pth\n")
    with pytest.raises(SystemExit):
        pcli.main(["--config", str(cfg), "--gallery-index", str(tmp_path)])
    assert "load_checkpoint_path" in capsys.readouterr().err
    cfg.write_text("bogus_key: 1\n")
    with pytest.raises(ValueError, match="bogus_key"):
        pcli.main(["--config", str(cfg), "--gallery-index", str(tmp_path)])


def test_port_runs_without_jax(tmp_path):
    """Block jax, import every module of the port, and serve end to end."""
    script = textwrap.dedent(f"""
        import importlib, json, pkgutil, sys
        sys.modules["jax"] = None  # any import of jax now raises ImportError
        import numpy as np, torch
        import cor_tpu_torch
        for m in pkgutil.walk_packages(cor_tpu_torch.__path__, "cor_tpu_torch."):
            importlib.import_module(m.name)
        from cor_tpu_torch.models import core_model, pooling, siglip, support_branch
        from cor_tpu_torch.retrieval.index import save_gallery_index, load_gallery_index
        from cor_tpu_torch.retrieval.serve import RetrievalServer
        sup = support_branch.SupportBranchConfig(
            prompt_dim=16, proj_hidden=24,
            siglip_override=siglip.SigLIPConfig(
                siglip.SigLIPVisionConfig(32, 16, 128, 1, 2),
                siglip.SigLIPTextConfig(8, 64, 128, 1, 2)),
            adapter_override=pooling.MaskAdapterConfig(128, 16, 8, 16, 4))
        class Enc:  # the SAM encoder is not ported: only its input size is read
            img_size = 64
        cfg = core_model.CoreConfig(compute_dtype="float32", encoder_override=Enc(),
                                    support_override=sup)
        rng = np.random.default_rng(0)
        save_gallery_index({str(tmp_path)!r}, rng.standard_normal((20, 16)).astype(np.float32),
                           np.arange(20))
        server = RetrievalServer(cfg, core_model.init_support_branch(cfg, 0),
                                 load_gallery_index({str(tmp_path)!r}), k=5)
        server.warmup((1, 2))
        out = server.handle_batch([{{"id": i, "synthetic": i}} for i in range(3)])
        assert all(len(r["results"]) == 5 for r in out), out
        # of cor_tpu, only its numpy/stdlib modules were imported
        allowed = {{"cor_tpu", "cor_tpu.data", "cor_tpu.data.tokenizer", "cor_tpu.cli",
                   "cor_tpu.cli.serve"}}
        used = {{k for k in sys.modules if k == "cor_tpu" or k.startswith("cor_tpu.")}}
        assert used <= allowed, used - allowed
        print(json.dumps(out[0]))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    resp = json.loads(proc.stdout.strip().splitlines()[-1])
    assert resp["id"] == 0 and len(resp["results"]) == 5
