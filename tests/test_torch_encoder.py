"""cor_tpu_torch's SAM image encoder, gallery build and core_forward against
cor_tpu's, on the CPU in fp32.

Most checks run at the kernel-eligible size of cor_tpu's own K6 tests
(tests/test_vit_attention_kernel.py): 160 x 160 images, embed 128, 2 heads of
64, window 4, so the 10 x 10 grid pads to 12 x 12 and the pad tokens are
keys; block 1 is global. There cor_tpu runs its Pallas kernels (interpret
mode) and the port the plain versions of K6 and K5. The rel-pos tables and
``pos_embed`` are filled from a seed: at their zero init the bias would go
untested. Weights are cor_tpu's, carried over by the weight bridge; inputs
are made with numpy.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cor_tpu.ops.attention as jatt
from cor_tpu.data.pipeline import DataLoader as JaxDataLoader
from cor_tpu.data.pipeline import SyntheticDataset as JaxSyntheticDataset
from cor_tpu.models import sam_encoder as jsam
from cor_tpu.models.core_model import core_forward as j_core_forward
from cor_tpu.models.core_model import init_core_model
from cor_tpu.retrieval.index import build_gallery as j_build_gallery
from cor_tpu.retrieval.index import load_gallery_index as j_load_index
from cor_tpu.retrieval.index import save_gallery_index as j_save_index
from cor_tpu.train.losses import mask_pool_normalized as j_mask_pool
from cor_tpu_torch.cli import index as pcli
from cor_tpu_torch.config import EvalConfig
from cor_tpu_torch.data.pipeline import DataLoader
from cor_tpu_torch.data.synthetic import SyntheticDataset
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import sam_encoder as psam
from cor_tpu_torch.ops import attention as patt
from cor_tpu_torch.retrieval.index import build_gallery, load_gallery_index, save_gallery_index
from cor_tpu_torch.train.losses import mask_pool_normalized
from cor_tpu_torch.utils.weights import load_cor_tpu_params
from tests.helpers import tiny_core_config
from tests.test_torch_serve import decode_core_configs

ENC = dict(img_size=160, patch_size=16, embed_dim=128, depth=2, num_heads=2, out_chans=32,
           window_size=4, global_attn_indexes=(1,))
KTOL = dict(atol=2e-4, rtol=2e-4)  # cor_tpu's K6 test tolerance against its oracle
ETOL = dict(atol=3e-4, rtol=3e-4)  # cor_tpu's encoder-level tolerance


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def fill(tree, rng):
    """Seeded normals (x0.3) in every rel-pos table and pos_embed of an
    encoder tree, in place."""
    if "pos_embed" in tree:
        tree["pos_embed"] = (0.3 * rng.standard_normal(tree["pos_embed"].shape)).astype(np.float32)
    for blk in tree["blocks"]:
        for k in ("rel_pos_h", "rel_pos_w"):
            blk["attn"][k] = (0.3 * rng.standard_normal(blk["attn"][k].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def encoders():
    """cor_tpu's encoder config and filled params, and the port's encoder
    loaded from them."""
    jcfg = jsam.SamEncoderConfig(**ENC)
    params = jax.tree.map(np.asarray, jsam.init_sam_encoder(jax.random.PRNGKey(0), jcfg))
    params = fill(params, np.random.default_rng(7))
    port = load_cor_tpu_params(psam.SamEncoder(psam.SamEncoderConfig(**ENC)), params)
    return jcfg, params, port


@pytest.mark.parametrize("h,w,window", [(8, 8, 4), (10, 10, 4), (10, 7, 4)],
                         ids=["exact", "padded", "padded-rect"])
def test_window_partition_matches_cor_tpu(rng, h, w, window):
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    want, want_hw = jatt.window_partition(jnp.asarray(x), window)
    got, got_hw = patt.window_partition(t(x), window)
    assert got_hw == tuple(want_hw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = patt.window_unpartition(got, window, got_hw, (h, w))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jatt.window_unpartition(want, window, want_hw, (h, w))))


@pytest.mark.parametrize("q,k,length", [(4, 4, 7), (4, 4, 5), (4, 4, 11), (3, 6, 11), (6, 3, 9)],
                         ids=["exact", "interp-up", "interp-down", "q<k", "q>k-interp"])
def test_get_rel_pos_matches_cor_tpu(rng, q, k, length):
    table = rng.standard_normal((length, 8)).astype(np.float32)
    want = np.asarray(jatt.get_rel_pos(q, k, jnp.asarray(table)))
    np.testing.assert_allclose(patt.get_rel_pos(q, k, t(table)).numpy(), want, atol=1e-6, rtol=0)
    qv = rng.standard_normal((2, q * q, 8)).astype(np.float32)
    th = rng.standard_normal((2 * max(q, k) - 1, 8)).astype(np.float32)
    want_h, want_w = jatt.decomposed_rel_pos_bias(
        jnp.asarray(qv), jnp.asarray(th), jnp.asarray(table), (q, q), (k, k))
    got_h, got_w = patt.decomposed_rel_pos_bias(t(qv), t(th), t(table), (q, q), (k, k))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("block", [1, 0], ids=["global", "windowed"])
def test_attention_2d_matches_cor_tpu(encoders, rng, block):
    """The fused path (K6's plain version against cor_tpu's Pallas kernel)
    and the plain attention_2d against cor_tpu's, on block 1 (global, the
    10 x 10 grid) and block 0 (windows of 4 after a padding partition)."""
    jcfg, params, port = encoders
    jp = jax.tree.map(jnp.asarray, params["blocks"][block]["attn"])
    pp = port.blocks[block].attn
    x = (0.5 * rng.standard_normal((2, 10, 10, 128))).astype(np.float32)
    xj, xp = jnp.asarray(x), t(x)
    if block == 0:
        xj, _ = jatt.window_partition(xj, 4)
        xp, _ = patt.window_partition(xp, 4)
    with torch.no_grad():
        got_fused = patt.attention_2d_fused(pp, xp, 2).numpy()
        got_plain = patt.attention_2d(pp, xp, 2).numpy()
    np.testing.assert_allclose(got_fused, np.asarray(jatt.attention_2d_fused(jp, xj, 2)), **KTOL)
    np.testing.assert_allclose(got_plain, np.asarray(jatt.attention_2d(jp, xj, 2)), **KTOL)


@pytest.mark.parametrize("hw", [(10, 10), (8, 8), (10, 7)], ids=["padded", "exact", "rect"])
def test_window_rel_pos_factors_match_the_partitioned_ones(encoders, rng, hw):
    """K7's factors over the padded grid, read window by window, are
    rel_pos_factors of the partitioned q (what the unflagged route feeds
    K6), at 1e-6."""
    _, _, port = encoders
    pp = port.blocks[0].attn  # window 4
    H, W = hw
    Hp, Wp = -(-H // 4) * 4, -(-W // 4) * 4
    q = t(rng.standard_normal((2, Hp, Wp, 128)))
    rel_h, rel_w = patt.window_rel_pos_factors(pp, q, 4, 2)
    assert rel_h.shape == rel_w.shape == (2, 2, Hp * Wp, 4)
    qw, _ = patt.window_partition(q, 4)
    want_h, want_w = patt.rel_pos_factors(pp, qw.reshape(-1, 16, 128), (4, 4), 2)
    for got, want in ((rel_h, want_h), (rel_w, want_w)):
        got = got.reshape(2, 2, Hp // 4, 4, Wp // 4, 4, 4).permute(0, 2, 4, 1, 3, 5, 6)
        np.testing.assert_allclose(got.reshape(want.shape).detach().numpy(),
                                   want.detach().numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_flagged_encoder_equals_the_unflagged_one(encoders, rng, fused):
    """fused_window_indexing changes where the partition happens, not the
    function: the flagged port encoder equals the unflagged one at 1e-5 (on
    the CPU its K7 is the plain version and counts no launch); with
    fused_attention=False the flag is ignored, as in cor_tpu."""
    from cor_tpu_torch.ops.kernels.vit_attention import vit_attention_relpos_windows

    _, params, port = encoders
    flags = dict(fused_attention=fused, fused_layernorm=fused)
    flagged = load_cor_tpu_params(psam.SamEncoder(dataclasses.replace(
        port.cfg, fused_window_indexing=True, **flags)), params)
    plain = load_cor_tpu_params(psam.SamEncoder(dataclasses.replace(port.cfg, **flags)), params)
    x = t(rng.standard_normal((1, 160, 160, 3)))
    before = vit_attention_relpos_windows.launches
    with torch.no_grad():
        np.testing.assert_allclose(flagged(x).numpy(), plain(x).numpy(), atol=1e-5, rtol=1e-5)
    assert vit_attention_relpos_windows.launches == before


def test_attention_2d_without_rel_pos_matches_cor_tpu(rng):
    """use_rel_pos=False: no tables, zero bias factors into K6's path."""
    jp = jatt.init_attention_2d(jax.random.PRNGKey(4), 128, 2, use_rel_pos=False)
    pp = load_cor_tpu_params(patt.Attention2d(128, 2), jax.tree.map(np.asarray, jp))
    x = (0.5 * rng.standard_normal((2, 5, 6, 128))).astype(np.float32)
    with torch.no_grad():
        got = patt.attention_2d_fused(pp, t(x), 2).numpy()
    np.testing.assert_allclose(got, np.asarray(jatt.attention_2d_fused(jp, jnp.asarray(x), 2)),
                               **KTOL)


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_encoder_matches_cor_tpu(encoders, rng, fused):
    jcfg, params, port = encoders
    x = rng.standard_normal((2, 160, 160, 3)).astype(np.float32)
    flags = dict(fused_attention=fused, fused_layernorm=fused)
    want = jsam.sam_encoder(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                            dataclasses.replace(jcfg, **flags))
    port = load_cor_tpu_params(psam.SamEncoder(dataclasses.replace(port.cfg, **flags)), params)
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (2, 10, 10, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ETOL)


@pytest.mark.parametrize("size,grid", [(1024, 64), (160, 10)], ids=["1024-to-64", "160-to-10"])
def test_mask_pool_normalized_matches_cor_tpu(rng, size, grid):
    emb = rng.standard_normal((2, grid, grid, 16)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size] / size
    mask = np.stack([((yy - cy) ** 2 + (xx - cx) ** 2 < r * r) for cy, cx, r in
                     ((0.4, 0.5, 0.2), (0.7, 0.3, 0.05))]).astype(np.float32)[..., None]
    want = np.asarray(j_mask_pool(jnp.asarray(emb), jnp.asarray(mask)))
    np.testing.assert_allclose(mask_pool_normalized(t(emb), t(mask)).numpy(), want,
                               atol=1e-5, rtol=1e-5)


def test_build_gallery_matches_cor_tpu(encoders, tmp_path):
    """Embeddings at 1e-4 and image embeddings at 3e-4 over a 5-candidate
    synthetic gallery in batches of 2; each package's artifact loads in the
    other."""
    jcfg, params, port = encoders
    jc = tiny_core_config(encoder_override=jcfg)
    pc = pcore.CoreConfig(compute_dtype="float32", encoder_override=port.cfg)
    kw = dict(length=5, query_img_size=160, support_img_size=32, context_length=8,
              vocab_size=64, seed=3)
    want_e, want_i, want_s = j_build_gallery(
        jc, {"image_encoder": params}, JaxDataLoader(JaxSyntheticDataset(**kw), 2, num_workers=2),
        with_store=True, store_dtype=np.float32)
    got_e, got_i, got_s = build_gallery(pc, port, DataLoader(SyntheticDataset(**kw), 2, 2),
                                        with_store=True, store_dtype=np.float32)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_e, want_e, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s, want_s, **ETOL)
    save_gallery_index(tmp_path / "port", got_e, got_i, image_embeddings=got_s)
    j_save_index(tmp_path / "jax", want_e, want_i, image_embeddings=want_s)
    for ours, theirs, e, s in ((j_load_index(tmp_path / "port"), got_e, got_e, got_s),
                               (load_gallery_index(tmp_path / "jax"), want_e, want_e, want_s)):
        np.testing.assert_array_equal(ours["embeddings"], e)
        np.testing.assert_array_equal(np.asarray(ours["store"]), s.astype(np.float16))


@pytest.fixture(scope="module")
def core_tree():
    """cor_tpu's init_core_model tree of tests.helpers.tiny_core_config, its
    encoder's rel-pos tables and pos_embed filled."""
    jc, _ = decode_core_configs()
    tree = jax.tree.map(np.asarray, init_core_model(jax.random.PRNGKey(2), jc))
    tree["image_encoder"] = fill(tree["image_encoder"], np.random.default_rng(3))
    return tree


def test_core_model_loads_the_whole_cor_tpu_tree(core_tree):
    """Every leaf of init_core_model's tree has its port parameter and every
    parameter its leaf (the bridge raises otherwise), in the port's layout."""
    _, pc = decode_core_configs()
    got = load_cor_tpu_params(pcore.init_core_model(pc, 0), core_tree).state_dict()
    enc = core_tree["image_encoder"]
    np.testing.assert_array_equal(got["image_encoder.patch_embed.w"].numpy(),
                                  enc["patch_embed"]["w"].T)
    np.testing.assert_array_equal(got["image_encoder.neck.conv2.w"].numpy(),
                                  enc["neck"]["conv2"]["w"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(got["image_encoder.blocks.1.attn.rel_pos_w"].numpy(),
                                  enc["blocks"][1]["attn"]["rel_pos_w"])
    np.testing.assert_array_equal(got["image_encoder.pos_embed"].numpy(), enc["pos_embed"])
    np.testing.assert_array_equal(got["mask_decoder.iou_token"].numpy(),
                                  core_tree["mask_decoder"]["iou_token"])


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
def test_core_forward_matches_cor_tpu(core_tree, rng, multimask):
    """tests.helpers.tiny_core_config in both packages. Tolerance 5e-4, the
    composed decoder's (tests/test_torch_decoder.py): the forward chains the
    encoder, the SigLIP towers, pooling and fusion and the two-way decoder,
    and the fp32 sums of each run in another order."""
    jc, pc = decode_core_configs()
    jc = dataclasses.replace(jc, multimask_output=multimask)
    pc = dataclasses.replace(pc, multimask_output=multimask)
    model = load_cor_tpu_params(pcore.init_core_model(pc, 0), core_tree).eval()
    inputs = (rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
              rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
              rng.integers(2, 64, (2, 8)).astype(np.int32),
              (rng.random((2, 32, 32, 1)) > 0.5).astype(np.float32))
    want = j_core_forward(jax.tree.map(jnp.asarray, core_tree), *map(jnp.asarray, inputs), jc)
    got = pcore.core_forward(model, t(inputs[0]), t(inputs[1]), torch.from_numpy(inputs[2]),
                             t(inputs[3]), pc)
    assert [tuple(g.shape) for g in got] == [(2, 1, 16, 16), (2, 4, 4, 16), (2, 1, 16)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize(
    "case", ["fused_window_indexing", "seq_shard", "pp_stages", "plain_on_a_device"])
def test_encoder_refuses_what_it_does_not_run(encoders, rng, case):
    """The parallel keys are refused naming their ROADMAP item, and the plain
    formulations off the CPU; fused_window_indexing is no longer refused
    (K7 is ported): the flagged encoder matches cor_tpu's
    ``sam_encoder(..., fused_window_indexing=True)`` (its K7 in interpret
    mode) at cor_tpu's encoder tolerance."""
    cfg = psam.SamEncoderConfig(**ENC)
    if case == "fused_window_indexing":
        jcfg, params, _ = encoders
        x = rng.standard_normal((2, 160, 160, 3)).astype(np.float32)
        want = jsam.sam_encoder(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                dataclasses.replace(jcfg, fused_window_indexing=True))
        port = load_cor_tpu_params(
            psam.SamEncoder(dataclasses.replace(cfg, fused_window_indexing=True)), params)
        with torch.no_grad():
            got = port(t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ETOL)
        return
    if case == "plain_on_a_device":
        enc = psam.SamEncoder(dataclasses.replace(cfg, fused_attention=False))
        with pytest.raises(ValueError, match="test oracles"):
            enc(torch.empty(1, 160, 160, 3, device="meta"))
        return
    value = 2 if case == "pp_stages" else True
    with pytest.raises(ValueError, match="ROADMAP"):
        psam.SamEncoder(dataclasses.replace(cfg, **{case: value}))


def test_data_loader_batches_as_cor_tpu(tmp_path):
    kw = dict(length=5, query_img_size=32, support_img_size=16, context_length=4,
              vocab_size=16, seed=1)
    ours = list(DataLoader(SyntheticDataset(**kw), 2, num_workers=3))
    theirs = list(JaxDataLoader(JaxSyntheticDataset(**kw), 2, num_workers=3))
    assert [b["pair_id"].tolist() for b in ours] == [[0, 1], [2, 3], [4]]
    assert len(ours) == len(theirs) == len(DataLoader(SyntheticDataset(**kw), 2))
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    # a consumer that stops early leaves no producer behind
    it = iter(DataLoader(SyntheticDataset(**{**kw, "length": 64}), 1, num_workers=2, prefetch=1))
    next(it)
    it.close()


@pytest.fixture
def tiny_index_config(monkeypatch):
    """The CLI's model keys -> a small CoreConfig (kernel-eligible encoder)."""
    _, pc = decode_core_configs()
    pc = dataclasses.replace(pc, encoder_override=psam.SamEncoderConfig(**ENC))
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: pc)
    return pc


def test_cli_index_builds_on_the_cpu(tiny_index_config, tmp_path, capsys):
    out = tmp_path / "idx"
    ret = pcli.main(["--out", str(out), "--synthetic", "5", "--batch-size", "2",
                     "--with-store", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == ret == {"rows": 5, "dim": 32, "with_store": True, "out": str(out)}
    # the artifact is cor_tpu's, and holds the port's own build with the
    # weights the CLI documents (the image encoder from seed + 2)
    idx = j_load_index(out)
    model = pcore.init_image_encoder(tiny_index_config, EvalConfig().seed + 2).eval()
    ds = SyntheticDataset(length=5, query_img_size=160, support_img_size=32, context_length=8,
                          vocab_size=64, seed=EvalConfig().seed)
    emb, ids, store = build_gallery(tiny_index_config, model, DataLoader(ds, 2), with_store=True)
    np.testing.assert_array_equal(idx["pair_ids"], ids)
    np.testing.assert_allclose(idx["embeddings"], emb, atol=1e-6, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(idx["embeddings"], axis=1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(idx["store"]), store)


@pytest.mark.parametrize("case", ["manifest", "checkpoint", "no_card", "fp32_on_the_card",
                                  "fp16_on_the_card"])
def test_cli_index_refuses(tiny_index_config, tmp_path, capsys, monkeypatch, case):
    argv = ["--out", str(tmp_path / "idx"), "--synthetic", "2"]
    want = "--device cpu"
    if case == "manifest":
        # without --synthetic the config's manifest is read: none is set
        argv, want = argv[:2], "Manifest '' not found"
    elif case == "checkpoint":
        # a checkpoint the config names must exist
        cfg = tmp_path / "cfg.yaml"
        cfg.write_text("load_sam_pretrained_checkpoint: /ckpt/sam.pth\n")
        argv, want = [*argv, "--config", str(cfg)], "load_sam_pretrained_checkpoint=/ckpt/sam.pth"
    else:
        # without a card: bf16 and the fp32 model (tiny_index_config's) both
        # have kernels on the card, so the CLI gets as far as looking for it
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        want = "no CUDA card is available"
        if case == "no_card":
            monkeypatch.setattr(EvalConfig, "core_config", lambda self: dataclasses.replace(
                tiny_index_config, compute_dtype="bfloat16"))
        elif case == "fp16_on_the_card":
            # fp16 has no kernels: refused, naming its ROADMAP row, first
            want = "ROADMAP Queue 2, @fp16"
            monkeypatch.setattr(EvalConfig, "core_config", lambda self: dataclasses.replace(
                tiny_index_config, compute_dtype="float16"))
        else:
            assert tiny_index_config.compute_dtype == "float32"
            pcore.check_kernel_dtype(tiny_index_config, "cuda")
    with pytest.raises(SystemExit) as e:
        pcli.main(argv)
    assert e.value.code == 2
    assert want in capsys.readouterr().err
