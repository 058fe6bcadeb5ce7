"""cor_tpu_torch at the head dims of the largest configuration the repository
supports: ViT-SO400M-14-SigLIP-384 towers (16 heads of 72, patch 14, MLP
ratio 3.7362) and sam_huge (16 heads of 80), against cor_tpu on the CPU.

Shapes are cut, head dims are not: towers of width 144 (2 heads of 72,
patch 14, a 76-pixel image cropped to 70, a 5 x 5 grid, depth 2), encoders of
width 160 (2 heads of 80, depth 2, one global block). cor_tpu runs its
Pallas kernels in interpret mode (K4′ through ``attention_seq_pallas``, K6
through its lane-pad shim), the port the plain versions of its kernels.
Weights are cor_tpu's, carried over by the weight bridge, or the port's
seeded ones carried the other way; inputs are made with numpy from a seed.
Tolerances: fp32 1e-5 for the kernels' functions, cor_tpu's own model-level
tolerances above them (1e-4 towers, 2e-4 / 3e-4 the 2-D attention and the
encoder, 5e-4 composed decodes), bf16 2e-2 absolute (about one bf16 ulp at
|y| <= 4).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cor_tpu.models.core_model as jcore
import cor_tpu.models.pooling as jpool
import cor_tpu.models.sam_encoder as jsam
import cor_tpu.models.siglip as jsig
import cor_tpu.models.support_branch as jsb
import cor_tpu.ops.attention as jatt
from cor_tpu.data.pipeline import DataLoader as JaxDataLoader
from cor_tpu.data.pipeline import SyntheticDataset as JaxSyntheticDataset
from cor_tpu.ops.pallas.seq_attention import attention_seq_pallas, attention_seq_qkv_pallas
from cor_tpu.retrieval.index import build_gallery as j_build_gallery
from cor_tpu.retrieval.index import load_gallery_index as j_load_index
from cor_tpu.retrieval.index import make_candidate_mask_decoder as j_mask_decoder
from cor_tpu.retrieval.index import make_query_encoder as j_query_encoder
from cor_tpu.retrieval.serve import RetrievalServer as JaxRetrievalServer
from cor_tpu_torch.cli import index as pcli_index
from cor_tpu_torch.cli import serve as pcli_serve
from cor_tpu_torch.config import EvalConfig, load_eval_config, read_flat_yaml
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import pooling as ppool
from cor_tpu_torch.models import prompt_encoder as ppe
from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.models import sam_encoder as psam
from cor_tpu_torch.models import siglip as psig
from cor_tpu_torch.models import support_branch as psb
from cor_tpu_torch.ops import attention as patt
from cor_tpu_torch.ops.kernels.seq_attention import (
    attention_seq,
    attention_seq_plain,
    attention_seq_qkv,
    attention_seq_qkv_plain,
)
from cor_tpu_torch.ops.kernels.vit_attention import (
    vit_attention_relpos,
    vit_attention_relpos_windows,
)
from cor_tpu_torch.ops.resize import resize_bilinear
from cor_tpu_torch.utils.weights import (
    flatten_tree,
    load_cor_tpu_params,
    to_cor_tpu_layout,
    to_cor_tpu_tree,
)
from tests.helpers import TINY_DECODER, TINY_PROMPT
from tests.test_torch_encoder import fill
from tests.test_torch_serve import assert_same_answers, port_logits, read_png

TOL = dict(atol=1e-5, rtol=1e-5)
# SO400M's tower shape with the width cut: 2 heads of 72, patch 14, 76 -> 5 x 5
SO_VISION = dict(image_size=76, patch_size=14, width=144, depth=2, num_heads=2,
                 mlp_ratio=3.7362)
SO_TEXT = dict(context_length=16, vocab_size=64, width=144, depth=2, num_heads=2,
               mlp_ratio=3.7362)
ADAPTER = dict(x_in_channel=144, adapter_in_channel=32, mask_downscaling_mid_channel=8,
               adapter_mid_channel=32, num_output_maps=4)
BRANCH = dict(prompt_dim=16, proj_hidden=24)
# sam_huge's block shape with the width cut: 2 heads of 80
HUGE_ENC = dict(img_size=160, patch_size=16, embed_dim=160, depth=2, num_heads=2, out_chans=32,
                window_size=4, global_attn_indexes=(1,))
# the served slice: the encoder on a 4 x 4 grid (windows of 2), the tiny decoder
SLICE_ENC = dict(HUGE_ENC, img_size=64, out_chans=16, window_size=2)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


def support_configs():
    """The SO400M-shaped support branch in both packages."""
    j = jsb.SupportBranchConfig(
        siglip_override=jsig.SigLIPConfig(jsig.SigLIPVisionConfig(**SO_VISION),
                                          jsig.SigLIPTextConfig(**SO_TEXT)),
        adapter_override=jpool.MaskAdapterConfig(**ADAPTER), **BRANCH)
    p = psb.SupportBranchConfig(
        siglip_override=psig.SigLIPConfig(psig.SigLIPVisionConfig(**SO_VISION),
                                          psig.SigLIPTextConfig(**SO_TEXT)),
        adapter_override=ppool.MaskAdapterConfig(**ADAPTER), **BRANCH)
    return j, p


def slice_configs():
    """The served slice in both packages: the SO400M-shaped support branch,
    a sam_huge-shaped encoder, cor_tpu's tiny prompt encoder and decoder."""
    js, ps = support_configs()
    jc = jcore.CoreConfig(compute_dtype="float32", encoder_override=jsam.SamEncoderConfig(
        **SLICE_ENC), decoder_override=TINY_DECODER, prompt_override=TINY_PROMPT,
        support_override=js)
    pc = pcore.CoreConfig(
        compute_dtype="float32", encoder_override=psam.SamEncoderConfig(**SLICE_ENC),
        decoder_override=psd.MaskDecoderConfig(**{
            **dataclasses.asdict(TINY_DECODER),
            "transformer": psd.TwoWayTransformerConfig(
                **dataclasses.asdict(TINY_DECODER.transformer))}),
        prompt_override=ppe.PromptEncoderConfig(**dataclasses.asdict(TINY_PROMPT)),
        support_override=ps)
    return jc, pc


def test_the_largest_config_reads_as_cor_tpu_reads_it(tmp_path):
    """CFG, a flat copy of configs/vaild_config.yaml with sam_huge and
    ViT-SO400M-14-SigLIP-384, as the CLIs read it: the towers' and the
    encoder's shapes are cor_tpu's, and ``describe`` (the CLIs' log line)
    names the head dims the kernels take."""
    repo = Path(__file__).resolve().parents[1]
    keys = read_flat_yaml((repo / "configs" / "vaild_config.yaml").read_text())
    keys.update(sam_model_name="sam_huge", siglip_model_name="ViT-SO400M-14-SigLIP-384")
    path = tmp_path / "large.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in keys.items()))
    got = load_eval_config(path).core_config()
    want = jcore.CoreConfig(sam_model="sam_huge", siglip_model="ViT-SO400M-14-SigLIP-384")
    assert dataclasses.asdict(got.support.siglip) == dataclasses.asdict(want.support.siglip)
    for key in ("img_size", "patch_size", "embed_dim", "depth", "num_heads", "window_size",
                "global_attn_indexes", "out_chans"):
        assert getattr(got.encoder, key) == getattr(want.encoder, key), key
    vis = got.support.siglip.vision
    assert (vis.grid, int(round(vis.width * vis.mlp_ratio))) == (27, 4304)
    assert got.encoder.global_attn_indexes == (7, 15, 23, 31)
    text = pcore.describe(got)
    assert "16 heads of 72, grid 27" in text and "16 heads of 80" in text, text


# ---------------------------------------------------------------------------
# K4′: attention over [B, H, N, D] and off the fused QKV, head_dim 72 and 80
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,N", [(72, 25), (72, 64), (80, 25), (80, 64)],
                         ids=["d72-n25", "d72-n64", "d80-n25", "d80-n64"])
def test_attention_seq_matches_pallas(rng, D, N, dtype):
    """Both entries against cor_tpu's K4′ (``attention_seq_pallas``) and its
    fused-QKV entry, which reaches K4′ through transposes at these head
    dims."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = TOL if dtype == "float32" else dict(atol=2e-2, rtol=0)
    q, k, v = (rng.standard_normal((2, 2, N, D)).astype(np.float32) for _ in range(3))
    want = np.asarray(attention_seq_pallas(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)), 2)
                      .astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    before = attention_seq.launches
    for fn in (attention_seq, attention_seq_plain):
        got = fn(tq, tk, tv, 2)
        assert got.dtype == tdt and got.shape == (2, 2, N, D)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert attention_seq.launches == before  # the CPU takes the plain version

    qkv = rng.standard_normal((2, N, 3 * 2 * D)).astype(np.float32)
    want = np.asarray(attention_seq_qkv_pallas(jnp.asarray(qkv).astype(jdt), num_heads=2)
                      .astype(jnp.float32))
    before = attention_seq_qkv.launches
    for fn in (attention_seq_qkv, attention_seq_qkv_plain):
        got = fn(torch.from_numpy(qkv).to(tdt), 2)
        np.testing.assert_allclose(got.float().numpy(), want, **tol)
    assert attention_seq_qkv.launches == before


def test_attention_seq_refuses_devices_without_a_kernel():
    q = torch.empty(1, 2, 8, 72, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        attention_seq(q, q, q, 2)


# ---------------------------------------------------------------------------
# K6 at head_dim 80: the 2-D rel-pos attention of sam_huge's blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["global", "windowed"])
def test_attention_2d_fused_at_head_dim_80_matches_cor_tpu(rng, case):
    """The port's ``attention_2d_fused`` (K6's plain version) against
    cor_tpu's, which pads each head 80 -> 128 lanes for its K6 and passes
    the scale 80^-1/2: a global 8 x 8 grid, and a 10 x 10 grid partitioned
    into windows of 4 (pad tokens as keys), rel-pos tables filled."""
    size = (8, 8) if case == "global" else (4, 4)
    jp = jatt.init_attention_2d(jax.random.PRNGKey(3), 160, 2, use_rel_pos=True, input_size=size)
    jp = jax.tree.map(np.asarray, jp)
    for key in ("rel_pos_h", "rel_pos_w"):
        jp[key] = (0.3 * rng.standard_normal(jp[key].shape)).astype(np.float32)
    pp = load_cor_tpu_params(patt.Attention2d(160, 2, size), jp)
    x = (0.5 * rng.standard_normal((2, 8, 8, 160) if case == "global" else (2, 10, 10, 160))
         ).astype(np.float32)
    xj, xp = jnp.asarray(x), t(x)
    if case == "windowed":
        xj, _ = jatt.window_partition(xj, 4)
        xp, _ = patt.window_partition(xp, 4)
    want = np.asarray(jatt.attention_2d_fused(jax.tree.map(jnp.asarray, jp), xj, 2))
    before = vit_attention_relpos.launches
    with torch.no_grad():
        got = patt.attention_2d_fused(pp, xp, 2).numpy()
    assert vit_attention_relpos.launches == before
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=2e-4)


def test_unfrozen_sam_huge_step_fails_at_its_forward():
    """An unfrozen sam_huge step no longer fails at its forward: K6b takes
    head_dim 80 (ROADMAP Queue 2, K6b@80, ported), so a forward at 80 that
    records a gradient goes on to the device check, with grad as without
    (and so does K7's); only an unported head_dim is refused, naming its
    ROADMAP row."""
    attn = patt.Attention2d(160, 2, (4, 4)).to("meta")
    x = torch.empty(2, 4, 4, 160, device="meta")
    for window in (0, 4):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            patt.attention_2d_fused(attn, x, 2, window=window)
        with torch.no_grad(), pytest.raises(ValueError, match="no kernel for device meta"):
            patt.attention_2d_fused(attn, x, 2, window=window)
    qkv = torch.empty(1, 16, 3 * 192, device="meta", requires_grad=True)
    rel = torch.empty(1, 2, 16, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        vit_attention_relpos(qkv, rel, rel, 2, (4, 4))


@pytest.fixture(scope="module")
def huge_encoder_grads():
    """The sam_huge-shaped encoder (the port's seeded init, tables and
    pos_embed filled) and jax.grad of cor_tpu's, remat on (its default),
    without and with fused_window_indexing: {flag: (params, x, grads)}."""
    params = fill(to_cor_tpu_tree(psam.SamEncoder(psam.SamEncoderConfig(**HUGE_ENC))),
                  np.random.default_rng(11))
    x = np.random.default_rng(12).standard_normal((1, 160, 160, 3)).astype(np.float32)
    out = {}
    for flag in (False, True):
        jcfg = jsam.SamEncoderConfig(**HUGE_ENC, fused_window_indexing=flag)
        jg = jax.jit(jax.grad(lambda p: jnp.mean(jsam.sam_encoder(p, jnp.asarray(x), jcfg) ** 2)))(
            jax.tree.map(jnp.asarray, params))
        out[flag] = flatten_tree(jax.tree.map(np.asarray, jg))
    return params, x, out


@pytest.mark.parametrize("flag", [False, True], ids=["partitioned", "fused_window_indexing"])
def test_unfrozen_sam_huge_shaped_encoder_grad_matches_cor_tpu(huge_encoder_grads, flag):
    """The unfrozen encoder at sam_huge's head_dim 80 (2 blocks of 2 heads of
    80, block 1 global on the 10 x 10 grid, block 0 in windows of 4 padded
    to 12 x 12), remat on as a training step runs it: every parameter's
    gradient of mean(y^2) against jax.grad of cor_tpu's at its tolerance on
    the unfrozen encoder's gradients (2e-5 + 2e-4 relative). The port's K6b
    plain version stands where cor_tpu runs its K6b through the lane-pad
    shim; with fused_window_indexing the port's K7 (its plain VJP) where
    cor_tpu falls back to the partition and its oracle VJP."""
    params, x, want = huge_encoder_grads
    port = load_cor_tpu_params(
        psam.SamEncoder(psam.SamEncoderConfig(**HUGE_ENC, fused_window_indexing=flag)), params)
    before = vit_attention_relpos_windows.launches
    (port(t(x)) ** 2).mean().backward()
    assert vit_attention_relpos_windows.launches == before
    assert want[flag].keys() == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        g = to_cor_tpu_layout(port, name, p.grad.numpy())
        np.testing.assert_allclose(g, want[flag][name], atol=2e-5, rtol=2e-4, err_msg=name)


# ---------------------------------------------------------------------------
# the towers, pooling on the 27 x 27 grid, the encoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def branch_params():
    """The port's seeded support branch as a cor_tpu tree (cor_tpu's own
    init draws the same shapes and distributions, eagerly and ~100x
    slower)."""
    _, pc = support_configs()
    return to_cor_tpu_tree(pcore.init_support_branch(pcore.CoreConfig(support_override=pc), 0))


@torch.no_grad()
def test_so400m_shaped_towers_and_query_match_cor_tpu(branch_params):
    """siglip_encode (pooled, text, grid) and the query through
    MaskAdapterPooling on the 5 x 5 grid, at 1e-4."""
    jc, pc = support_configs()
    model = load_cor_tpu_params(psb.SupportBranch(pc), branch_params).eval()
    assert model.siglip.visual.blocks[0].mlp.lin1.w.shape == (538, 144)  # round(144 x 3.7362)
    rng = np.random.default_rng(5)
    img = rng.standard_normal((2, 76, 76, 3)).astype(np.float32)
    text = rng.integers(0, 64, (2, 16)).astype(np.int32)
    mask = (rng.random((2, 76, 76, 1)) > 0.5).astype(np.float32)
    @jax.jit
    def towers_and_query(params, img, text, mask):
        return (jsig.siglip_encode(params["siglip"], img, text, jc.siglip),
                jsb.support_branch(params, img, text, mask, jc))

    want_towers, want_query = towers_and_query(branch_params, img, text, mask)
    got = model.siglip(t(img), torch.from_numpy(text))
    assert got[2].shape == (2, 5, 5, 144)
    for g, w in zip(got, want_towers):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
    got = model(t(img), torch.from_numpy(text), t(mask))
    assert got.shape == (2, 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_query), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("src,dst", [(384, 27), (27, 108)], ids=["down-384-27", "up-27-108"])
def test_resize_bilinear_at_so400m_factors(rng, src, dst):
    """The non-integer factors of SO400M's pooling against jax.image.resize
    (linear, no antialiasing) in fp32, at 1e-6 (one resize's rounding)."""
    x = rng.standard_normal((2, src, src, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="linear", antialias=False)
    np.testing.assert_allclose(resize_bilinear(t(x), (dst, dst)).numpy(), np.asarray(want),
                               atol=1e-6, rtol=1e-6)


@torch.no_grad()
def test_mask_adapter_pooling_on_the_27_grid(branch_params):
    """MaskAdapterPooling on SO400M's 27 x 27 grid with a 384-pixel mask
    (down 384 -> 27, up 27 -> 108 inside), at 1e-4."""
    jc, pc = support_configs()
    rng = np.random.default_rng(6)
    feats = rng.standard_normal((2, 27, 27, 144)).astype(np.float32)
    yy, xx = np.mgrid[0:384, 0:384] / 384
    mask = np.stack([((yy - cy) ** 2 + (xx - cx) ** 2 < r * r) for cy, cx, r in
                     ((0.4, 0.5, 0.2), (0.7, 0.3, 0.07))]).astype(np.float32)[..., None]
    want = jax.jit(lambda p, f, m: jpool.mask_adapter_pooling(p, f, m, jc.adapter))(
        branch_params["mask_pooling"], feats, mask)
    pool = load_cor_tpu_params(ppool.MaskAdapterPooling(pc.adapter), branch_params["mask_pooling"])
    np.testing.assert_allclose(pool(t(feats), t(mask)).numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "plain"])
def test_sam_huge_shaped_encoder_matches_cor_tpu(fused):
    """Two blocks of 2 heads of 80 (block 1 global on the 10 x 10 grid,
    block 0 in windows of 4 padded to 12 x 12), tables and pos_embed filled,
    at cor_tpu's encoder tolerance 3e-4."""
    flags = dict(fused_attention=fused, fused_layernorm=fused)
    jcfg = jsam.SamEncoderConfig(**HUGE_ENC, **flags)
    port = psam.SamEncoder(psam.SamEncoderConfig(**HUGE_ENC, **flags))
    params = fill(to_cor_tpu_tree(pcore.reset_all(port, torch.Generator().manual_seed(1))),
                  np.random.default_rng(8))
    x = np.random.default_rng(9).standard_normal((2, 160, 160, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jsam.sam_encoder(p, x, jcfg))(params, x)
    load_cor_tpu_params(port, params)
    with torch.no_grad():
        got = port(t(x))
    assert got.shape == (2, 10, 10, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=3e-4)


def test_weight_bridge_carries_the_full_size_trees():
    """cor_tpu trees with the full-size leaves of both models (depth cut):
    sam_huge's rel-pos tables [2*64-1, 80] and [2*14-1, 80], pos_embed
    [1, 64, 64, 1280 cut to 160]; SO400M's pos_embed [1, 729, width], patch
    embed [14*14*3, width], MLP 3.7362 x width. They load into the port and
    come back unchanged."""
    enc = jsam.sam_encoder_config("sam_huge", embed_dim=160, depth=2, global_attn_indexes=(1,),
                                  num_heads=2)
    tree = jax.tree.map(np.asarray, jax.jit(jsam.init_sam_encoder, static_argnums=1)(
        jax.random.PRNGKey(2), enc))
    tree = fill(tree, np.random.default_rng(10))
    assert tree["blocks"][1]["attn"]["rel_pos_h"].shape == (127, 80)
    assert tree["blocks"][0]["attn"]["rel_pos_w"].shape == (27, 80)
    so = jsig.SIGLIP_MODELS["ViT-SO400M-14-SigLIP-384"]
    vis = dataclasses.replace(so.vision, width=144, depth=1, num_heads=2)
    vtree = jax.tree.map(np.asarray, jax.jit(jsig.init_siglip_vision, static_argnums=1)(
        jax.random.PRNGKey(3), vis))
    assert vtree["pos_embed"].shape == (1, 729, 144)
    pvis = psig.SigLIPVisionConfig(**dataclasses.asdict(vis))
    for module, want in ((psam.SamEncoder(psam.SamEncoderConfig(**dataclasses.asdict(enc))), tree),
                         (psig.SigLIPVision(pvis), vtree)):
        back = to_cor_tpu_tree(load_cor_tpu_params(module, want))
        flat_back = jax.tree_util.tree_leaves_with_path(back)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_back) == len(flat_want)
        for path, leaf in flat_back:
            np.testing.assert_array_equal(leaf, flat_want[path])


# ---------------------------------------------------------------------------
# the slice as a whole: cli.index and cli.serve on the CPU against cor_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """The port's CLIs on the CPU at the slice config with the port's seeded
    weights: an index of 6 synthetic candidates with its store, then 3
    self-test requests served with masks, host-streamed and from the int8
    store; and cor_tpu's tree of the same weights."""
    jc, pc = slice_configs()
    root = tmp_path_factory.mktemp("large_slice")
    seed = EvalConfig().seed
    orig = EvalConfig.core_config
    EvalConfig.core_config = lambda self: pc
    try:
        built = pcli_index.main(["--out", str(root / "idx"), "--synthetic", "6", "--batch-size",
                                 "4", "--with-store", "--device", "cpu"])
        served = {}
        for mode, extra in (("host", []), ("hbm", ["--store-hbm"])):
            served[mode] = pcli_serve.main([
                "--gallery-index", str(root / "idx"), "--device", "cpu", "--k", "3",
                "--max-batch", "2", "--self-test", "3", "--decode-masks", str(root / mode),
                *extra])
    finally:
        EvalConfig.core_config = orig
    params = {"image_encoder": to_cor_tpu_tree(pcore.init_image_encoder(pc, seed + 2)),
              "support_branch": to_cor_tpu_tree(pcore.init_support_branch(pc, seed)),
              **to_cor_tpu_tree(pcore.init_decode_model(pc, seed))}
    return jc, pc, root, built, served, params


def test_cli_index_at_the_slice_config_matches_cor_tpu(slice_run):
    """The index the port's CLI built holds cor_tpu's build of the same
    weights: embeddings at 1e-4, the store at 3e-4 (cor_tpu's tolerances)."""
    jc, _, root, built, _, params = slice_run
    assert built == {"rows": 6, "dim": 16, "with_store": True, "out": str(root / "idx")}
    ds = JaxSyntheticDataset(length=6, query_img_size=64, support_img_size=76, context_length=16,
                             vocab_size=64, seed=EvalConfig().seed)
    want_e, want_i, want_s = j_build_gallery(jc, {"image_encoder": params["image_encoder"]},
                                             JaxDataLoader(ds, 4, num_workers=2), with_store=True,
                                             store_dtype=np.float32)
    idx = j_load_index(root / "idx")
    np.testing.assert_array_equal(idx["pair_ids"], want_i)
    np.testing.assert_allclose(idx["embeddings"], want_e, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(np.asarray(idx["store"], np.float32), want_s, atol=3e-4,
                               rtol=3e-4 + 1e-3)  # the store is fp16: 2^-11 relative


@pytest.mark.parametrize("mode", ["host", "hbm"], ids=["host_streamed", "int8_store"])
def test_cli_serve_at_the_slice_config_matches_cor_tpu(slice_run, tmp_path, mode):
    """The served top-k against cor_tpu's server on the same weights and
    index (scores within 1e-4, rankings across gaps above it); the
    candidates' mask logits against cor_tpu's decode of the same store rows
    at 5e-4 (host-streamed), and the PNGs against cor_tpu's wherever the
    logit is not within 1e-3 of 0 (both)."""
    jc, pc, root, _, served, params = slice_run
    server = served[mode]
    reqs = [{"id": i, "synthetic": i} for i in range(3)]
    got = server.handle_batch(reqs, save_masks=False)
    want = JaxRetrievalServer(jc, params, j_load_index(root / "idx"), k=3,
                              decode_dir=str(tmp_path / "jax"),
                              store_hbm=mode == "hbm").handle_batch(reqs)
    assert_same_answers(got, want)
    rows = np.array([[r["pair_id"] for r in g["results"]] for g in got])  # pair ids are rows
    logits = port_logits(server, reqs, rows)
    if mode == "host":
        store = np.asarray(j_load_index(root / "idx")["store"])
        imgs, masks, texts = (jnp.asarray(np.stack(a)) for a in zip(
            *[server._synthetic_query(i) for i in range(3)]))
        q = j_query_encoder(jc)(params, imgs, texts, masks)
        want_logits = j_mask_decoder(jc)(params, jnp.asarray(store[rows.reshape(-1)]),
                                         jnp.repeat(q, 3, axis=0))
        np.testing.assert_allclose(logits.reshape(-1, *logits.shape[-2:]),
                                   np.asarray(want_logits)[:, 0], atol=5e-4, rtol=5e-4)
    # the PNGs the CLI wrote for its self-test, named as cor_tpu names them
    for i, w in enumerate(want):
        assert sorted(p.name for p in (root / mode).glob(f"{i}_*.png")) == sorted(
            Path(p).name for p in w["masks"])
        for j, pid in enumerate(rows[i]):
            mg = read_png(root / mode / f"{i}_{pid}.png")
            mw = read_png(tmp_path / "jax" / f"{i}_{pid}.png")
            assert mg.shape == (16, 16) and set(np.unique(mg)) <= {0, 255}
            assert np.all(np.abs(logits[i, j][mg != mw]) < 1e-3)


# ---------------------------------------------------------------------------
# unfrozen fp32 training at the largest configuration's shapes, with grad_accum
# ---------------------------------------------------------------------------


def test_unfrozen_fp32_grad_accum_step_at_the_slice_config_matches_cor_tpu():
    """One unfrozen fp32 train step with grad_accum 2 at the slice config (the
    SO400M-shaped towers, the sam_huge-shaped encoder: 2 blocks of 2 heads of
    80, block 1 global; no dropout, "add" fusion) on a batch of 4 whose last
    row is padding, against cor_tpu's accumulation on the same weights and
    rows: the loss terms, grad_norm and every parameter after the AdamW
    update, at test_torch_train.py's tolerances for the unfrozen step. The
    port runs K6b's plain fp32 backward where cor_tpu runs its K6b through
    the lane-pad shim in interpret mode."""
    import optax

    from cor_tpu.train import optim as joptim
    from cor_tpu.train.step import _write_lr
    from cor_tpu_torch.train import optim as poptim
    from cor_tpu_torch.train.step import TrainState, make_train_step
    from tests.test_torch_train import LR, assert_update_matches, global_norm, j_loss_fn

    jc, pc = slice_configs()
    jc = dataclasses.replace(jc, freeze_towers=False, support_override=dataclasses.replace(
        jc.support_override, proj_dropout=0.0, fusion="add"))
    pc = dataclasses.replace(pc, freeze_towers=False, support_override=dataclasses.replace(
        pc.support_override, proj_dropout=0.0, fusion="add"))
    tree = to_cor_tpu_tree(pcore.init_core_model(pc, 8))
    tree["image_encoder"] = fill(tree["image_encoder"], np.random.default_rng(18))
    rng = np.random.default_rng(9)
    qm = np.zeros((4, 64, 64, 1), np.float32)
    for i in range(4):  # a non-empty foreground and background in every row
        r0, c0 = rng.integers(0, 32, 2)
        qm[i, r0:r0 + 21, c0:c0 + 32] = 1.0
    batch = {
        "query_img": rng.standard_normal((4, 64, 64, 3), dtype=np.float32),
        "support_img": rng.standard_normal((4, 76, 76, 3), dtype=np.float32),
        "text": rng.integers(2, 64, (4, 16)).astype(np.int32),
        "support_mask": (rng.random((4, 76, 76, 1)) > 0.5).astype(np.float32),
        "query_mask": qm,
        "valid": np.array([1, 1, 1, 0], np.float32),
    }

    jparams = jax.tree.map(jnp.asarray, tree)
    grad = jax.jit(jax.value_and_grad(j_loss_fn(jc), has_aux=True))
    g_acc, aux_acc = None, {}
    for a in range(2):
        mb = {k: jnp.asarray(v[2 * a:2 * a + 2]) for k, v in batch.items()}
        (_, aux), g = grad(jparams, mb)
        w = float(batch["valid"][2 * a:2 * a + 2].sum())
        g = jax.tree.map(lambda x: w * np.asarray(x), g)
        g_acc = g if g_acc is None else jax.tree.map(np.add, g_acc, g)
        aux_acc = {k: aux_acc.get(k, 0.0) + w * float(v) for k, v in aux.items()}
    g_acc = jax.tree.map(lambda x: x / 3.0, g_acc)
    tx, _ = joptim.make_optimizer(jparams, "AdamW", lr=LR, freeze_towers=False)

    @jax.jit  # one graph: eager optax compiles each of its ops per leaf
    def update(params, grads):
        updates, _ = tx.update(grads, _write_lr(tx.init(params), jnp.float32(LR)), params)
        return optax.apply_updates(params, updates)

    j_after = jax.tree.map(np.asarray, update(jparams, jax.tree.map(jnp.asarray, g_acc)))

    model = load_cor_tpu_params(pcore.init_core_model(pc, 0), tree)
    opt, _ = poptim.make_optimizer(model, "AdamW", lr=LR, freeze_towers=False)
    pm = make_train_step(pc, seed=0, grad_accum=2)(
        TrainState(model, opt), {k: torch.from_numpy(v) for k, v in batch.items()}, LR)
    for k in ("seg_loss", "fg_loss", "bg_loss", "total_loss"):
        np.testing.assert_allclose(float(pm[k]), aux_acc[k] / 3.0, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(pm["grad_norm"]), global_norm(g_acc), rtol=1e-4)
    assert_update_matches(to_cor_tpu_tree(model), j_after, tree, g_acc)
    moved = flatten_tree(to_cor_tpu_tree(model))
    before = flatten_tree(tree)
    for leaf in ("image_encoder.blocks.1.attn.rel_pos_h",
                 "support_branch.siglip.visual.blocks.0.attn.qkv.w"):
        assert not np.array_equal(moved[leaf], before[leaf]), leaf
