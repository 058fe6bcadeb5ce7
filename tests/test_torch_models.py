"""cor_tpu_torch's ops and models against cor_tpu's, on the CPU in fp32.

The same inputs, made with numpy from a seed, and the same weights (a
cor_tpu parameter tree carried over by cor_tpu_torch.utils.weights) go
through both packages at a tiny SigLIP (width 128, depth 2, 2 heads, image
64, patch 16, context 16, vocabulary 512) with reduced adapter widths.
Tolerances: 1e-6 for single ops, 1e-4 for the deeper compositions.
cor_tpu's Pallas kernels run in interpret mode, as in its own tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cor_tpu.config as jcfg
import cor_tpu.models.core_model as jcore
import cor_tpu.models.pooling as jpool
import cor_tpu.models.siglip as jsig
import cor_tpu.models.support_branch as jsb
from cor_tpu.models.fusion import cir_fuse_compose as j_cir_fuse_compose
from cor_tpu.ops import common as jcommon
from cor_tpu.ops.resize import resize_bilinear as j_resize
from cor_tpu_torch import config as pcfg
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import pooling as ppool
from cor_tpu_torch.models import siglip as psig
from cor_tpu_torch.models import support_branch as psb
from cor_tpu_torch.ops import common as pcommon
from cor_tpu_torch.ops.resize import resize_bilinear as p_resize
from cor_tpu_torch.utils.weights import flatten_tree, load_cor_tpu_params

VISION = dict(image_size=64, patch_size=16, width=128, depth=2, num_heads=2)
TEXT = dict(context_length=16, vocab_size=512, width=128, depth=2, num_heads=2)
ADAPTER = dict(x_in_channel=128, adapter_in_channel=32, mask_downscaling_mid_channel=8,
               adapter_mid_channel=32, num_output_maps=4)
BRANCH = dict(prompt_dim=64, proj_hidden=96)


def support_configs(**kw):
    """The tiny support-branch config in both packages."""
    j = jsb.SupportBranchConfig(
        siglip_override=jsig.SigLIPConfig(jsig.SigLIPVisionConfig(**VISION),
                                          jsig.SigLIPTextConfig(**TEXT)),
        adapter_override=jpool.MaskAdapterConfig(**ADAPTER), **BRANCH, **kw,
    )
    p = psb.SupportBranchConfig(
        siglip_override=psig.SigLIPConfig(psig.SigLIPVisionConfig(**VISION),
                                          psig.SigLIPTextConfig(**TEXT)),
        adapter_override=ppool.MaskAdapterConfig(**ADAPTER), **BRANCH, **kw,
    )
    return j, p


@pytest.fixture(scope="module")
def branch_params():
    jc, _ = support_configs()
    return jax.tree.map(np.asarray, jsb.init_support_branch(jax.random.PRNGKey(0), jc))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    return {
        "img": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
        "text": rng.integers(0, 512, (2, 16)).astype(np.int32),
        "mask": (rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32),
    }


def port_branch(params, **kw):
    _, pc = support_configs(**kw)
    return load_cor_tpu_params(psb.SupportBranch(pc), params).eval()


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# single ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fn", ["gelu", "gelu_poly"])
def test_gelu_matches(fn):
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    want = getattr(jcommon, fn)(jnp.asarray(x))
    close(getattr(pcommon, fn)(torch.from_numpy(x)), want, 1e-6)


@pytest.mark.parametrize("src,dst", [((24, 24), (96, 96)), ((384, 384), (24, 24))],
                         ids=["up-24-96", "down-384-24"])
def test_resize_bilinear_matches(rng, src, dst):
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    close(p_resize(torch.from_numpy(x), dst), j_resize(jnp.asarray(x), dst), 1e-6)


def test_layer_norm_and_dense_and_conv_match(rng):
    x = rng.standard_normal((2, 9, 9, 16)).astype(np.float32)
    jp_ln = {"scale": rng.standard_normal(16).astype(np.float32),
             "bias": rng.standard_normal(16).astype(np.float32)}
    close(pcommon.layer_norm(torch.from_numpy(x), torch.from_numpy(jp_ln["scale"]),
                             torch.from_numpy(jp_ln["bias"])),
          jcommon.layer_norm(jp_ln, jnp.asarray(x)), 1e-5)
    jp_dense = jax.tree.map(np.asarray, jcommon.init_dense(jax.random.PRNGKey(1), 16, 8))
    dense = load_cor_tpu_params(pcommon.Dense(16, 8), jp_dense)
    close(dense(torch.from_numpy(x)).detach(), jcommon.dense(jp_dense, jnp.asarray(x)), 1e-5)
    for groups, (cin, cout) in ((1, (16, 8)), (16, (16, 16))):
        jp_conv = jax.tree.map(np.asarray, jcommon.init_conv2d(
            jax.random.PRNGKey(2), cin, cout, 3, groups=groups))
        conv = load_cor_tpu_params(pcommon.Conv2d(cin, cout, 3, groups=groups), jp_conv)
        close(conv(torch.from_numpy(x), stride=2, padding=1).detach(),
              jcommon.conv2d(jp_conv, jnp.asarray(x), stride=2, padding=1, groups=groups), 1e-5)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


@torch.no_grad()
def test_siglip_towers_match(branch_params, inputs):
    jc, pc = support_configs()
    model = port_branch(branch_params)
    jp = branch_params["siglip"]
    j_pooled, j_grid = jsig.siglip_vision(jp["visual"], jnp.asarray(inputs["img"]), jc.siglip.vision)
    p_pooled, p_grid = model.siglip.visual(torch.from_numpy(inputs["img"]))
    close(p_pooled, j_pooled, 1e-4)
    close(p_grid, j_grid, 1e-4)
    j_text = jsig.siglip_text(jp["text"], jnp.asarray(inputs["text"]), jc.siglip.text)
    close(model.siglip.text(torch.from_numpy(inputs["text"])), j_text, 1e-4)


@torch.no_grad()
def test_pooling_and_fusion_match(branch_params, rng):
    jc, _ = support_configs()
    model = port_branch(branch_params)
    feats = rng.standard_normal((2, 4, 4, 128)).astype(np.float32)
    mask = (rng.random((2, 64, 64, 1)) > 0.5).astype(np.float32)
    j_map = jpool.mask_adapter_pooling(branch_params["mask_pooling"], jnp.asarray(feats),
                                       jnp.asarray(mask), jc.adapter)
    close(model.mask_pooling(torch.from_numpy(feats), torch.from_numpy(mask)), j_map, 1e-4)
    close(ppool.masked_pooling(torch.from_numpy(feats), torch.from_numpy(mask)),
          jpool.masked_pooling(jnp.asarray(feats), jnp.asarray(mask)), 1e-4)
    img = rng.standard_normal((3, 128)).astype(np.float32)
    txt = rng.standard_normal((3, 128)).astype(np.float32)
    want = j_cir_fuse_compose(branch_params["cir_fuse"], jnp.asarray(img), jnp.asarray(txt))
    got = model.cir_fuse(torch.from_numpy(img), torch.from_numpy(txt))
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], 1e-4)


@pytest.mark.parametrize("fusion,pooling", [
    ("combiner", "MaskAdapterPooling"), ("add", "MaskAdapterPooling"),
    ("image_only", "MaskAdapterPooling"), ("no_mask", "MaskAdapterPooling"),
    ("global_image", "MaskAdapterPooling"), ("text_only", "MaskAdapterPooling"),
    ("combiner", "MaskedPooling"),
])
@torch.no_grad()
def test_support_branch_matches(branch_params, inputs, fusion, pooling):
    jc, _ = support_configs(fusion=fusion, mask_pooling=pooling)
    params = dict(branch_params)
    if pooling == "MaskedPooling":
        params.pop("mask_pooling")
    want = jsb.support_branch(params, jnp.asarray(inputs["img"]), jnp.asarray(inputs["text"]),
                              jnp.asarray(inputs["mask"]), jc)
    model = port_branch(params, fusion=fusion, mask_pooling=pooling)
    got = model(torch.from_numpy(inputs["img"]), torch.from_numpy(inputs["text"]),
                torch.from_numpy(inputs["mask"]))
    assert got.shape == (2, 1, 64)
    close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# configs, weight bridge, seeded init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pair", [
    (jcore.CoreConfig, pcore.CoreConfig),
    (jsb.SupportBranchConfig, psb.SupportBranchConfig),
    (jpool.MaskAdapterConfig, ppool.MaskAdapterConfig),
    (jsig.SigLIPConfig, psig.SigLIPConfig),
    (jsig.SigLIPVisionConfig, psig.SigLIPVisionConfig),
    (jsig.SigLIPTextConfig, psig.SigLIPTextConfig),
    (jcfg.EvalConfig, pcfg.EvalConfig),
], ids=lambda p: p[0].__name__)
def test_config_dataclasses_mirror_cor_tpu(pair):
    j, p = pair
    jf = [(f.name, f.default) for f in dataclasses.fields(j)]
    pf = [(f.name, f.default) for f in dataclasses.fields(p)]
    # nested config defaults are instances of each package's own class
    norm = lambda fs: [(n, dataclasses.asdict(d) if dataclasses.is_dataclass(d) else d)
                       for n, d in fs]
    assert norm(pf) == norm(jf)


def test_siglip_model_table_mirrors_cor_tpu():
    assert {k: dataclasses.asdict(v) for k, v in psig.SIGLIP_MODELS.items()} == {
        k: dataclasses.asdict(v) for k, v in jsig.SIGLIP_MODELS.items()
    }


def test_weight_bridge_sets_every_parameter_and_uses_every_leaf(branch_params):
    model = port_branch(branch_params)
    leaves = flatten_tree(branch_params)
    assert set(leaves) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        w = leaves[name]
        if p.dim() == 2 and name.endswith(".w"):
            np.testing.assert_array_equal(p.detach().numpy(), w.T)  # [in, out] -> [out, in]
        elif p.dim() == 4:
            np.testing.assert_array_equal(p.detach().numpy(), w.transpose(3, 2, 0, 1))  # HWIO -> OIHW
        else:
            np.testing.assert_array_equal(p.detach().numpy(), w)
    extra = dict(branch_params, bogus={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="bogus.w"):
        port_branch(extra)
    missing = {k: v for k, v in branch_params.items() if k != "ln_channel_last"}
    with pytest.raises(ValueError, match="ln_channel_last.scale"):
        port_branch(missing)


def test_seeded_init_has_cor_tpu_shapes_and_bounds(branch_params):
    _, pc = support_configs()
    core = pcore.CoreConfig(support_override=pc, compute_dtype="float32")
    a = pcore.init_support_branch(core, seed=3)
    b = pcore.init_support_branch(core, seed=3)
    leaves = flatten_tree(branch_params)
    for (name, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), name  # a seed gives the same weights
        owner = a.get_submodule(name.rpartition(".")[0])
        want_shape = leaves[name].shape
        if isinstance(owner, pcommon.Dense) and name.endswith(".w"):
            want_shape = want_shape[::-1]
            assert p.abs().max() <= 1 / np.sqrt(owner.in_dim)
        elif isinstance(owner, pcommon.Conv2d) and name.endswith(".w"):
            want_shape = tuple(want_shape[i] for i in (3, 2, 0, 1))
        assert tuple(p.shape) == tuple(want_shape), name
        if isinstance(owner, pcommon.LayerNorm):
            assert torch.all(p == (1.0 if name.endswith("scale") else 0.0)), name
    assert torch.all(a.siglip.visual.pos_embed.abs() <= 0.04)  # trunc normal, 2 std
    assert not torch.equal(a.siglip.visual.pos_embed, pcore.init_support_branch(
        core, seed=4).siglip.visual.pos_embed)


def test_cast_covers_every_float_parameter(branch_params):
    model = pcore._cast(port_branch(branch_params), torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
