"""cor_tpu_torch's candidate-mask decode path against cor_tpu's, on the CPU.

The same inputs, made with numpy from a seed, and the same weights (a
cor_tpu parameter tree carried over by the weight bridge) go through both
packages in fp32. cor_tpu's Pallas kernels run in interpret mode, as in its
own tests; on the CPU the port's kernel wrappers run their plain versions.
Tolerances are cor_tpu's own kernel tests': 2e-4 for a kernel against its
XLA oracle (test_two_way_layer_kernel.py, test_decoder_tail_kernel.py),
5e-4 for the composed decoder, 1e-6 for single ops, and relative 0.05 for
the bf16 tail against the fp32 one.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cor_tpu.ops.pallas.two_way_layer as jtwl
from cor_tpu.models import prompt_encoder as jpe
from cor_tpu.models import sam_decoder as jsd
from cor_tpu.models.core_model import init_core_model
from cor_tpu.ops.common import gelu as jgelu
from cor_tpu.ops.common import layer_norm as jlayer_norm
from cor_tpu.ops.pallas.decoder_tail import fused_decoder_tail
from cor_tpu.ops.pallas.t2i_flash import t2i_flash_kv as j_t2i_flash_kv
from cor_tpu.retrieval import engine as jengine
from cor_tpu.retrieval import index as jindex
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import prompt_encoder as ppe
from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.ops.attention import AttentionQKV
from cor_tpu_torch.ops.common import conv_transpose_2x
from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail, decoder_tail_plain
from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv, t2i_flash_kv_plain
from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain
from cor_tpu_torch.retrieval import engine as pengine
from cor_tpu_torch.retrieval import index as pindex
from cor_tpu_torch.utils.weights import load_cor_tpu_params
from tests.helpers import TINY_DECODER, TINY_ENCODER, TINY_PROMPT, tiny_core_config

KTOL = dict(atol=2e-4, rtol=2e-4)  # kernel vs its oracle
DTOL = dict(atol=5e-4, rtol=5e-4)  # composed decoder


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def sam_layer():
    """A full-width SAM two-way transformer (C 256, 8 heads, MLP 2048) in
    both packages."""
    cfg = jsd.TwoWayTransformerConfig()
    p = np_tree(jsd.init_two_way_transformer(jax.random.PRNGKey(0), cfg))
    port = load_cor_tpu_params(psd.TwoWayTransformer(psd.TwoWayTransformerConfig()), p)
    return p, port


def decode_configs(grid_img: int = 64):
    """cor_tpu's tiny CORE config and the port's with the same decoder."""
    jc = tiny_core_config()
    dec = psd.MaskDecoderConfig(
        transformer_dim=16, iou_head_hidden_dim=16,
        transformer=psd.TwoWayTransformerConfig(depth=2, embedding_dim=16, num_heads=2,
                                                mlp_dim=32))
    pc = pcore.CoreConfig(compute_dtype="float32", encoder_override=TINY_ENCODER,
                          decoder_override=dec,
                          prompt_override=ppe.PromptEncoderConfig(**dataclasses.asdict(TINY_PROMPT)))
    return jc, pc


@pytest.fixture(scope="module")
def tiny_decode():
    jc, pc = decode_configs()
    params = np_tree(init_core_model(jax.random.PRNGKey(0), jc))
    model = load_cor_tpu_params(
        pcore.DecodeModel(ppe.PromptEncoder(pc.prompt), psd.MaskDecoder(pc.decoder)),
        {"prompt_encoder": params["prompt_encoder"], "mask_decoder": params["mask_decoder"]},
    )
    return jc, pc, params, model


def test_prompt_encoder_matches(tiny_decode, rng):
    jc, pc, params, model = tiny_decode
    want = np.asarray(jpe.get_dense_pe(params["prompt_encoder"], jc.prompt))
    got = ppe.get_dense_pe(model.prompt_encoder).numpy()
    assert got.shape == want.shape == (1, 4, 4, 16)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the flagship 64 x 64 grid, (x, y) order and +0.5 centres included
    g = rng.standard_normal((2, 128)).astype(np.float32)
    want = np.asarray(jpe.dense_positional_encoding({"gaussian_matrix": g}, (64, 64)))
    got = ppe.dense_positional_encoding(t(g), (64, 64)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    dense = ppe.prompt_encoder_dense(model.prompt_encoder, 3).numpy()
    np.testing.assert_array_equal(
        dense, np.asarray(jpe.prompt_encoder_dense(params["prompt_encoder"], 3, jc.prompt)))


def test_conv_transpose_2x_matches_and_is_unflipped(rng):
    x = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    w = rng.standard_normal((8, 2, 2, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jsd._conv_transpose_2x({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                             jnp.asarray(x)))
    got = conv_transpose_2x(t(x), t(w), t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    # out[2i+di, 2j+dj, o] = sum_c x[i, j, c] w[c, di, dj, o] + b[o]: no flip
    formula = np.einsum("nijc,cdeo->nidjeo", x, w).reshape(2, 6, 10, 4) + b
    np.testing.assert_allclose(got, formula, atol=1e-5, rtol=1e-5)


def test_attention_qkv_matches(rng):
    from cor_tpu.ops.attention import attention_qkv, init_attention_qkv

    p = np_tree(init_attention_qkv(jax.random.PRNGKey(2), 32, 4, 2))
    q, k = (rng.standard_normal((2, n, 32)).astype(np.float32) for n in (6, 20))
    want = np.asarray(attention_qkv(p, q, k, k, 4))
    got = load_cor_tpu_params(AttentionQKV(32, 4, 2), p)(t(q), t(k), t(k)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["skip_pe", "pe", "store", "int8"])
def test_two_way_layer_plain_matches_pallas(sam_layer, rng, case):
    """K1's plain version against two_way_layer_fused at N = 1024 (32 x 32),
    the smallest N at which cor_tpu engages K1."""
    p, port = sam_layer
    lp, blk = p["layers"][0], port.layers[0]
    N, C, I = 1024, 256, 128
    store = rng.standard_normal((3, N, C)).astype(np.float32) * 0.5
    tok = rng.standard_normal((2, 6, C)).astype(np.float32) * 0.5
    kpe = rng.standard_normal((N, I)).astype(np.float32) * 0.5
    qpe = rng.standard_normal((N, I)).astype(np.float32) * 0.5
    skip = case != "pe"
    idx = scale = None
    keys = store[:2]
    if case in ("store", "int8"):
        idx = np.array([2, 0], np.int32)
        keys = store
    if case == "int8":
        keys, scale = (np.asarray(a) for a in jengine.quantize_candidate_store(store))
    want_q, want_k = jtwl.two_way_layer_fused(
        lp, tok, tok, keys, kpe, qpe, 8, skip_pe=skip,
        keys_idx=None if idx is None else jnp.asarray(idx),
        keys_scale=None if scale is None else jnp.asarray(scale))
    args = (blk, t(tok), t(tok), t(keys), t(kpe), t(qpe), skip)
    kw = dict(idx=None if idx is None else t(idx), scale=None if scale is None else t(scale))
    got_q, got_k = two_way_layer_plain(*args, **kw)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q), **KTOL)
    np.testing.assert_allclose(got_k.numpy(), np.asarray(want_k), **KTOL)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = two_way_layer.launches
    q2, k2 = two_way_layer(*args, **kw)
    assert two_way_layer.launches == before
    torch.testing.assert_close(q2, got_q, atol=0, rtol=0)
    torch.testing.assert_close(k2, got_k, atol=0, rtol=0)


def test_t2i_flash_kv_plain_matches_pallas(sam_layer, rng):
    p, port = sam_layer
    fa_j, fa = p["final_attn_t2i"], port.final_attn_t2i
    keys = rng.standard_normal((3, 512, 256)).astype(np.float32) * 0.5
    kpe = rng.standard_normal((512, 128)).astype(np.float32) * 0.5
    q_tok = rng.standard_normal((3, 6, 128)).astype(np.float32)
    want = np.asarray(j_t2i_flash_kv(
        keys, fa_j["k_proj"]["w"], fa_j["k_proj"]["b"], fa_j["v_proj"]["w"], fa_j["v_proj"]["b"],
        kpe, q_tok, 8))
    args = (t(keys), fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, t(kpe), t(q_tok), 8)
    np.testing.assert_allclose(t2i_flash_kv_plain(*args).numpy(), want, **KTOL)
    before = t2i_flash_kv.launches
    np.testing.assert_allclose(t2i_flash_kv(*args).numpy(), want, **KTOL)
    assert t2i_flash_kv.launches == before


def tail_inputs(rng, n_out):
    B, H, W, C, O1, O2 = 2, 4, 4, 256, 64, 32
    return (
        rng.standard_normal((B, H, W, C)).astype(np.float32) * 0.5,
        rng.standard_normal((C, 2, 2, O1)).astype(np.float32) * 0.05,
        rng.standard_normal(O1).astype(np.float32) * 0.1,
        rng.standard_normal(O1).astype(np.float32),
        rng.standard_normal(O1).astype(np.float32),
        rng.standard_normal((O1, 2, 2, O2)).astype(np.float32) * 0.05,
        rng.standard_normal(O2).astype(np.float32) * 0.1,
        rng.standard_normal((B, n_out, O2)).astype(np.float32),
    )


@pytest.mark.parametrize("n_out", [1, 3])
def test_decoder_tail_plain_matches_pallas_fp32(rng, n_out):
    a = tail_inputs(rng, n_out)
    want = np.asarray(fused_decoder_tail(*(jnp.asarray(x) for x in a)))
    got = decoder_tail_plain(*(t(x) for x in a)).numpy()
    assert got.shape == want.shape == (2, n_out, 16, 16)
    np.testing.assert_allclose(got, want, **KTOL)
    before = decoder_tail.launches
    np.testing.assert_allclose(decoder_tail(*(t(x) for x in a)).numpy(), want, **KTOL)
    assert decoder_tail.launches == before


def test_decoder_tail_plain_bf16_within_bf16_rounding(rng):
    """In bf16 (polynomial GELU, fp32 statistics) the plain tail and
    cor_tpu's bf16 kernel both stay within 0.05 relative of the fp32 tail,
    cor_tpu's own bound (test_decoder_tail_kernel.py)."""
    src, w1, b1, ls, lb, w2, b2, hyper = tail_inputs(rng, 1)
    x = jsd._conv_transpose_2x({"w": jnp.asarray(w1), "b": jnp.asarray(b1)}, jnp.asarray(src))
    x = jgelu(jlayer_norm({"scale": jnp.asarray(ls), "bias": jnp.asarray(lb)}, x, eps=1e-6))
    up = jgelu(jsd._conv_transpose_2x({"w": jnp.asarray(w2), "b": jnp.asarray(b2)}, x))
    ref = np.asarray(jnp.einsum("bnc,bhwc->bnhw", jnp.asarray(hyper), up))
    bf = torch.bfloat16
    got = decoder_tail_plain(t(src).to(bf), t(w1).to(bf), t(b1), t(ls), t(lb), t(w2).to(bf),
                             t(b2), t(hyper).to(bf)).numpy()
    tpu = np.asarray(fused_decoder_tail(
        jnp.asarray(src, jnp.bfloat16), jnp.asarray(w1, jnp.bfloat16), b1, ls, lb,
        jnp.asarray(w2, jnp.bfloat16), b2, jnp.asarray(hyper, jnp.bfloat16)))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 0.05
    assert np.abs(got - tpu).max() / scale < 0.05


@pytest.mark.parametrize("rows,tokens,width,heads", [
    (4096, 6, 256, 8), (4096, 8, 256, 8), (4096, 9, 256, 8), (16, 6, 16, 2), (1024, 7, 256, 8),
    (2048, 5, 256, 8), (4096, 6, 256, 7), (3000, 6, 256, 8)])
def test_fused_decode_routes_as_cor_tpu(rows, tokens, width, heads):
    """The port's ``layer_route`` is cor_tpu's ``layer_fused`` test
    (models/sam_decoder.py:255-260, on its K1's row tile and token pad)."""
    cor = rows % jtwl._TILE == 0 and tokens <= jtwl._T and width % heads == 0
    assert psd.layer_route(rows, tokens, width, heads) == ("layer" if cor else "k8")


@pytest.mark.parametrize("grid,tokens,want", [
    (48, 6, "@grid"), (64, 33, "@T>32"), (64, 5, "no kernel for device meta"),
    (64, 7, "no kernel for device meta"), (64, 8, "no kernel for device meta"),
    (64, 9, "no kernel for device meta")])
def test_fused_decode_refuses_off_the_cpu_before_any_kernel(grid, tokens, want):
    """Off the CPU (here: the meta device, which has no kernels), a fused
    decode of more than 32 tokens, or on a grid other than 64 wide, is
    refused naming its ROADMAP row before any kernel wrapper is reached; 5
    to 8 tokens reach K1's wrapper and 9 K8a's (cor_tpu's K8 route)."""
    p = psd.TwoWayTransformer(psd.TwoWayTransformerConfig()).to("meta")
    emb = torch.empty(1, grid, grid, 256, device="meta")
    with pytest.raises(ValueError, match=want):
        psd.two_way_transformer(p, emb, emb, torch.empty(1, tokens, 256, device="meta"))


def test_two_way_transformer_matches_layer_fused_path(sam_layer, rng):
    """The whole transformer at N = 1024, where cor_tpu runs K1 for both
    layers and K2 for the final attention."""
    p, port = sam_layer
    img = rng.standard_normal((2, 32, 32, 256)).astype(np.float32) * 0.3
    pe = rng.standard_normal((1, 32, 32, 256)).astype(np.float32) * 0.3
    tok = rng.standard_normal((2, 6, 256)).astype(np.float32) * 0.5
    hs, src = jsd.two_way_transformer(p, img, pe, tok, jsd.TwoWayTransformerConfig(), fused=True)
    got_hs, got_src = psd.two_way_transformer(port, t(img), t(pe), t(tok))
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(hs), **DTOL)
    np.testing.assert_allclose(got_src.numpy(), np.asarray(src), **DTOL)


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
def test_mask_decoder_matches(tiny_decode, rng, multimask):
    jc, pc, params, model = tiny_decode
    img = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    pe = rng.standard_normal((1, 4, 4, 16)).astype(np.float32)
    sparse = rng.standard_normal((3, 1, 16)).astype(np.float32)
    dense = rng.standard_normal((3, 4, 4, 16)).astype(np.float32) * 0.1
    want = jsd.mask_decoder(params["mask_decoder"], img, pe, sparse, dense, TINY_DECODER,
                            multimask_output=multimask, fused=True)
    got = psd.mask_decoder(model.mask_decoder, t(img), t(pe), t(sparse), t(dense), multimask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DTOL)
    assert got[0].shape == (3, 3 if multimask else 1, 16, 16)


def test_decode_functions_match(tiny_decode, rng):
    """Both decode functions of retrieval/index.py: host rows with the dense
    prompt added, and the int8 store read through store_idx/store_scale."""
    jc, pc, params, model = tiny_decode
    store = rng.standard_normal((5, 4, 4, 16)).astype(np.float32)
    feats = rng.standard_normal((3, 16)).astype(np.float32)
    idx = np.array([4, 0, 2], np.int32)
    want = np.asarray(jindex.make_candidate_mask_decoder(jc)(params, store[idx], feats))
    got = pindex.make_candidate_mask_decoder(pc)(model, t(store[idx]), t(feats))
    assert got.dtype == torch.float32 and got.shape == (3, 1, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, **DTOL)

    no_mask = params["prompt_encoder"]["no_mask_embed"][0]
    q, s = pengine.quantize_candidate_store_host(store, no_mask)
    want = np.asarray(jindex.make_store_indexed_mask_decoder(jc)(params, q, s, idx, feats))
    got = pindex.make_store_indexed_mask_decoder(pc)(model, t(q), t(s), t(idx), t(feats))
    np.testing.assert_allclose(got.numpy(), want, **DTOL)


def test_quantize_candidate_store_host_is_bit_identical(rng):
    store = (rng.standard_normal((7, 4, 4, 16)) * 3).astype(np.float16)
    store[3] = 0  # an all-zero row takes the 1e-12 scale floor
    no_mask = rng.standard_normal(16).astype(np.float32)
    for bias in (None, no_mask):
        for chunk in (2, 256):
            got = pengine.quantize_candidate_store_host(store, bias, chunk=chunk)
            want = jengine.quantize_candidate_store_host(store, bias, chunk=chunk)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


def test_weight_bridge_covers_the_decode_model(tiny_decode):
    jc, pc, params, model = tiny_decode
    fresh = pcore.init_decode_model(pc, 0)
    names = {n for n, _ in fresh.named_parameters()}
    assert names == {n for n, _ in model.named_parameters()}
    # the port's init draws cor_tpu's shapes; an extra or missing leaf fails
    tree = {"prompt_encoder": params["prompt_encoder"], "mask_decoder": params["mask_decoder"]}
    for name, p in fresh.named_parameters():
        leaf = tree
        for part in name.split("."):
            leaf = leaf[int(part)] if isinstance(leaf, list) else leaf[part]
        assert p.shape == torch.Size(
            np.asarray(leaf).T.shape if name.endswith("w") and np.ndim(leaf) == 2
            else np.shape(leaf)), name
    bad = dict(tree, extra={"w": np.zeros(2)})
    with pytest.raises(ValueError, match="extra"):
        load_cor_tpu_params(pcore.init_decode_model(pc, 0), bad)
