"""cor_tpu_torch's path for SAM's stock prompts against cor_tpu's, on the CPU.

Points, boxes and masks go through the full prompt encoder, and its sparse
prompts make decodes of 5 to 32 tokens: cor_tpu runs them through its layer
kernel (K1) up to 8 tokens on a grid of a multiple of 1,024 rows, and
through K8a (``proj_q_t2i_flash``) and K8b (``i2t_attention_fused``) above.
The same inputs, made with numpy from a seed, and the same weights (a
cor_tpu tree carried over by the weight bridge) go through both packages in
fp32; cor_tpu's Pallas kernels run in interpret mode, as in its own tests,
and the port's kernel wrappers run their plain versions on the CPU.
Tolerances: 1e-5 for the prompt encoder (fp32 elementwise and small
convolutions), cor_tpu's kernel tests' 2e-4 for K8a and K8b against their
oracles (tests/test_pallas_kernels.py), and test_torch_decoder.py's DTOL,
5e-4, for the composed transformer and decoder.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cor_tpu.models import prompt_encoder as jpe
from cor_tpu.models import sam_decoder as jsd
from cor_tpu.ops.pallas.i2t_attention import i2t_attention_fused as j_i2t
from cor_tpu.ops.pallas.t2i_flash import proj_q_t2i_flash as j_proj_q
from cor_tpu.retrieval import engine as jengine
from cor_tpu_torch.models import prompt_encoder as ppe
from cor_tpu_torch.models import sam_decoder as psd
from cor_tpu_torch.ops.kernels.i2t_attention import (
    i2t_attention_fused,
    i2t_attention_fused_plain,
)
from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash, proj_q_t2i_flash_plain
from cor_tpu_torch.utils.weights import load_cor_tpu_params

KTOL = dict(atol=2e-4, rtol=2e-4)  # kernel vs its oracle
DTOL = dict(atol=5e-4, rtol=5e-4)  # composed transformer and decoder
PTOL = dict(atol=1e-5, rtol=1e-5)  # prompt encoder

SAM_PROMPT = dict(embed_dim=256, image_embedding_size=(64, 64), input_image_size=(1024, 1024),
                  mask_in_chans=16)
TINY_PROMPT = dict(embed_dim=16, image_embedding_size=(4, 4), input_image_size=(64, 64),
                   mask_in_chans=8)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(autouse=True)
def no_grad():
    with torch.no_grad():
        yield


def prompt_pair(cfg: dict, seed: int):
    """cor_tpu's full prompt encoder params and the port's module from them."""
    jcfg, pcfg = jpe.PromptEncoderConfig(**cfg), ppe.PromptEncoderConfig(**cfg)
    params = np_tree(jpe.init_full_prompt_encoder(jax.random.PRNGKey(seed), jcfg))
    return jcfg, pcfg, params, load_cor_tpu_params(ppe.FullPromptEncoder(pcfg), params)


@pytest.fixture(scope="module")
def sam_prompts():
    return prompt_pair(SAM_PROMPT, 3)


def prompts(rng, case: str, B: int, size: int, n_points: int = 3):
    """(points, boxes, masks) of a prompt case as numpy arrays (or None)."""
    points = boxes = masks = None
    if "points" in case:
        coords = rng.uniform(0, size, (B, n_points, 2)).astype(np.float32)
        labels = rng.integers(0, 2, (B, n_points)).astype(np.int32)
        labels[:, -1] = -1  # a caller's own padding point
        points = (coords, labels)
    if "box" in case:
        lo = rng.uniform(0, size / 2, (B, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(1, size / 2, (B, 2))], 1).astype(np.float32)
    if "masks" in case:
        side = size // 4  # the mask prompt is 4x the embedding grid: 256 at SAM's
        masks = rng.standard_normal((B, side, side, 1)).astype(np.float32)
    return points, boxes, masks


@pytest.mark.parametrize("case", ["points", "box", "box+points", "masks", "points+masks",
                                  "none"])
def test_full_prompt_encoder_matches(sam_prompts, rng, case):
    """SAM's geometry (256 wide, 64 x 64 grid, 1024-pixel images, 256 x 256
    mask prompts): points alone get cor_tpu's padding point, points with a
    box do not."""
    jcfg, pcfg, params, port = sam_prompts
    points, boxes, masks = prompts(rng, case, 2, 1024)
    want = jpe.full_prompt_encoder(
        params, jcfg, points=None if points is None else tuple(map(jnp.asarray, points)),
        boxes=None if boxes is None else jnp.asarray(boxes),
        masks=None if masks is None else jnp.asarray(masks), batch=2)
    got = ppe.full_prompt_encoder(
        port, pcfg, points=None if points is None else tuple(map(t, points)),
        boxes=None if boxes is None else t(boxes), masks=None if masks is None else t(masks),
        batch=2)
    n_sparse = (4 if boxes is None else 3) if points is not None else 0
    n_sparse += 2 if boxes is not None else 0
    assert got[0].shape == (2, n_sparse, 256) and got[1].shape == (2, 64, 64, 256)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **PTOL)


def test_embed_points_without_the_pad_point(sam_prompts, rng):
    jcfg, pcfg, params, port = sam_prompts
    coords, labels = prompts(rng, "points", 3, 1024, n_points=5)[0]
    want = jpe.embed_points(params, jnp.asarray(coords), jnp.asarray(labels), jcfg, pad=False)
    got = ppe.embed_points(port, t(coords), t(labels), pcfg, pad=False)
    assert got.shape == (3, 5, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PTOL)
    # a padding label gives not_a_point_embed, whatever its coordinates
    np.testing.assert_array_equal(got[:, -1].numpy(),
                                  np.broadcast_to(params["not_a_point_embed"], (3, 256)))


def test_port_init_has_cor_tpus_leaves():
    """The port's seeded init draws every leaf of init_full_prompt_encoder's
    tree (the bridge refuses a missing or extra one), the embeddings N(0, 1)."""
    cfg = ppe.PromptEncoderConfig(**SAM_PROMPT)
    port = ppe.init_full_prompt_encoder(cfg, 0)
    tree = np_tree(jpe.init_full_prompt_encoder(jax.random.PRNGKey(0),
                                                jpe.PromptEncoderConfig(**SAM_PROMPT)))
    load_cor_tpu_params(ppe.FullPromptEncoder(cfg), tree)
    again = ppe.init_full_prompt_encoder(cfg, 0)
    for (name, a), (_, b) in zip(port.named_parameters(), again.named_parameters()):
        assert torch.equal(a, b), name
    assert abs(port.point_embeddings.std().item() - 1) < 0.1


# ---------------------------------------------------------------------------
# K8a and K8b: the plain versions against cor_tpu's kernels at 256 rows of
# C 256, 9 and 32 tokens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sam_layer():
    """A full-width SAM two-way transformer (C 256, 8 heads, MLP 2048) in
    both packages."""
    cfg = jsd.TwoWayTransformerConfig()
    p = np_tree(jsd.init_two_way_transformer(jax.random.PRNGKey(0), cfg))
    port = load_cor_tpu_params(psd.TwoWayTransformer(psd.TwoWayTransformerConfig()), p)
    return p, port


@pytest.mark.parametrize("T", [9, 32])
def test_proj_q_t2i_flash_plain_matches_pallas(sam_layer, rng, T):
    p, port = sam_layer
    jt, ji = p["layers"][1]["cross_attn_t2i"], p["layers"][1]["cross_attn_i2t"]
    pt, pi = port.layers[1].cross_attn_t2i, port.layers[1].cross_attn_i2t
    keys = rng.standard_normal((2, 256, 256)).astype(np.float32) * 0.5
    kpe, qpe = (rng.standard_normal((256, 128)).astype(np.float32) * 0.5 for _ in range(2))
    q_tok = rng.standard_normal((2, T, 128)).astype(np.float32)
    want = j_proj_q(keys, jt["k_proj"]["w"], jt["k_proj"]["b"], jt["v_proj"]["w"],
                    jt["v_proj"]["b"], ji["q_proj"]["w"], ji["q_proj"]["b"], kpe, qpe, q_tok, 8)
    args = (t(keys), pt.k_proj.w, pt.k_proj.b, pt.v_proj.w, pt.v_proj.b, pi.q_proj.w,
            pi.q_proj.b, t(kpe), t(qpe), t(q_tok), 8)
    got = proj_q_t2i_flash_plain(*args)
    assert got[0].shape == (2, 256, 128) and got[1].shape == (2, T, 128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **KTOL)
    # on CPU tensors the wrapper is the plain version and launches nothing
    before = proj_q_t2i_flash.launches
    for g, w in zip(proj_q_t2i_flash(*args), got):
        torch.testing.assert_close(g, w, atol=0, rtol=0)
    assert proj_q_t2i_flash.launches == before


@pytest.mark.parametrize("T", [9, 32, "stability"])
def test_i2t_attention_fused_plain_matches_pallas(sam_layer, rng, T):
    """"stability": cor_tpu's per-head case (tests/test_pallas_kernels.py:
    76-119), head 0's keys biased by +300: a global shift would underflow
    the other heads."""
    p, port = sam_layer
    jl, pl = p["layers"][0], port.layers[0]
    T_ = 9 if T == "stability" else T
    q_img = rng.standard_normal((2, 256, 128)).astype(np.float32) * 0.5
    keys = rng.standard_normal((2, 256, 256)).astype(np.float32)
    k_tok, v_tok = (rng.standard_normal((2, T_, 128)).astype(np.float32) for _ in range(2))
    if T == "stability":
        k_tok[..., :16] += 300.0
    jo, ln = jl["cross_attn_i2t"]["out_proj"], jl["norm4"]
    want = np.asarray(j_i2t(q_img, keys, k_tok, v_tok, jo["w"], jo["b"], ln["scale"],
                            ln["bias"], num_heads=8))
    po = pl.cross_attn_i2t.out_proj
    args = (t(q_img), t(keys), t(k_tok), t(v_tok), po.w, po.b, pl.norm4.scale, pl.norm4.bias, 8)
    got = i2t_attention_fused_plain(*args)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, **KTOL)
    before = i2t_attention_fused.launches
    torch.testing.assert_close(i2t_attention_fused(*args), got, atol=0, rtol=0)
    assert i2t_attention_fused.launches == before


# ---------------------------------------------------------------------------
# the fused two-way transformer at every route: K1 at 5, 7 and 8 tokens (N =
# 1,024, the smallest grid at which cor_tpu engages it), K8a/K8b at 9 and 16
# (N = 256), and the store-indexed decode through K8a/K8b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,side", [(5, 32), (7, 32), (8, 32), (9, 16), (16, 16)])
def test_two_way_transformer_at_tokens_matches(sam_layer, rng, T, side):
    p, port = sam_layer
    assert psd.layer_route(side * side, T, 256, 8) == ("layer" if T <= 8 else "k8")
    img = rng.standard_normal((2, side, side, 256)).astype(np.float32) * 0.3
    pe = rng.standard_normal((1, side, side, 256)).astype(np.float32) * 0.3
    tok = rng.standard_normal((2, T, 256)).astype(np.float32) * 0.5
    hs, src = jsd.two_way_transformer(p, img, pe, tok, jsd.TwoWayTransformerConfig(), fused=True)
    got_hs, got_src = psd.two_way_transformer(port, t(img), t(pe), t(tok))
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(hs), **DTOL)
    np.testing.assert_allclose(got_src.numpy(), np.asarray(src), **DTOL)


def test_store_indexed_decode_through_k8_matches_gather_fallback(sam_layer, rng):
    """9 tokens from an int8 store: cor_tpu gathers and dequantises in XLA
    before its K8a/K8b layers (models/sam_decoder.py:321-327), the port in
    torch."""
    p, port = sam_layer
    store = rng.standard_normal((5, 16, 16, 256)).astype(np.float32) * 0.3
    q, scale = (np.asarray(a) for a in jengine.quantize_candidate_store(store))
    idx = np.array([4, 0, 2], np.int32)
    pe = rng.standard_normal((1, 16, 16, 256)).astype(np.float32) * 0.3
    tok = rng.standard_normal((3, 9, 256)).astype(np.float32) * 0.5
    hs, src = jsd.two_way_transformer(p, q, pe, tok, jsd.TwoWayTransformerConfig(), fused=True,
                                      store_idx=jnp.asarray(idx), store_scale=jnp.asarray(scale))
    got_hs, got_src = psd.two_way_transformer(port, t(q), t(pe), t(tok), store_idx=t(idx),
                                              store_scale=t(scale))
    assert got_src.shape == (3, 256, 256)
    np.testing.assert_allclose(got_hs.numpy(), np.asarray(hs), **DTOL)
    np.testing.assert_allclose(got_src.numpy(), np.asarray(src), **DTOL)


# ---------------------------------------------------------------------------
# the whole prompt path at a few layers and narrow widths: the full prompt
# encoder feeding the fused mask decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_prompt_decode():
    jcfg, pcfg, pparams, pport = prompt_pair(TINY_PROMPT, 5)
    dcfg = jsd.MaskDecoderConfig(
        transformer_dim=16, iou_head_hidden_dim=16,
        transformer=jsd.TwoWayTransformerConfig(depth=2, embedding_dim=16, num_heads=2,
                                                mlp_dim=32))
    dparams = np_tree(jsd.init_mask_decoder(jax.random.PRNGKey(6), dcfg))
    port_dec = load_cor_tpu_params(psd.MaskDecoder(psd.MaskDecoderConfig(
        transformer_dim=16, iou_head_hidden_dim=16,
        transformer=psd.TwoWayTransformerConfig(depth=2, embedding_dim=16, num_heads=2,
                                                mlp_dim=32))), dparams)
    return jcfg, pcfg, pparams, pport, dcfg, dparams, port_dec


@pytest.mark.parametrize("multimask", [False, True], ids=["single", "multimask"])
@pytest.mark.parametrize("case,n_points", [("masks", 0), ("points", 2),
                                           ("box+points+masks", 4)])
def test_mask_decoder_from_full_prompts_matches(tiny_prompt_decode, rng, case, n_points,
                                                multimask):
    jcfg, pcfg, pparams, pport, dcfg, dparams, port_dec = tiny_prompt_decode
    points, boxes, masks = prompts(rng, case, 3, 64, n_points=max(n_points, 1))
    jsparse, jdense = jpe.full_prompt_encoder(
        pparams, jcfg, points=None if points is None else tuple(map(jnp.asarray, points)),
        boxes=None if boxes is None else jnp.asarray(boxes),
        masks=None if masks is None else jnp.asarray(masks), batch=3)
    sparse, dense = ppe.full_prompt_encoder(
        pport, pcfg, points=None if points is None else tuple(map(t, points)),
        boxes=None if boxes is None else t(boxes), masks=None if masks is None else t(masks),
        batch=3)
    img = rng.standard_normal((3, 4, 4, 16)).astype(np.float32)
    jpe_grid = jpe.get_dense_pe(pparams, jcfg)
    want = jsd.mask_decoder(dparams, img, jpe_grid, jsparse, jdense, dcfg,
                            multimask_output=multimask, fused=True)
    got = psd.mask_decoder(port_dec, t(img), ppe.dense_positional_encoding(
        pport.pe_layer.gaussian_matrix, pcfg.image_embedding_size), sparse, dense, multimask)
    assert got[0].shape == (3, 3 if multimask else 1, 16, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **DTOL)
