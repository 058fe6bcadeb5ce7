"""The port's checkpoint import and export against cor_tpu's, on the CPU.

Every state dict is written by the test: cor_tpu's exporters
(``cor_tpu.utils.export``) applied to the port's seeded init of cor_tpu's
tiny model (tests/helpers.py) as a cor_tpu tree, then ``torch.save``; the HF
SigLIP keys are made here. Per dialect (a stock SAM ``.pth``, an open_clip
SigLIP ``.bin``, HF SigLIP, a trained CORE checkpoint with DDP ``module.``
prefixes) the port's converter must give cor_tpu's tree bit for bit, and the
port's load into a model seeded otherwise must equal the weight bridge's
load of the same tree. Also: the audit's three lists, the ``no_mask_embed``
quirk (a SAM ``.pth`` never loads the prompt encoder), a repack of the
decoder's kernel packs after a load (P7), the exporters key for key, the
reference-format ``.pth`` read back by cor_tpu, and ``cli.export`` (a port
checkpoint directory read into a ``.pth``, and ``--to-orbax`` into an Orbax
directory that cor_tpu restores).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import pytest
import torch

from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.utils import convert as pconv
from cor_tpu_torch.utils import export as pexp
from cor_tpu_torch.utils.weights import flatten_tree, load_cor_tpu_params, to_cor_tpu_tree
from tests.test_torch_retrieve import port_config

LOG = logging.getLogger("test_torch_checkpoint_io")


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_checkpoint_io.py: {time.perf_counter() - t0:.1f} s")


@pytest.fixture(scope="module")
def tree():
    """The port's seeded tiny model (seed 0) as a cor_tpu tree."""
    return to_cor_tpu_tree(pcore.init_core_model(port_config(), 0))


def assert_trees_equal(got, want):
    g, w = flatten_tree(got), flatten_tree(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))[:10]
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def assert_module_equals_bridge(module, subtree, make):
    """``module``'s leaves equal those of ``make()`` loaded by the weight
    bridge from ``subtree``, bit for bit."""
    want = dict(load_cor_tpu_params(make(), subtree).state_dict())
    got = dict(module.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def hf_siglip_state_dict(siglip) -> dict:
    """The HF SiglipModel naming of a cor_tpu SigLIP tree (convert_siglip_hf's
    inverse, written out here)."""
    from cor_tpu.utils.export import _ln, _patchify

    sd = {}

    def block(prefix, b):
        w, bias = b["attn"]["qkv"]["w"], b["attn"]["qkv"]["b"]
        d = w.shape[0]
        for j, n in enumerate(("q_proj", "k_proj", "v_proj")):
            sd[f"{prefix}.self_attn.{n}.weight"] = w[:, j * d:(j + 1) * d].T.copy()
            sd[f"{prefix}.self_attn.{n}.bias"] = bias[j * d:(j + 1) * d].copy()
        sd[f"{prefix}.self_attn.out_proj.weight"] = b["attn"]["proj"]["w"].T.copy()
        sd[f"{prefix}.self_attn.out_proj.bias"] = b["attn"]["proj"]["b"].copy()
        _ln(sd, f"{prefix}.layer_norm1", b["norm1"])
        _ln(sd, f"{prefix}.layer_norm2", b["norm2"])
        for n in ("fc1", "fc2"):
            m = b["mlp"]["lin1" if n == "fc1" else "lin2"]
            sd[f"{prefix}.mlp.{n}.weight"], sd[f"{prefix}.mlp.{n}.bias"] = m["w"].T.copy(), m["b"]

    v, t = siglip["visual"], siglip["text"]
    _patchify(sd, "vision_model.embeddings.patch_embedding", v["patch_embed"])
    sd["vision_model.embeddings.position_embedding.weight"] = v["pos_embed"][0].copy()
    for i, b in enumerate(v["blocks"]):
        block(f"vision_model.encoder.layers.{i}", b)
    _ln(sd, "vision_model.post_layernorm", v["norm"])
    pool, h = v["attn_pool"], "vision_model.head"
    sd[f"{h}.probe"] = pool["latent"].copy()
    sd[f"{h}.attention.in_proj_weight"] = np.concatenate([pool["q"]["w"].T, pool["kv"]["w"].T])
    sd[f"{h}.attention.in_proj_bias"] = np.concatenate([pool["q"]["b"], pool["kv"]["b"]])
    sd[f"{h}.attention.out_proj.weight"] = pool["proj"]["w"].T.copy()
    sd[f"{h}.attention.out_proj.bias"] = pool["proj"]["b"].copy()
    _ln(sd, f"{h}.layernorm", pool["norm"])
    for n, m in (("fc1", pool["mlp"]["lin1"]), ("fc2", pool["mlp"]["lin2"])):
        sd[f"{h}.mlp.{n}.weight"], sd[f"{h}.mlp.{n}.bias"] = m["w"].T.copy(), m["b"]
    sd["text_model.embeddings.token_embedding.weight"] = t["token_embedding"].copy()
    sd["text_model.embeddings.position_embedding.weight"] = t["positional_embedding"].copy()
    for i, b in enumerate(t["blocks"]):
        block(f"text_model.encoder.layers.{i}", b)
    _ln(sd, "text_model.final_layer_norm", t["ln_final"])
    sd["text_model.head.weight"] = t["text_projection"]["w"].T.copy()
    sd["text_model.head.bias"] = t["text_projection"]["b"].copy()
    return sd


def save(path, sd, wrap=None):
    obj = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    torch.save({wrap: obj} if wrap else obj, path)
    return path


@pytest.mark.parametrize("dialect", ["sam_pth", "openclip_bin", "hf_siglip", "core_ddp"])
def test_converters_and_loads_match_cor_tpu(tree, tmp_path, dialect):
    """Per dialect: the port's converter gives cor_tpu's tree bit for bit
    (and the tree the file was written from), and the port's load into a
    model seeded otherwise equals the bridge's load of that tree. A SAM
    .pth leaves the prompt encoder (no_mask_embed) at its init even though
    the file holds a prompt encoder that differs."""
    from cor_tpu.utils import convert as jconv
    from cor_tpu.utils import export as jexp

    pc = port_config()
    sig = pc.support.siglip
    model = pcore.init_core_model(pc, 7)
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    if dialect == "sam_pth":
        sd = {**jexp.export_sam_encoder(tree["image_encoder"]),
              **jexp.export_sam_decoder(tree["mask_decoder"]),
              "prompt_encoder.no_mask_embed.weight": tree["prompt_encoder"]["no_mask_embed"] + 1}
        path = save(tmp_path / "sam.pth", {f"module.{k}": v for k, v in sd.items()})
        loaded = pconv.load_torch_state_dict(path)
        for name, conv, args in (("image_encoder", "convert_sam_encoder", (pc.encoder.depth,)),
                                 ("mask_decoder", "convert_sam_decoder", ())):
            stripped = pconv.strip_ddp_prefix(loaded)
            got = getattr(pconv, conv)(stripped, *args)
            assert_trees_equal(got, getattr(jconv, conv)(jconv.strip_ddp_prefix(loaded), *args))
            assert_trees_equal(got, tree[name])
        pconv.load_sam_weights(model, path, pc.encoder.depth)
        assert_module_equals_bridge(model.image_encoder, tree["image_encoder"],
                                    lambda: pcore.init_image_encoder(pc, 1))
        assert_module_equals_bridge(model.mask_decoder, tree["mask_decoder"],
                                    lambda: pcore.init_mask_decoder(pc, 1))
        untouched = ("prompt_encoder.", "support_branch.")
    elif dialect == "openclip_bin":
        s = tree["support_branch"]["siglip"]
        path = save(tmp_path / "siglip.bin", {**jexp.export_siglip_vision(s["visual"]),
                                              **jexp.export_siglip_text(s["text"])}, "state_dict")
        loaded = pconv.load_torch_state_dict(path)
        for name, conv, depth in (("visual", "convert_siglip_vision", sig.vision.depth),
                                  ("text", "convert_siglip_text", sig.text.depth)):
            got = getattr(pconv, conv)(loaded, depth)
            assert_trees_equal(got, getattr(jconv, conv)(loaded, depth))
            assert_trees_equal(got, s[name])
        pconv.load_siglip_weights(model, path, sig.vision.depth, sig.text.depth)
        assert_module_equals_bridge(model.support_branch.siglip, s,
                                    lambda: pcore.init_support_branch(pc, 1).siglip)
        untouched = ("image_encoder.", "prompt_encoder.", "mask_decoder.",
                     "support_branch.cir_fuse.", "support_branch.mask_pooling.")
    elif dialect == "hf_siglip":
        sd = hf_siglip_state_dict(tree["support_branch"]["siglip"])
        got = pconv.convert_siglip_hf(sd, sig.vision.depth, sig.text.depth)
        assert_trees_equal(got, jconv.convert_siglip_hf(sd, sig.vision.depth, sig.text.depth))
        assert_trees_equal(got, tree["support_branch"]["siglip"])
        load_cor_tpu_params(model.support_branch.siglip, got)
        assert_module_equals_bridge(model.support_branch.siglip, tree["support_branch"]["siglip"],
                                    lambda: pcore.init_support_branch(pc, 1).siglip)
        untouched = ("image_encoder.", "prompt_encoder.", "mask_decoder.")
    else:
        sd = {f"module.{k}": v for k, v in jexp.export_core_state_dict(tree).items()}
        path = save(tmp_path / "core.pth", sd, "model_state_dict")
        want = jconv.load_trained_params(path, _jax_tiny_config(), None, LOG,
                                         "MaskAdapterPooling")
        got = pconv.convert_core_checkpoint(pconv.load_torch_state_dict(path), pc.encoder.depth,
                                            sig.vision.depth, sig.text.depth)
        assert_trees_equal(got, want)
        assert_trees_equal(got, tree)
        pconv.load_trained_params(path, pc, model, LOG)
        assert_module_equals_bridge(model, tree, lambda: pcore.init_core_model(pc, 1))
        untouched = ()
    for k, v in model.state_dict().items():
        if k.startswith(untouched):
            assert torch.equal(v, fresh[k]), f"{dialect} loaded {k}"


def _jax_tiny_config():
    from tests.helpers import tiny_core_config

    return tiny_core_config()


def test_audit_lists_match_cor_tpu(tree):
    """One missing, one unexpected and one mismatched leaf: the port's three
    lists are cor_tpu's; the audit of the model against its own tree is
    empty, and ``expected_tree`` holds no copy of a weight."""
    from cor_tpu.utils.convert import audit_params as j_audit

    loaded = {k: v for k, v in tree.items()}
    loaded["mask_decoder"] = dict(tree["mask_decoder"], iou_token=np.zeros((2, 16), np.float32),
                                  extra_leaf=np.zeros(3, np.float32))
    enc = dict(tree["image_encoder"])
    del enc["pos_embed"]
    loaded["image_encoder"] = enc
    got, want = pconv.audit_params(tree, loaded), j_audit(tree, loaded)
    assert got == want
    assert got == {"missing": ["['image_encoder']['pos_embed']"],
                   "unexpected": ["['mask_decoder']['extra_leaf']"],
                   "mismatched": ["['mask_decoder']['iou_token']"]}
    model = pcore.init_core_model(port_config(), 0)
    expected = pconv.expected_tree(model)
    assert pconv.audit_params(expected, tree) == {"missing": [], "unexpected": [],
                                                  "mismatched": []}
    assert all(a.strides == (0,) * a.ndim for a in flatten_tree(expected).values())


@pytest.mark.parametrize("route", ["core_pth", "port_dir"])
def test_load_repacks_packed_decoder_weights(tree, tmp_path, route):
    """P7: a decoder layer packed before a load is packed again after it
    (the load writes in place: the tensors' versions move), and the new pack
    is the loaded weights'. The pack is K1's ``cached_pack`` on the layer
    over its parameters, as ``two_way_layer._pack`` keys it (its layouts
    take only SAM's full decoder width: here a flat copy)."""
    from cor_tpu.utils.export import export_core_state_dict
    from cor_tpu_torch.ops.kernels.t2i_flash import cached_pack
    from cor_tpu_torch.train.checkpoint import save_checkpoint

    def pack(layer):
        return cached_pack(layer, "_kernel_pack", list(layer.parameters()), "cpu",
                           torch.float32, lambda: torch.cat(
                               [p.detach().reshape(-1).clone() for p in layer.parameters()]))

    pc = port_config()
    model = pcore.init_core_model(pc, 7)
    layer = model.mask_decoder.transformer.layers[0]
    before = pack(layer)
    assert pack(layer) is before
    if route == "core_pth":
        path = save(tmp_path / "core.pth", export_core_state_dict(tree))
    else:
        src = pcore.init_core_model(pc, 0)
        path = save_checkpoint(tmp_path, "best_model", {"params": src.state_dict()})
    pconv.load_trained_params(path, pc, model, LOG)
    after = pack(layer)
    assert after is not before and not torch.equal(after, before)
    assert pack(layer) is after
    fresh_layer = load_cor_tpu_params(pcore.init_mask_decoder(pc, 3),
                                      tree["mask_decoder"]).transformer.layers[0]
    assert torch.equal(after, pack(fresh_layer))


def test_build_model_with_query_support_feat(tree, tmp_path, monkeypatch):
    """The factory loads the SAM .pth's encoder and decoder and the SigLIP
    .bin's towers (the bridge's bits) and leaves no_mask_embed at the init
    of its seed, though the .pth holds another."""
    from cor_tpu_torch.models import build as pbuild

    pc = port_config()
    monkeypatch.setattr(pbuild, "CoreConfig", lambda **kw: pc)
    tiny = pcore.init_core_model(pc, 3)
    tiny_tree = to_cor_tpu_tree(tiny)
    sam = {**pexp.export_sam_state_dict(tree)}
    sam["prompt_encoder.no_mask_embed.weight"] = sam["prompt_encoder.no_mask_embed.weight"] + 5
    pexp.save_state_dict(tmp_path / "sam.pth", sam)
    pexp.save_state_dict(tmp_path / "siglip.bin",
                         pexp.export_siglip_state_dict(tree["support_branch"]["siglip"]))
    model, cfg = pbuild.build_model_with_query_support_feat(
        sam_checkpoint_path=str(tmp_path / "sam.pth"),
        siglip_checkpoint_path=str(tmp_path / "siglip.bin"), seed=3)
    assert cfg is pc
    got = to_cor_tpu_tree(model)
    assert_trees_equal(got["image_encoder"], tree["image_encoder"])
    assert_trees_equal(got["mask_decoder"], tree["mask_decoder"])
    assert_trees_equal(got["support_branch"]["siglip"], tree["support_branch"]["siglip"])
    assert_trees_equal(got["prompt_encoder"], tiny_tree["prompt_encoder"])
    assert_trees_equal(got["support_branch"]["cir_fuse"], tiny_tree["support_branch"]["cir_fuse"])


def test_export_matches_cor_tpu_and_reads_back(tmp_path):
    """export_core_state_dict of the port's model equals cor_tpu's of its
    tree key for key, bit for bit; cor_tpu's load_trained_params reads the
    port's reference-format .pth back into the same tree."""
    from cor_tpu.utils.convert import load_trained_params as j_load
    from cor_tpu.utils.export import export_core_state_dict as j_export

    model = pcore.init_core_model(port_config(), 4)
    t = to_cor_tpu_tree(model)
    got, want = pexp.export_core_state_dict(model), j_export(t)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pexp.save_core_checkpoint(str(tmp_path / "m.pth"), model, epoch=3, loss=0.25)
    raw = torch.load(tmp_path / "m.pth", weights_only=True)
    assert (raw["epoch"], raw["loss"], raw["optimizer_state_dict"]) == (3, 0.25, {})
    assert_trees_equal(j_load(tmp_path / "m.pth", _jax_tiny_config(), None, LOG), t)


def test_cli_export_reads_port_checkpoints_and_refuses_orbax(tmp_path, monkeypatch, capsys):
    """cli.export reads a checkpoint directory of the port's trainer (its
    epoch and loss too) into a .pth that cor_tpu converts to the model's
    tree; with --to-orbax into a params-only Orbax directory, which
    cor_tpu's load_trained_params restores to the same tree bit for bit and
    the port's loads back bit for bit (the round trip); a path that is
    neither is refused."""
    from cor_tpu.utils.convert import load_trained_params as j_load
    from cor_tpu_torch.cli import export as pexport_cli
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.train.checkpoint import save_checkpoint

    pc = port_config()
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: pc)
    model = pcore.init_core_model(pc, 5)
    save_checkpoint(tmp_path, "checkpoint_epoch_2", {"params": model.state_dict(), "epoch": 2,
                                                     "loss": 0.5, "step": 8})
    cfg = tmp_path / "eval.yaml"
    cfg.write_text("batch_size: 2\n")
    out = pexport_cli.main(["--checkpoint", str(tmp_path / "checkpoint_epoch_2"),
                            "--out", str(tmp_path / "out" / "e2.pth"), "--config", str(cfg)])
    assert (out["epoch"], out["loss"]) == (2, 0.5)
    assert "exported" in capsys.readouterr().out
    assert_trees_equal(j_load(tmp_path / "out" / "e2.pth", _jax_tiny_config(), None, LOG),
                       to_cor_tpu_tree(model))
    orbax = tmp_path / "out" / "best_model"
    out = pexport_cli.main(["--checkpoint", str(tmp_path / "checkpoint_epoch_2"),
                            "--out", str(orbax), "--config", str(cfg), "--to-orbax"])
    assert out["n_keys"] == len(flatten_tree(to_cor_tpu_tree(model)))
    assert_trees_equal(j_load(orbax, _jax_tiny_config(), None, LOG), to_cor_tpu_tree(model))
    back = pcore.init_core_model(pc, 9)
    pconv.load_trained_params(orbax, pc, back, LOG)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    with pytest.raises(SystemExit) as e:
        pexport_cli.main(["--checkpoint", str(tmp_path), "--out", str(tmp_path / "x.pth")])
    assert e.value.code == 2 and "neither" in capsys.readouterr().err
    with pytest.raises(ValueError, match="neither"):
        pconv.load_trained_params(tmp_path, pc, model, LOG)
    with pytest.raises(FileNotFoundError):
        pconv.load_trained_params(tmp_path / "absent.pth", pc, model, LOG)


def test_clis_load_what_the_config_names(tmp_path, monkeypatch, capsys):
    """cli.serve and cli.train take a SAM .pth and a SigLIP .bin (and
    cli.serve a trained .pth), loading them over the seeded weights in
    cor_tpu's order: the served support branch's towers are the .bin's, its
    decode model's mask decoder the .pth's and its prompt encoder (the
    no_mask_embed quirk) the seed's; a trained .pth replaces all three; the
    trainer's frozen encoder and towers are still the files' after an epoch."""
    import dataclasses

    from cor_tpu_torch.cli import serve as pserve_cli
    from cor_tpu_torch.cli import train as ptrain_cli
    from cor_tpu_torch.config import EvalConfig, TrainConfig
    from cor_tpu_torch.retrieval.index import save_gallery_index

    pc = port_config()
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: pc)
    monkeypatch.setattr(TrainConfig, "core_config",
                        lambda self: dataclasses.replace(pc, freeze_towers=self.freeze_towers))
    files = to_cor_tpu_tree(pcore.init_core_model(pc, 5))
    trained = to_cor_tpu_tree(pcore.init_core_model(pc, 11))
    sam = pexp.export_sam_state_dict(files)
    sam["prompt_encoder.no_mask_embed.weight"] = sam["prompt_encoder.no_mask_embed.weight"] + 5
    pexp.save_state_dict(tmp_path / "sam.pth", sam)
    pexp.save_state_dict(tmp_path / "siglip.bin",
                         pexp.export_siglip_state_dict(files["support_branch"]["siglip"]))
    pexp.save_core_checkpoint(str(tmp_path / "core.pth"), trained)
    rng = np.random.default_rng(0)
    save_gallery_index(tmp_path / "idx", rng.standard_normal((6, 16)).astype(np.float32),
                       np.arange(6), image_embeddings=rng.standard_normal((6, 4, 4, 16)))
    keys = (f"load_sam_pretrained_checkpoint: {tmp_path / 'sam.pth'}\n"
            f"load_siglip_pretrained_checkpoint: {tmp_path / 'siglip.bin'}\n")
    serve_argv = ["--gallery-index", str(tmp_path / "idx"), "--k", "3", "--self-test", "2",
                  "--decode-masks", str(tmp_path / "masks"), "--device", "cpu"]
    (tmp_path / "eval.yaml").write_text(keys)
    server = pserve_cli.main(["--config", str(tmp_path / "eval.yaml"), *serve_argv])
    seeded = pcore.init_decode_model(pc, EvalConfig().seed)
    assert_module_equals_bridge(server.model.siglip, files["support_branch"]["siglip"],
                                lambda: pcore.init_support_branch(pc, 1).siglip)
    assert_module_equals_bridge(server.decode_model.mask_decoder, files["mask_decoder"],
                                lambda: pcore.init_mask_decoder(pc, 1))
    for k, v in seeded.prompt_encoder.state_dict().items():
        assert torch.equal(server.decode_model.prompt_encoder.state_dict()[k], v), k
    (tmp_path / "eval.yaml").write_text(keys + f"load_checkpoint_path: {tmp_path / 'core.pth'}\n")
    server = pserve_cli.main(["--config", str(tmp_path / "eval.yaml"), *serve_argv])
    assert_module_equals_bridge(server.model, trained["support_branch"],
                                lambda: pcore.init_support_branch(pc, 1))
    assert_module_equals_bridge(server.decode_model, {k: trained[k] for k in (
        "prompt_encoder", "mask_decoder")}, lambda: pcore.init_decode_model(pc, 1))
    capsys.readouterr()
    (tmp_path / "train.yaml").write_text(
        keys + f"epoch: 1\nbatch_size: 2\nnum_workers: 2\ntrain_model_save_path: "
        f"{tmp_path / 'ck'}\n")
    trainer = ptrain_cli.main(["--config", str(tmp_path / "train.yaml"), "--synthetic",
                               "--device", "cpu"])
    model = trainer.state.model
    assert trainer.state.step == 4
    assert_module_equals_bridge(model.image_encoder, files["image_encoder"],
                                lambda: pcore.init_image_encoder(pc, 1))
    assert_module_equals_bridge(model.support_branch.siglip, files["support_branch"]["siglip"],
                                lambda: pcore.init_support_branch(pc, 1).siglip)
