"""Checkpoint loaders: torch state dicts -> ``cor_tpu`` trees -> the port's
modules. The port's own copy of ``cor_tpu.utils.convert``.

Three external dialects:
1. A stock SAM ``.pth`` (segment-anything key naming): only
   ``image_encoder.*`` and ``mask_decoder.*`` are loaded. The prompt
   encoder's keys are skipped, so ``no_mask_embed`` keeps its seeded init,
   as the reference's checkpoint surgery leaves it.
2. An open_clip SigLIP ``.bin`` (timm vision trunk + open_clip text tower),
   and the HF-transformers SiglipModel naming (``convert_siglip_hf``).
3. A trained CORE checkpoint: the whole composite's state dict, with or
   without DDP ``module.`` prefixes, bare or under ``model_state_dict`` /
   ``state_dict``.

Each ``convert_*`` gives a tree in ``cor_tpu``'s layouts, bit for bit
``cor_tpu``'s (Linear [out, in] -> [in, out]; Conv2d OIHW -> HWIO;
ConvTranspose2d [I, O, kh, kw] -> [I, kh, kw, O]; a patchify conv
[D, C, p, p] -> [(p p C), D] in (row, col, channel) order). The tree then
goes into the modules through the weight bridge
(``utils/weights.load_cor_tpu_params``), which holds the one table of
layout conversions to the port's modules.

The ``load_*`` functions load into "parts": a mapping from the names of
``cor_tpu``'s top-level subtrees (``image_encoder``, ``support_branch``,
``prompt_encoder``, ``mask_decoder``) to the port's modules, or a module
whose children carry those names (``CoreModel``, ``DecodeModel``). Each
part present is loaded in place (``copy_``: every tensor's version moves,
so a decoder whose kernel packs were made before repacks them at its next
call); parts that are absent are skipped. ``load_trained_params`` also
reads the port's own checkpoint directories (``train/checkpoint.py``'s
``state.pt``) and ``cor_tpu``'s Orbax directories (``utils/orbax.py``,
which needs ``tensorstore``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from cor_tpu_torch.train.checkpoint import STATE_FILE, restore_checkpoint
from cor_tpu_torch.utils.orbax import is_orbax_checkpoint, read_params
from cor_tpu_torch.utils.weights import (
    _leaves,
    flatten_tree,
    load_cor_tpu_params,
    to_cor_tpu_layout,
)

Params = Dict[str, Any]
Parts = Union[nn.Module, Mapping[str, nn.Module]]
TORCH_SUFFIXES = (".pth", ".pt", ".bin")


def load_torch_state_dict(path) -> Dict[str, np.ndarray]:
    """A torch checkpoint file's state dict as fp32 numpy arrays (unwrapping
    ``model_state_dict`` and ``state_dict``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]  # the reference trainer's checkpoint format
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.float().numpy() for k, v in obj.items()}


def _keystr(flat_key: str) -> str:
    """``flatten_tree``'s "a.0.b" as jax's ``keystr``: "['a'][0]['b']"."""
    return "".join(f"[{p}]" if p.isdigit() else f"['{p}']" for p in flat_key.split("."))


def audit_params(expected, loaded) -> Dict[str, list]:
    """Missing / unexpected / shape-changed leaves of ``loaded`` against
    ``expected`` (two trees), each list sorted, keys as ``cor_tpu`` prints
    them."""
    e = {_keystr(k): np.shape(v) for k, v in flatten_tree(expected).items()}
    got = {_keystr(k): np.shape(v) for k, v in flatten_tree(loaded).items()}
    return {
        "missing": sorted(set(e) - set(got)),
        "unexpected": sorted(set(got) - set(e)),
        "mismatched": sorted(k for k in set(e) & set(got) if e[k] != got[k]),
    }


def strip_ddp_prefix(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Remove DDP ``module.`` prefixes."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _lin(sd, prefix) -> Params:
    p = {"w": sd[f"{prefix}.weight"].T.copy()}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _conv(sd, prefix, bias=True) -> Params:
    p = {"w": sd[f"{prefix}.weight"].transpose(2, 3, 1, 0).copy()}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _convT(sd, prefix) -> Params:
    return {"w": sd[f"{prefix}.weight"].transpose(0, 2, 3, 1).copy(),
            "b": sd[f"{prefix}.bias"].copy()}


def _ln(sd, prefix) -> Params:
    return {"scale": sd[f"{prefix}.weight"].copy(), "bias": sd[f"{prefix}.bias"].copy()}


def _patchify(sd, prefix) -> Params:
    w = sd[f"{prefix}.weight"]  # [D, C, p, p]
    # the unfold order is (row, col, channel): [p, p, C, D] flattened
    return {"w": w.transpose(2, 3, 1, 0).reshape(-1, w.shape[0]).copy(),
            "b": sd[f"{prefix}.bias"].copy()}


def _mlp(sd, prefix, names=("lin1", "lin2")) -> Params:
    return {"lin1": _lin(sd, f"{prefix}.{names[0]}"), "lin2": _lin(sd, f"{prefix}.{names[1]}")}


def _attn_qkv(sd, prefix) -> Params:
    """SAM two-way attention: separate q/k/v/out projections."""
    return {name: _lin(sd, f"{prefix}.{name}")
            for name in ("q_proj", "k_proj", "v_proj", "out_proj")}


def _mlp_stack(sd, prefix, num_layers) -> Params:
    return {"layers": [_lin(sd, f"{prefix}.layers.{j}") for j in range(num_layers)]}


# ---------------------------------------------------------------------------
# SAM encoder + decoder (stock SAM .pth)
# ---------------------------------------------------------------------------


def convert_sam_encoder(sd: Mapping[str, np.ndarray], depth: int,
                        prefix="image_encoder") -> Params:
    p: Params = {"patch_embed": _patchify(sd, f"{prefix}.patch_embed.proj")}
    if f"{prefix}.pos_embed" in sd:
        p["pos_embed"] = sd[f"{prefix}.pos_embed"].copy()  # already [1, g, g, D]
    blocks = []
    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        attn = {"qkv": _lin(sd, f"{b}.attn.qkv"), "proj": _lin(sd, f"{b}.attn.proj")}
        if f"{b}.attn.rel_pos_h" in sd:
            attn["rel_pos_h"] = sd[f"{b}.attn.rel_pos_h"].copy()
            attn["rel_pos_w"] = sd[f"{b}.attn.rel_pos_w"].copy()
        blocks.append({"norm1": _ln(sd, f"{b}.norm1"), "attn": attn,
                       "norm2": _ln(sd, f"{b}.norm2"), "mlp": _mlp(sd, f"{b}.mlp")})
    p["blocks"] = blocks
    p["neck"] = {
        "conv1": _conv(sd, f"{prefix}.neck.0", bias=False),
        "ln1": _ln(sd, f"{prefix}.neck.1"),
        "conv2": _conv(sd, f"{prefix}.neck.2", bias=False),
        "ln2": _ln(sd, f"{prefix}.neck.3"),
    }
    return p


def convert_sam_decoder(sd: Mapping[str, np.ndarray], depth: int = 2, num_mask_tokens: int = 4,
                        prefix="mask_decoder") -> Params:
    t = f"{prefix}.transformer"
    layers = []
    for i in range(depth):
        lp = f"{t}.layers.{i}"
        layers.append({
            "self_attn": _attn_qkv(sd, f"{lp}.self_attn"),
            "norm1": _ln(sd, f"{lp}.norm1"),
            "cross_attn_t2i": _attn_qkv(sd, f"{lp}.cross_attn_token_to_image"),
            "norm2": _ln(sd, f"{lp}.norm2"),
            "mlp": _mlp(sd, f"{lp}.mlp"),
            "norm3": _ln(sd, f"{lp}.norm3"),
            "norm4": _ln(sd, f"{lp}.norm4"),
            "cross_attn_i2t": _attn_qkv(sd, f"{lp}.cross_attn_image_to_token"),
        })
    return {
        "iou_token": sd[f"{prefix}.iou_token.weight"].copy(),
        "mask_tokens": sd[f"{prefix}.mask_tokens.weight"].copy(),
        "transformer": {
            "layers": layers,
            "final_attn_t2i": _attn_qkv(sd, f"{t}.final_attn_token_to_image"),
            "norm_final": _ln(sd, f"{t}.norm_final_attn"),
        },
        "output_upscaling": {
            "convt1": _convT(sd, f"{prefix}.output_upscaling.0"),
            "ln": _ln(sd, f"{prefix}.output_upscaling.1"),
            "convt2": _convT(sd, f"{prefix}.output_upscaling.3"),
        },
        "output_hypernetworks_mlps": [
            _mlp_stack(sd, f"{prefix}.output_hypernetworks_mlps.{i}", 3)
            for i in range(num_mask_tokens)
        ],
        "iou_prediction_head": _mlp_stack(sd, f"{prefix}.iou_prediction_head", 3),
    }


# ---------------------------------------------------------------------------
# SigLIP (open_clip .bin, HF)
# ---------------------------------------------------------------------------


def convert_siglip_vision(sd: Mapping[str, np.ndarray], depth: int,
                          prefix="visual.trunk") -> Params:
    p: Params = {
        "patch_embed": _patchify(sd, f"{prefix}.patch_embed.proj"),
        "pos_embed": sd[f"{prefix}.pos_embed"].copy(),
        "norm": _ln(sd, f"{prefix}.norm"),
        "blocks": [],
    }
    for i in range(depth):
        b = f"{prefix}.blocks.{i}"
        p["blocks"].append({
            "norm1": _ln(sd, f"{b}.norm1"),
            "attn": {"qkv": _lin(sd, f"{b}.attn.qkv"), "proj": _lin(sd, f"{b}.attn.proj")},
            "norm2": _ln(sd, f"{b}.norm2"),
            "mlp": _mlp(sd, f"{b}.mlp", names=("fc1", "fc2")),
        })
    ap = f"{prefix}.attn_pool"
    p["attn_pool"] = {
        "latent": sd[f"{ap}.latent"].copy(),
        "q": _lin(sd, f"{ap}.q"),
        "kv": _lin(sd, f"{ap}.kv"),
        "proj": _lin(sd, f"{ap}.proj"),
        "norm": _ln(sd, f"{ap}.norm"),
        "mlp": _mlp(sd, f"{ap}.mlp", names=("fc1", "fc2")),
    }
    return p


def convert_siglip_text(sd: Mapping[str, np.ndarray], depth: int, prefix="text") -> Params:
    p: Params = {
        "token_embedding": sd[f"{prefix}.token_embedding.weight"].copy(),
        "positional_embedding": sd[f"{prefix}.positional_embedding"].copy(),
        "ln_final": _ln(sd, f"{prefix}.ln_final"),
        "text_projection": _lin(sd, f"{prefix}.text_projection"),
        "blocks": [],
    }
    for i in range(depth):
        b = f"{prefix}.transformer.resblocks.{i}"
        p["blocks"].append({
            "norm1": _ln(sd, f"{b}.ln_1"),
            "attn": {
                "qkv": {"w": sd[f"{b}.attn.in_proj_weight"].T.copy(),
                        "b": sd[f"{b}.attn.in_proj_bias"].copy()},
                "proj": _lin(sd, f"{b}.attn.out_proj"),
            },
            "norm2": _ln(sd, f"{b}.ln_2"),
            "mlp": _mlp(sd, f"{b}.mlp", names=("c_fc", "c_proj")),
        })
    return p


def convert_siglip_hf(sd: Mapping[str, np.ndarray], vision_depth: int, text_depth: int) -> Params:
    """The HF-transformers SiglipModel dialect: vision_model.embeddings.
    {patch_embedding, position_embedding}, vision_model.encoder.layers.{i}.
    {layer_norm1, self_attn.{q,k,v,out}_proj, layer_norm2, mlp.{fc1,fc2}},
    vision_model.post_layernorm, vision_model.head (the MAP pool: probe,
    attention, layernorm, mlp); text_model.* likewise with final_layer_norm
    and head (the projection)."""

    def block(prefix):
        # HF keeps q/k/v apart: fused into the qkv layout
        names = ("q_proj", "k_proj", "v_proj")
        return {
            "norm1": _ln(sd, f"{prefix}.layer_norm1"),
            "attn": {
                "qkv": {
                    "w": np.concatenate([sd[f"{prefix}.self_attn.{n}.weight"] for n in names],
                                        axis=0).T.copy(),
                    "b": np.concatenate([sd[f"{prefix}.self_attn.{n}.bias"]
                                         for n in names]).copy(),
                },
                "proj": _lin(sd, f"{prefix}.self_attn.out_proj"),
            },
            "norm2": _ln(sd, f"{prefix}.layer_norm2"),
            "mlp": _mlp(sd, f"{prefix}.mlp", names=("fc1", "fc2")),
        }

    v = "vision_model"
    width = sd[f"{v}.head.probe"].shape[-1]
    in_w, in_b = sd[f"{v}.head.attention.in_proj_weight"], sd[f"{v}.head.attention.in_proj_bias"]
    visual: Params = {
        "patch_embed": _patchify(sd, f"{v}.embeddings.patch_embedding"),
        "pos_embed": sd[f"{v}.embeddings.position_embedding.weight"][None].copy(),
        "blocks": [block(f"{v}.encoder.layers.{i}") for i in range(vision_depth)],
        "norm": _ln(sd, f"{v}.post_layernorm"),
        "attn_pool": {
            "latent": sd[f"{v}.head.probe"].copy(),
            # the HF MAP head is a MultiheadAttention with a fused in-proj
            "q": {"w": in_w[:width].T.copy(), "b": in_b[:width].copy()},
            "kv": {"w": in_w[width:].T.copy(), "b": in_b[width:].copy()},
            "proj": _lin(sd, f"{v}.head.attention.out_proj"),
            "norm": _ln(sd, f"{v}.head.layernorm"),
            "mlp": _mlp(sd, f"{v}.head.mlp", names=("fc1", "fc2")),
        },
    }
    t = "text_model"
    text: Params = {
        "token_embedding": sd[f"{t}.embeddings.token_embedding.weight"].copy(),
        "positional_embedding": sd[f"{t}.embeddings.position_embedding.weight"].copy(),
        "blocks": [block(f"{t}.encoder.layers.{i}") for i in range(text_depth)],
        "ln_final": _ln(sd, f"{t}.final_layer_norm"),
        "text_projection": _lin(sd, f"{t}.head"),
    }
    return {"visual": visual, "text": text}


# ---------------------------------------------------------------------------
# trained CORE checkpoint (the whole composite, reference naming)
# ---------------------------------------------------------------------------


def convert_mask_adapter(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    def cnext(b):
        p = {"dwconv": _conv(sd, f"{b}.dwconv"), "norm": _ln(sd, f"{b}.norm"),
             "pwconv1": _lin(sd, f"{b}.pwconv1"), "pwconv2": _lin(sd, f"{b}.pwconv2")}
        if f"{b}.gamma" in sd:
            p["gamma"] = sd[f"{b}.gamma"].copy()
        return p

    g = f"{prefix}.get_mask_map"
    return {
        "channel_reduction": {
            "conv": _conv(sd, f"{prefix}.channel_clip_to_maskadapter.conv"),
            "norm": _ln(sd, f"{prefix}.channel_clip_to_maskadapter.norm"),
        },
        "mask_downscaling": {
            "conv1": _conv(sd, f"{g}.mask_downscaling.0"),
            "ln1": _ln(sd, f"{g}.mask_downscaling.1"),
            "conv2": _conv(sd, f"{g}.mask_downscaling.3"),
            "ln2": _ln(sd, f"{g}.mask_downscaling.4"),
            "conv3": _conv(sd, f"{g}.mask_downscaling.6"),
        },
        "fuse": _conv(sd, f"{g}.fuse"),
        "cnext1": cnext(f"{g}.cnext1"),
        "cnext2": cnext(f"{g}.cnext2"),
        "cnext3": cnext(f"{g}.cnext3"),
        "norm": _ln(sd, f"{g}.norm"),
        "final": _conv(sd, f"{g}.final"),
    }


def convert_cir_fuse(sd: Mapping[str, np.ndarray], prefix: str) -> Params:
    def gate(name):
        return {"lin1": _lin(sd, f"{prefix}.{name}.0"), "lin2": _lin(sd, f"{prefix}.{name}.3")}

    return {"atten_image": gate("atten_Image"), "atten_text": gate("atten_Text"),
            "dynamic_scalar": gate("dynamic_scalar")}


def convert_core_checkpoint(sd: Mapping[str, np.ndarray], encoder_depth: int,
                            siglip_vision_depth: int, siglip_text_depth: int,
                            mask_pooling: str = "MaskAdapterPooling") -> Params:
    """A trained CORE state dict -> a ``cor_tpu`` tree of the whole model."""
    sd = strip_ddp_prefix(sd)
    sb = "support_branch"
    support: Params = {
        "siglip": {
            "visual": convert_siglip_vision(sd, siglip_vision_depth,
                                            prefix=f"{sb}.siglip.model.visual.trunk"),
            "text": convert_siglip_text(sd, siglip_text_depth, prefix=f"{sb}.siglip.model.text"),
        },
        "cir_fuse": convert_cir_fuse(sd, f"{sb}.cir_fuse"),
        "ln_channel_first": _ln(sd, f"{sb}.ln_channel_first"),
        "ln_channel_last": _ln(sd, f"{sb}.ln_channel_last"),
        "dim_proj": {"lin1": _lin(sd, f"{sb}.dim_proj.0"), "lin2": _lin(sd, f"{sb}.dim_proj.3")},
    }
    if mask_pooling == "MaskAdapterPooling":
        support["mask_pooling"] = convert_mask_adapter(sd, f"{sb}.mask_pooling")
    return {
        "image_encoder": convert_sam_encoder(sd, encoder_depth),
        "support_branch": support,
        "prompt_encoder": {
            "pe_layer": {"gaussian_matrix": sd[
                "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"].copy()},
            "no_mask_embed": sd["prompt_encoder.no_mask_embed.weight"].copy(),
        },
        "mask_decoder": convert_sam_decoder(sd),
    }


# ---------------------------------------------------------------------------
# loading into the port's modules
# ---------------------------------------------------------------------------


def as_parts(parts: Parts) -> Dict[str, nn.Module]:
    """``parts`` as {subtree name: module}."""
    return dict(parts.named_children()) if isinstance(parts, nn.Module) else dict(parts)


def expected_tree(parts: Parts) -> Params:
    """The parts' leaves as a ``cor_tpu`` tree of shapes only (zero-stride
    arrays of the ``cor_tpu`` layouts' shapes): ``audit_params``' template
    without a copy of any weight."""
    out: Params = {}
    for part, module in as_parts(parts).items():
        node = out.setdefault(part, {})
        for name, t in _leaves(module).items():
            shape = to_cor_tpu_layout(module, name,
                                      np.broadcast_to(np.zeros((), np.uint8), t.shape)).shape
            *path, leaf = name.split(".")
            d = node
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = np.broadcast_to(np.zeros((), np.uint8), shape)
    return out


def load_tree(parts: Parts, tree: Params) -> Dict[str, nn.Module]:
    """Load each part present in both ``parts`` and the ``cor_tpu`` tree
    through the weight bridge (in place)."""
    parts = as_parts(parts)
    for name, module in parts.items():
        if name in tree:
            load_cor_tpu_params(module, tree[name])
    return parts


def load_sam_weights(parts: Parts, sam_ckpt_path, depth: int) -> Dict[str, nn.Module]:
    """The SAM ``.pth``'s image encoder and mask decoder into those parts,
    with the reference's semantics: the prompt encoder is not loaded, so its
    ``no_mask_embed`` keeps its init."""
    sd = strip_ddp_prefix(load_torch_state_dict(sam_ckpt_path))
    return load_tree(parts, {"image_encoder": convert_sam_encoder(sd, depth),
                             "mask_decoder": convert_sam_decoder(sd)})


def load_siglip_weights(parts: Parts, siglip_ckpt_path, vision_depth: int,
                        text_depth: int) -> Dict[str, nn.Module]:
    """The open_clip SigLIP ``.bin``'s towers into the support branch's
    ``siglip`` (when the support branch is one of the parts)."""
    parts = as_parts(parts)
    if "support_branch" in parts:
        sd = strip_ddp_prefix(load_torch_state_dict(siglip_ckpt_path))
        load_cor_tpu_params(parts["support_branch"].siglip,
                            {"visual": convert_siglip_vision(sd, vision_depth),
                             "text": convert_siglip_text(sd, text_depth)})
    return parts


def is_port_checkpoint(path) -> bool:
    """A checkpoint directory written by ``train/checkpoint.py``."""
    return (Path(path) / STATE_FILE).is_file()


def load_trained_params(load_checkpoint_path, core_cfg, parts: Parts, logger,
                        mask_pooling: str = "MaskAdapterPooling") -> Dict[str, nn.Module]:
    """Trained CORE weights into ``parts``: the one loader of every
    inference entry point, so a trained checkpoint is never silently left
    out.

    - a ``.pth``/``.pt``/``.bin`` file: the reference's trained CORE state
      dict (DDP prefixes stripped), converted, audited against the parts
      (missing / unexpected / mismatched, logged) and loaded;
    - a checkpoint directory of the port (``state.pt``: ``best_model``,
      ``checkpoint_epoch_N``, ...): its ``params`` (the model's state dict),
      each part's keys loaded strictly;
    - an Orbax checkpoint directory of ``cor_tpu`` (``best_model``, a full
      training state): its ``params`` subtree, audited as a ``.pth`` and
      loaded through the weight bridge (``utils/orbax.read_params``; without
      ``tensorstore`` it is refused, naming the package);
    - anything else is refused."""
    ckpt = Path(str(load_checkpoint_path))
    parts = as_parts(parts)
    if ckpt.suffix in TORCH_SUFFIXES and ckpt.is_file():
        sig = core_cfg.support.siglip
        loaded = convert_core_checkpoint(
            load_torch_state_dict(ckpt), encoder_depth=core_cfg.encoder.depth,
            siglip_vision_depth=sig.vision.depth, siglip_text_depth=sig.text.depth,
            mask_pooling=mask_pooling)
        loaded = {k: v for k, v in loaded.items() if k in parts}
        for kind, keys in audit_params(expected_tree(parts), loaded).items():
            if keys:
                logger.info(f"[ckpt audit] {kind} ({len(keys)}): {keys[:10]}")
        load_tree(parts, loaded)
        logger.info(f"Loaded torch CORE checkpoint: {ckpt}")
        return parts
    if not ckpt.exists():
        raise FileNotFoundError(f"load_checkpoint_path={str(ckpt)!r} not found")
    if is_orbax_checkpoint(ckpt):
        loaded = {k: v for k, v in read_params(ckpt).items() if k in parts}
        for kind, keys in audit_params(expected_tree(parts), loaded).items():
            if keys:
                logger.info(f"[ckpt audit] {kind} ({len(keys)}): {keys[:10]}")
        load_tree(parts, loaded)
        logger.info(f"Loaded Orbax checkpoint: {ckpt}")
        return parts
    if not ckpt.is_dir() or not is_port_checkpoint(ckpt):
        raise ValueError(
            f"load_checkpoint_path={str(ckpt)!r} is neither a torch checkpoint "
            f"({'/'.join(TORCH_SUFFIXES)}), a cor_tpu_torch checkpoint directory (with "
            f"{STATE_FILE}) nor an Orbax checkpoint directory")
    params = restore_checkpoint(ckpt.parent, ckpt.name)["params"]
    for name, module in parts.items():
        module.load_state_dict({k[len(name) + 1:]: v for k, v in params.items()
                                if k.startswith(f"{name}.")})
    logger.info(f"Loaded cor_tpu_torch checkpoint: {ckpt}")
    return parts


def load_configured_weights(cfg, core_cfg, parts: Parts, logger,
                            trained: bool = True) -> Dict[str, nn.Module]:
    """What a config's checkpoint keys name, into ``parts``, in ``cor_tpu``'s
    order: ``load_sam_pretrained_checkpoint``,
    ``load_siglip_pretrained_checkpoint``, then (``trained``)
    ``load_checkpoint_path``."""
    parts = as_parts(parts)
    if cfg.load_sam_pretrained_checkpoint:
        load_sam_weights(parts, cfg.load_sam_pretrained_checkpoint, core_cfg.encoder.depth)
        logger.info(f"Loaded SAM weights: {cfg.load_sam_pretrained_checkpoint}")
    if cfg.load_siglip_pretrained_checkpoint:
        sig = core_cfg.support.siglip
        load_siglip_weights(parts, cfg.load_siglip_pretrained_checkpoint, sig.vision.depth,
                            sig.text.depth)
        logger.info(f"Loaded SigLIP weights: {cfg.load_siglip_pretrained_checkpoint}")
    if trained and cfg.load_checkpoint_path:
        load_trained_params(cfg.load_checkpoint_path, core_cfg, parts, logger, cfg.mask_pooling)
    return parts
