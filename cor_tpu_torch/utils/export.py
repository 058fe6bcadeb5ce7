"""Checkpoint export: ``cor_tpu`` trees (or the port's modules) ->
reference torch state dicts. The port's own copy of ``cor_tpu.utils.export``.

The exact inverse of ``utils/convert.convert_core_checkpoint``: a model
trained by the port goes back to the reference's ecosystem, whose eval
entry reads ``model_state_dict`` with a missing/unexpected/mismatch audit
(``save_core_checkpoint`` writes that dict format). A module is read
through ``utils/weights.to_cor_tpu_tree`` (fp32 copies in ``cor_tpu``'s
layouts), so the bridge's one table of layouts serves both directions.

Layouts (torch <- cor_tpu), the inverses of convert.py's:
- Linear weight [in, out]            -> [out, in]
- Conv2d kernel [kh, kw, I, O]       -> [O, I, kh, kw]
- ConvTranspose2d kernel [I,kh,kw,O] -> [I, O, kh, kw]
- patchify GEMM [(p*p*C), D]         -> [D, C, p, p]  (unfold order row, col, ch)

``export_sam_state_dict`` and ``export_siglip_state_dict`` write the stock
SAM ``.pth`` and open_clip SigLIP ``.bin`` namings that
``convert.load_sam_weights`` and ``load_siglip_weights`` read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

Params = Dict[str, Any]
StateDict = Dict[str, np.ndarray]


def _tree(params) -> Params:
    """A ``cor_tpu`` tree as it is, or a module's through the bridge."""
    if isinstance(params, nn.Module):
        from cor_tpu_torch.utils.weights import to_cor_tpu_tree

        return to_cor_tpu_tree(params)
    return params


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# layout helpers (inverses of convert.py's _lin/_conv/_convT/_ln/_patchify)
# ---------------------------------------------------------------------------


def _lin(out: StateDict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).T.copy()
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"]).copy()


def _conv(out: StateDict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).transpose(3, 2, 0, 1).copy()
    if "b" in p:
        out[f"{prefix}.bias"] = _np(p["b"]).copy()


def _convT(out: StateDict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["w"]).transpose(0, 3, 1, 2).copy()
    out[f"{prefix}.bias"] = _np(p["b"]).copy()


def _ln(out: StateDict, prefix: str, p: Params) -> None:
    out[f"{prefix}.weight"] = _np(p["scale"]).copy()
    out[f"{prefix}.bias"] = _np(p["bias"]).copy()


def _patchify(out: StateDict, prefix: str, p: Params, in_chans: int = 3) -> None:
    w = _np(p["w"])  # [(p*p*C), D], unfold order (row, col, channel)
    d = w.shape[1]
    patch = int(round((w.shape[0] // in_chans) ** 0.5))
    if patch * patch * in_chans != w.shape[0]:
        raise ValueError(f"patchify kernel {w.shape} is not a square {in_chans}-channel patch")
    out[f"{prefix}.weight"] = (
        w.reshape(patch, patch, in_chans, d).transpose(3, 2, 0, 1).copy()
    )
    out[f"{prefix}.bias"] = _np(p["b"]).copy()


def _mlp(out: StateDict, prefix: str, p: Params, names=("lin1", "lin2")) -> None:
    _lin(out, f"{prefix}.{names[0]}", p["lin1"])
    _lin(out, f"{prefix}.{names[1]}", p["lin2"])


def _attn_qkv(out: StateDict, prefix: str, p: Params) -> None:
    _lin(out, f"{prefix}.q_proj", p["q_proj"])
    _lin(out, f"{prefix}.k_proj", p["k_proj"])
    _lin(out, f"{prefix}.v_proj", p["v_proj"])
    _lin(out, f"{prefix}.out_proj", p["out_proj"])


def _mlp_stack(out: StateDict, prefix: str, p: Params) -> None:
    for j, layer in enumerate(p["layers"]):
        _lin(out, f"{prefix}.layers.{j}", layer)


# ---------------------------------------------------------------------------
# SAM encoder + decoder
# ---------------------------------------------------------------------------


def export_sam_encoder(p: Params, prefix: str = "image_encoder") -> StateDict:
    out: StateDict = {}
    _patchify(out, f"{prefix}.patch_embed.proj", p["patch_embed"])
    if "pos_embed" in p:
        out[f"{prefix}.pos_embed"] = _np(p["pos_embed"]).copy()  # already [1,g,g,D]
    for i, blk in enumerate(p["blocks"]):
        b = f"{prefix}.blocks.{i}"
        _ln(out, f"{b}.norm1", blk["norm1"])
        _lin(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _lin(out, f"{b}.attn.proj", blk["attn"]["proj"])
        if "rel_pos_h" in blk["attn"]:
            out[f"{b}.attn.rel_pos_h"] = _np(blk["attn"]["rel_pos_h"]).copy()
            out[f"{b}.attn.rel_pos_w"] = _np(blk["attn"]["rel_pos_w"]).copy()
        _ln(out, f"{b}.norm2", blk["norm2"])
        _mlp(out, f"{b}.mlp", blk["mlp"])
    _conv(out, f"{prefix}.neck.0", p["neck"]["conv1"])
    _ln(out, f"{prefix}.neck.1", p["neck"]["ln1"])
    _conv(out, f"{prefix}.neck.2", p["neck"]["conv2"])
    _ln(out, f"{prefix}.neck.3", p["neck"]["ln2"])
    return out


def export_sam_decoder(p: Params, prefix: str = "mask_decoder") -> StateDict:
    out: StateDict = {
        f"{prefix}.iou_token.weight": _np(p["iou_token"]).copy(),
        f"{prefix}.mask_tokens.weight": _np(p["mask_tokens"]).copy(),
    }
    t = f"{prefix}.transformer"
    for i, layer in enumerate(p["transformer"]["layers"]):
        l = f"{t}.layers.{i}"
        _attn_qkv(out, f"{l}.self_attn", layer["self_attn"])
        _ln(out, f"{l}.norm1", layer["norm1"])
        _attn_qkv(out, f"{l}.cross_attn_token_to_image", layer["cross_attn_t2i"])
        _ln(out, f"{l}.norm2", layer["norm2"])
        _mlp(out, f"{l}.mlp", layer["mlp"])
        _ln(out, f"{l}.norm3", layer["norm3"])
        _ln(out, f"{l}.norm4", layer["norm4"])
        _attn_qkv(out, f"{l}.cross_attn_image_to_token", layer["cross_attn_i2t"])
    _attn_qkv(out, f"{t}.final_attn_token_to_image", p["transformer"]["final_attn_t2i"])
    _ln(out, f"{t}.norm_final_attn", p["transformer"]["norm_final"])
    _convT(out, f"{prefix}.output_upscaling.0", p["output_upscaling"]["convt1"])
    _ln(out, f"{prefix}.output_upscaling.1", p["output_upscaling"]["ln"])
    _convT(out, f"{prefix}.output_upscaling.3", p["output_upscaling"]["convt2"])
    for i, mlp in enumerate(p["output_hypernetworks_mlps"]):
        _mlp_stack(out, f"{prefix}.output_hypernetworks_mlps.{i}", mlp)
    _mlp_stack(out, f"{prefix}.iou_prediction_head", p["iou_prediction_head"])
    return out


# ---------------------------------------------------------------------------
# SigLIP towers (open_clip naming, as embedded in a trained CORE checkpoint)
# ---------------------------------------------------------------------------


def export_siglip_vision(p: Params, prefix: str = "visual.trunk") -> StateDict:
    out: StateDict = {}
    _patchify(out, f"{prefix}.patch_embed.proj", p["patch_embed"])
    out[f"{prefix}.pos_embed"] = _np(p["pos_embed"]).copy()
    _ln(out, f"{prefix}.norm", p["norm"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{prefix}.blocks.{i}"
        _ln(out, f"{b}.norm1", blk["norm1"])
        _lin(out, f"{b}.attn.qkv", blk["attn"]["qkv"])
        _lin(out, f"{b}.attn.proj", blk["attn"]["proj"])
        _ln(out, f"{b}.norm2", blk["norm2"])
        _mlp(out, f"{b}.mlp", blk["mlp"], names=("fc1", "fc2"))
    ap, pool = f"{prefix}.attn_pool", p["attn_pool"]
    out[f"{ap}.latent"] = _np(pool["latent"]).copy()
    _lin(out, f"{ap}.q", pool["q"])
    _lin(out, f"{ap}.kv", pool["kv"])
    _lin(out, f"{ap}.proj", pool["proj"])
    _ln(out, f"{ap}.norm", pool["norm"])
    _mlp(out, f"{ap}.mlp", pool["mlp"], names=("fc1", "fc2"))
    return out


def export_siglip_text(p: Params, prefix: str = "text") -> StateDict:
    out: StateDict = {
        f"{prefix}.token_embedding.weight": _np(p["token_embedding"]).copy(),
        f"{prefix}.positional_embedding": _np(p["positional_embedding"]).copy(),
    }
    _ln(out, f"{prefix}.ln_final", p["ln_final"])
    _lin(out, f"{prefix}.text_projection", p["text_projection"])
    for i, blk in enumerate(p["blocks"]):
        b = f"{prefix}.transformer.resblocks.{i}"
        _ln(out, f"{b}.ln_1", blk["norm1"])
        out[f"{b}.attn.in_proj_weight"] = _np(blk["attn"]["qkv"]["w"]).T.copy()
        out[f"{b}.attn.in_proj_bias"] = _np(blk["attn"]["qkv"]["b"]).copy()
        _lin(out, f"{b}.attn.out_proj", blk["attn"]["proj"])
        _ln(out, f"{b}.ln_2", blk["norm2"])
        _mlp(out, f"{b}.mlp", blk["mlp"], names=("c_fc", "c_proj"))
    return out


# ---------------------------------------------------------------------------
# support branch (mask adapter + fusion + projections)
# ---------------------------------------------------------------------------


def export_mask_adapter(p: Params, prefix: str) -> StateDict:
    out: StateDict = {}

    def cnext(b: str, q: Params) -> None:
        _conv(out, f"{b}.dwconv", q["dwconv"])
        _ln(out, f"{b}.norm", q["norm"])
        _lin(out, f"{b}.pwconv1", q["pwconv1"])
        _lin(out, f"{b}.pwconv2", q["pwconv2"])
        if "gamma" in q:
            out[f"{b}.gamma"] = _np(q["gamma"]).copy()

    _conv(out, f"{prefix}.channel_clip_to_maskadapter.conv", p["channel_reduction"]["conv"])
    _ln(out, f"{prefix}.channel_clip_to_maskadapter.norm", p["channel_reduction"]["norm"])
    g = f"{prefix}.get_mask_map"
    _conv(out, f"{g}.mask_downscaling.0", p["mask_downscaling"]["conv1"])
    _ln(out, f"{g}.mask_downscaling.1", p["mask_downscaling"]["ln1"])
    _conv(out, f"{g}.mask_downscaling.3", p["mask_downscaling"]["conv2"])
    _ln(out, f"{g}.mask_downscaling.4", p["mask_downscaling"]["ln2"])
    _conv(out, f"{g}.mask_downscaling.6", p["mask_downscaling"]["conv3"])
    _conv(out, f"{g}.fuse", p["fuse"])
    cnext(f"{g}.cnext1", p["cnext1"])
    cnext(f"{g}.cnext2", p["cnext2"])
    cnext(f"{g}.cnext3", p["cnext3"])
    _ln(out, f"{g}.norm", p["norm"])
    _conv(out, f"{g}.final", p["final"])
    return out


def export_cir_fuse(p: Params, prefix: str) -> StateDict:
    out: StateDict = {}
    for ours, theirs in (
        ("atten_image", "atten_Image"),
        ("atten_text", "atten_Text"),
        ("dynamic_scalar", "dynamic_scalar"),
    ):
        _lin(out, f"{prefix}.{theirs}.0", p[ours]["lin1"])
        _lin(out, f"{prefix}.{theirs}.3", p[ours]["lin2"])
    return out


# ---------------------------------------------------------------------------
# full composite
# ---------------------------------------------------------------------------


def export_core_state_dict(params) -> StateDict:
    """A ``cor_tpu`` tree of the whole model (or the port's ``CoreModel``,
    read through ``to_cor_tpu_tree``) -> the reference composite's state
    dict naming (the exact inverse of ``convert.convert_core_checkpoint``)."""
    params = _tree(params)
    out: StateDict = {}
    out.update(export_sam_encoder(params["image_encoder"]))
    sb, sbp = params["support_branch"], "support_branch"
    out.update(export_siglip_vision(sb["siglip"]["visual"],
                                    prefix=f"{sbp}.siglip.model.visual.trunk"))
    out.update(export_siglip_text(sb["siglip"]["text"], prefix=f"{sbp}.siglip.model.text"))
    out.update(export_cir_fuse(sb["cir_fuse"], f"{sbp}.cir_fuse"))
    if "mask_pooling" in sb:  # MaskAdapterPooling; MaskedPooling is param-free
        out.update(export_mask_adapter(sb["mask_pooling"], f"{sbp}.mask_pooling"))
    _ln(out, f"{sbp}.ln_channel_first", sb["ln_channel_first"])
    _ln(out, f"{sbp}.ln_channel_last", sb["ln_channel_last"])
    _lin(out, f"{sbp}.dim_proj.0", sb["dim_proj"]["lin1"])
    _lin(out, f"{sbp}.dim_proj.3", sb["dim_proj"]["lin2"])
    pe = params["prompt_encoder"]
    out["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _np(
        pe["pe_layer"]["gaussian_matrix"]
    ).copy()
    out["prompt_encoder.no_mask_embed.weight"] = _np(pe["no_mask_embed"]).copy()
    out.update(export_sam_decoder(params["mask_decoder"]))
    return out


def save_core_checkpoint(
    path: str,
    params: Optional[Params] = None,
    epoch: int = 0,
    loss: Optional[float] = None,
    optimizer_state_dict: Optional[Mapping[str, Any]] = None,
    state_dict: Optional[StateDict] = None,
) -> None:
    """Write the reference trainer's checkpoint dict format
    (keys epoch / model_state_dict / optimizer_state_dict / loss), loadable by the
    reference's eval entry. Pass ``state_dict`` if it is already built
    (``export_core_state_dict`` copies every parameter into fp32 numpy:
    building it twice doubles the peak host memory at sam_huge)."""
    if state_dict is None:
        state_dict = export_core_state_dict(params)
    torch.save(
        {
            "epoch": int(epoch),
            "model_state_dict": {
                k: torch.from_numpy(v) for k, v in state_dict.items()
            },
            "optimizer_state_dict": dict(optimizer_state_dict) if optimizer_state_dict else {},
            "loss": float(loss) if loss is not None else None,
        },
        path,
    )


def export_sam_state_dict(params) -> StateDict:
    """The image encoder, the mask decoder and the prompt encoder's PE matrix
    and ``no_mask_embed`` in the stock SAM ``.pth`` naming (a tree or a
    ``CoreModel``)."""
    params = _tree(params)
    out = {**export_sam_encoder(params["image_encoder"]),
           **export_sam_decoder(params["mask_decoder"])}
    pe = params["prompt_encoder"]
    out["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = _np(
        pe["pe_layer"]["gaussian_matrix"]).copy()
    out["prompt_encoder.no_mask_embed.weight"] = _np(pe["no_mask_embed"]).copy()
    return out


def export_siglip_state_dict(siglip) -> StateDict:
    """The SigLIP towers (``{"visual": ..., "text": ...}``, or the port's
    ``SigLIP`` module) in the open_clip ``.bin`` naming."""
    siglip = _tree(siglip)
    return {**export_siglip_vision(siglip["visual"]), **export_siglip_text(siglip["text"])}


def save_state_dict(path, state_dict: StateDict) -> Path:
    """``torch.save`` of a bare state dict (the ``.pth`` / ``.bin`` dialects)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state_dict.items()},
               path)
    return path
