"""The gallery build, query encoding, candidate-mask decoding and the
gallery-index artifact, the PyTorch counterpart of ``cor_tpu.retrieval.index``.

A gallery candidate (image, object mask) is embedded by mask-pooling its SAM
image embedding over the mask and L2-normalising it (``build_gallery``); a
query by the support branch. Retrieval is the cosine top-k between the two.

The artifact format is ``cor_tpu``'s (version 1): a directory holding
``embeddings.npy`` (fp32 [G, D]), ``pair_ids.npy`` (int64 [G]), optionally
``store.npy`` (fp16 SAM image embeddings, memory-mapped on load) and
``meta.json``. An index written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from cor_tpu_torch.models.core_model import CoreConfig, DecodeModel, select_mask
from cor_tpu_torch.models.prompt_encoder import get_dense_pe, prompt_encoder_dense
from cor_tpu_torch.models.sam_decoder import mask_decoder
from cor_tpu_torch.models.sam_encoder import SamEncoder
from cor_tpu_torch.train.losses import mask_pool_normalized

INDEX_VERSION = 1


def make_candidate_encoder(cfg: CoreConfig):
    """Returns encode(model, images [B, S, S, 3], masks [B, S, S, 1]) ->
    (embeddings [B, C] fp32, L2-normed; image embeddings [B, g, g, C] fp32).

    ``model`` is a ``SamEncoder`` already cast to ``cfg.dtype``; the images
    are cast to it here."""

    @torch.inference_mode()
    def encode(model: SamEncoder, images, masks):
        emb = model(images.to(cfg.dtype))
        return mask_pool_normalized(emb, masks), emb.float()

    return encode


def build_gallery(
    cfg: CoreConfig,
    model: SamEncoder,
    batches: Iterable[Dict[str, np.ndarray]],
    with_store: bool = False,
    store_dtype=np.float16,
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """One pass over candidate batches ({"query_img", "query_mask",
    "pair_id"}, numpy) -> (embeddings [G, D], pair_ids [G], store
    [G, g, g, C] or None), on the model's device. The image embeddings come
    back as fp32 and are kept as ``store_dtype`` (fp16 halves the artifact;
    the decode path computes in the compute dtype)."""
    encode = make_candidate_encoder(cfg)
    device = next(model.parameters()).device
    embs, ids, stores = [], [], []
    for b in batches:
        e, ie = encode(model, torch.from_numpy(b["query_img"]).to(device),
                       torch.from_numpy(b["query_mask"]).to(device))
        embs.append(e.cpu().numpy())
        ids.append(np.asarray(b["pair_id"]))
        if with_store:
            stores.append(ie.cpu().numpy().astype(store_dtype))
    return (
        np.concatenate(embs, axis=0),
        np.concatenate(ids, axis=0),
        np.concatenate(stores, axis=0) if with_store else None,
    )


def make_query_encoder(cfg: CoreConfig):
    """Returns encode(model, support_img, text, support_mask) -> [B, D] fp32
    L2-normed queries in the retrieval space (the support feature).

    ``model`` is a ``SupportBranch`` already cast to ``cfg.dtype`` (see
    ``core_model._cast``); images and masks are cast to it here."""

    @torch.inference_mode()
    def encode(model, support_img, text, support_mask):
        feat = model(
            support_img.to(cfg.dtype), text, support_mask.to(cfg.dtype), train=False
        )
        return feat[:, 0, :].float()

    return encode


def make_candidate_mask_decoder(cfg: CoreConfig):
    """Returns decode(model, cand_embeddings [B, g, g, C], query_feats [B, D])
    -> mask logits [B, 1, 4g, 4g] fp32: segment each retrieved candidate
    conditioned on its composed query. ``model`` is a ``DecodeModel`` cast to
    ``cfg.dtype``; the embeddings are cast to it here and the dense no-mask
    prompt is added in the compute dtype."""

    @torch.inference_mode()
    def decode(model: DecodeModel, cand_embeddings, query_feats):
        pe = model.prompt_encoder
        dense_e = prompt_encoder_dense(pe, cand_embeddings.shape[0]).to(cfg.dtype)
        image_pe = get_dense_pe(pe).to(cfg.dtype)
        masks, iou, _ = mask_decoder(
            model.mask_decoder, cand_embeddings.to(cfg.dtype), image_pe,
            query_feats[:, None, :].to(cfg.dtype), dense_e, cfg.multimask_output,
        )
        return select_mask(cfg, masks, iou)

    return decode


def make_store_indexed_mask_decoder(cfg: CoreConfig):
    """Returns decode(model, store_q int8 [S, g, g, C], scales fp32 [S],
    idx int32 [B], query_feats [B, D]) -> mask logits [B, 1, 4g, 4g] fp32.

    The first two-way layer reads ``store_q[idx[b]]`` itself and dequantises
    it inside the kernel: no gather and no host round trip. The store must
    carry the dense no-mask prompt pre-baked
    (``engine.quantize_candidate_store_host`` with ``no_mask_embed``)."""

    @torch.inference_mode()
    def decode(model: DecodeModel, store_q, scales, idx, query_feats):
        image_pe = get_dense_pe(model.prompt_encoder).to(cfg.dtype)
        masks, iou, _ = mask_decoder(
            model.mask_decoder, store_q, image_pe, query_feats[:, None, :].to(cfg.dtype),
            None, cfg.multimask_output, store_idx=idx, store_scale=scales,
        )
        return select_mask(cfg, masks, iou)

    return decode


def save_gallery_index(
    path,
    embeddings: np.ndarray,  # [G, D] fp32, L2-normed rows
    pair_ids: np.ndarray,  # [G]
    image_embeddings: Optional[np.ndarray] = None,  # [G, g, g, C]
) -> None:
    """Write the artifact directory (cor_tpu ``save_gallery_index``)."""
    d = Path(path)
    d.mkdir(parents=True, exist_ok=True)
    np.save(d / "embeddings.npy", np.ascontiguousarray(embeddings, np.float32))
    np.save(d / "pair_ids.npy", np.ascontiguousarray(pair_ids, np.int64))
    meta = {
        "version": INDEX_VERSION,
        "rows": int(embeddings.shape[0]),
        "dim": int(embeddings.shape[1]),
        "has_store": image_embeddings is not None,
    }
    if image_embeddings is not None:
        np.save(d / "store.npy", np.ascontiguousarray(image_embeddings, np.float16))
        meta["store_shape"] = [int(s) for s in image_embeddings.shape]
    (d / "meta.json").write_text(json.dumps(meta))


def load_gallery_index(path) -> Dict[str, np.ndarray]:
    """Load an artifact: {"embeddings", "pair_ids", "store" (mmap or None)}.
    Fails on a directory that is not an artifact of this version."""
    d = Path(path)
    meta_p = d / "meta.json"
    if not meta_p.exists():
        raise FileNotFoundError(f"gallery index {d} has no meta.json — not an index artifact")
    meta = json.loads(meta_p.read_text())
    if meta.get("version") != INDEX_VERSION:
        raise ValueError(f"gallery index version {meta.get('version')} != {INDEX_VERSION}")
    out = {
        "embeddings": np.load(d / "embeddings.npy"),
        "pair_ids": np.load(d / "pair_ids.npy"),
        "store": None,
    }
    if meta.get("has_store"):
        out["store"] = np.load(d / "store.npy", mmap_mode="r")
    if out["embeddings"].shape[0] != meta["rows"]:
        raise ValueError("gallery index corrupt: row count mismatch with meta.json")
    return out
