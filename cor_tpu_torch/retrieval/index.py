"""Query encoding and the gallery-index artifact, the PyTorch counterpart of
the retrieval-only part of ``cor_tpu.retrieval.index``.

The artifact format is ``cor_tpu``'s (version 1): a directory holding
``embeddings.npy`` (fp32 [G, D]), ``pair_ids.npy`` (int64 [G]), optionally
``store.npy`` (fp16 SAM image embeddings, memory-mapped on load) and
``meta.json``. An index written by either package loads in the other.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from cor_tpu_torch.models.core_model import CoreConfig

INDEX_VERSION = 1


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
