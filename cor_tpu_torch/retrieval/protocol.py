"""The Recall@K protocol over a triplet loader, the PyTorch counterpart of
``cor_tpu.retrieval.protocol``.

Every triplet contributes one gallery candidate, its (query image, query
mask), embedded by mask-pooling its SAM image embedding, and one query, its
(support image, support mask, change text), embedded by the support branch;
query i's target is gallery row i. Recall@K is the share of queries whose own
candidate is among their top K.

``rerank=True`` is the decode-reranked protocol: every query's top k are
mask-decoded out of an int8 store of the candidates' SAM image embeddings
and ranked by the decoder's predicted IoU (``RetrievalEngine.retrieve_decode``).
On one device the rerank reorders the cosine top k, so recall at the largest
K is the same with and without it.

Where ``cor_tpu`` takes a parameter tree and a mesh, the port takes its
modules on one device in the compute dtype (``prepare_models``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from cor_tpu_torch.models.core_model import CoreConfig, DecodeModel, _cast, check_kernel_dtype
from cor_tpu_torch.models.prompt_encoder import get_dense_pe
from cor_tpu_torch.models.sam_encoder import SamEncoder
from cor_tpu_torch.models.support_branch import SupportBranch
from cor_tpu_torch.retrieval.engine import (
    RetrievalEngine,
    quantize_candidate_store,
    recall_at_k,
)
from cor_tpu_torch.retrieval.index import make_candidate_encoder, make_query_encoder


@dataclass
class RetrievalModels:
    """What the protocol runs, on one device in the compute dtype. The
    image encoder is needed to encode a gallery, the decode model to rerank;
    ``no_mask_embed`` (fp32 [C]) is the decode model's no-mask prompt read
    before the cast, the one ``cor_tpu`` bakes into the int8 store."""

    image_encoder: Optional[SamEncoder]
    support_branch: SupportBranch
    decode_model: Optional[DecodeModel] = None
    no_mask_embed: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        return next(self.support_branch.parameters()).device


def prepare_models(
    cfg: CoreConfig,
    image_encoder: Optional[SamEncoder],
    support_branch: SupportBranch,
    decode_model: Optional[DecodeModel] = None,
    device="cuda",
) -> RetrievalModels:
    """Move fp32 modules to ``device`` and cast them in place to the
    config's compute dtype, keeping the no-mask prompt in fp32 first."""
    check_kernel_dtype(cfg, device)
    no_mask = None
    if decode_model is not None:
        no_mask = decode_model.prompt_encoder.no_mask_embed.detach().float().cpu().numpy()[0]
        decode_model = _cast(decode_model.to(device), cfg.dtype).eval()
    if image_encoder is not None:
        image_encoder = _cast(image_encoder.to(device), cfg.dtype).eval()
    branch = _cast(support_branch.to(device), cfg.dtype).eval()
    return RetrievalModels(image_encoder, branch, decode_model, no_mask)


def _on(device, *arrays):
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def encode_manifest(
    cfg: CoreConfig,
    models: RetrievalModels,
    batches: Iterable[Dict[str, np.ndarray]],
    keep_store: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[Tuple[np.ndarray, np.ndarray]]]:
    """One pass over the triplet loader -> (gallery [G, D], queries [G, D],
    pair_ids [G], store or None), row i of each from triplet i.
    ``keep_store`` also keeps every SAM image embedding as an int8 store
    ``(q [G, g, g, C], scales [G])`` with the no-mask prompt baked in,
    quantised on the device batch by batch, so that the full-precision store
    never exists on the host; it goes to ``enable_store_decode`` as it is."""
    if keep_store and models.no_mask_embed is None:
        raise ValueError("keep_store bakes the no-mask prompt into the store: prepare_models "
                         "needs the decode model")
    encode_cand = make_candidate_encoder(cfg)
    encode_query = make_query_encoder(cfg)
    dev = models.device
    gallery, queries, ids, store_qs, store_scales = [], [], [], [], []
    for b in batches:
        emb, ie = encode_cand(models.image_encoder, *_on(dev, b["query_img"], b["query_mask"]))
        if keep_store:
            q8, sc = quantize_candidate_store(ie, models.no_mask_embed)
            store_qs.append(q8.cpu().numpy())
            store_scales.append(sc.cpu().numpy())
        del ie
        q = encode_query(models.support_branch,
                         *_on(dev, b["support_img"], b["text"], b["support_mask"]))
        gallery.append(emb.cpu().numpy())
        queries.append(q.cpu().numpy())
        ids.append(np.asarray(b["pair_id"]))
    return (
        np.concatenate(gallery, axis=0),
        np.concatenate(queries, axis=0),
        np.concatenate(ids, axis=0),
        (np.concatenate(store_qs, axis=0), np.concatenate(store_scales, axis=0))
        if keep_store else None,
    )


def make_decode_retriever(
    cfg: CoreConfig, models: RetrievalModels, store, no_mask_embed=None
) -> Callable[[RetrievalEngine], Callable]:
    """The rerank's wiring (cor_tpu ``_make_decode_retriever``): returns
    make_retrieve(engine), which arms the engine's store decode with
    ``store`` (a quantised pair from ``encode_manifest``, or a raw memory
    map quantised with ``no_mask_embed`` baked in) and returns a retriever
    of [Q, D] queries -> indices [Q, k] by IoU rank."""
    if models.decode_model is None:
        raise ValueError("the rerank decodes masks: prepare_models needs the decode model")
    dec = models.decode_model
    image_pe = get_dense_pe(dec.prompt_encoder).to(cfg.dtype)

    def make_retrieve(engine: RetrievalEngine):
        engine.enable_store_decode(store, no_mask_embed=no_mask_embed)
        return lambda q: engine.retrieve_decode(q, dec.mask_decoder, image_pe)[2]

    return make_retrieve


def scan_recall(
    gallery: np.ndarray,
    queries: np.ndarray,
    targets: np.ndarray,
    ks,
    query_batch: int = 256,
    make_retrieve=None,
    approx: bool = False,
    quantize: bool = False,
    rescore: bool = False,
    rescore_width: int = 4,
    recall_target: Optional[float] = None,
    device="cuda",
) -> Dict[str, float]:
    """The scan half of every protocol entry point (cor_tpu
    ``_scan_recall``): an engine over ``gallery``, already-encoded queries
    (normalised again, so that a cosine stays a dot product) retrieved in
    batches of ``query_batch``, and Recall@K for every K up to the gallery's
    size, with ``gallery_size``. ``make_retrieve(engine)`` may replace the
    plain scan with another retriever over the same engine (the rerank)."""
    g = gallery.shape[0]
    engine = RetrievalEngine(
        k=min(max(ks), g), approx=approx, recall_target=recall_target, quantize=quantize,
        rescore=rescore, rescore_width=rescore_width, device=device,
    )
    engine.set_gallery(gallery)
    retrieve = (lambda q: engine.retrieve(q)[1]) if make_retrieve is None else make_retrieve(engine)
    queries = queries / np.maximum(np.linalg.norm(queries, axis=1, keepdims=True), 1e-12)
    retrieved = np.concatenate([
        retrieve(torch.from_numpy(queries[s:s + query_batch]).to(engine.device)).cpu().numpy()
        for s in range(0, queries.shape[0], query_batch)
    ])  # [Q, k_max]
    out = recall_at_k(retrieved, targets, ks=[k for k in ks if k <= g])
    out["gallery_size"] = float(g)
    return out


def evaluate_retrieval(
    cfg: CoreConfig,
    models: RetrievalModels,
    loader: Iterable[Dict[str, np.ndarray]],
    ks: Tuple[int, ...] = (1, 5, 10),
    query_batch: int = 256,
    rerank: bool = False,
    approx: bool = False,
    quantize: bool = False,
    rescore: bool = False,
    rescore_width: int = 4,
    recall_target: Optional[float] = None,
) -> Dict[str, float]:
    """The whole protocol in one pass: encode, scan, Recall@K
    ({"recall@1": ..., "gallery_size": G}). ``rerank`` decodes every
    query's top max(ks) out of the int8 store ``encode_manifest`` keeps and
    ranks them by IoU; ``approx``/``quantize`` select the scan and
    ``rescore`` its exact second stage."""
    gallery, queries, _, store = encode_manifest(cfg, models, loader, keep_store=rerank)
    make_retrieve = make_decode_retriever(cfg, models, store) if rerank else None
    return scan_recall(
        gallery, queries, np.arange(gallery.shape[0]), ks, query_batch, make_retrieve,
        approx=approx, quantize=quantize, rescore=rescore, rescore_width=rescore_width,
        recall_target=recall_target, device=models.device,
    )


def evaluate_retrieval_with_index(
    cfg: CoreConfig,
    models: RetrievalModels,
    loader: Iterable[Dict[str, np.ndarray]],
    index: Dict[str, np.ndarray],
    ks: Tuple[int, ...] = (1, 5, 10),
    query_batch: int = 256,
    rerank: bool = False,
    approx: bool = False,
    quantize: bool = False,
    rescore: bool = False,
    rescore_width: int = 4,
    recall_target: Optional[float] = None,
) -> Dict[str, float]:
    """The serving-side protocol: queries encoded live against a gallery
    index artifact (``cli.index``), no candidate encoded. A query's target
    row is found by its pair id in the index, not by its position; a pair
    id missing from the index raises. ``rerank`` decodes from the artifact's
    fp16 store, quantised to int8 chunk by chunk with the no-mask prompt
    baked in."""
    encode_query = make_query_encoder(cfg)
    dev = models.device
    queries, qids = [], []
    for b in loader:
        q = encode_query(models.support_branch,
                         *_on(dev, b["support_img"], b["text"], b["support_mask"]))
        queries.append(q.cpu().numpy())
        qids.append(np.asarray(b["pair_id"]))
    queries, qids = np.concatenate(queries, axis=0), np.concatenate(qids, axis=0)
    pos = {int(p): i for i, p in enumerate(index["pair_ids"])}
    missing = [int(p) for p in qids if int(p) not in pos]
    if missing:
        raise ValueError(
            f"{len(missing)} query pair ids absent from the gallery index "
            f"(first: {missing[:5]}) — index/manifest mismatch"
        )
    targets = np.asarray([pos[int(p)] for p in qids])
    make_retrieve = None
    if rerank:
        if index.get("store") is None:
            raise ValueError(
                "rerank needs the SAM image-embedding store in the gallery index — rebuild it "
                "with `cor_tpu_torch.cli.index --with-store`"
            )
        make_retrieve = make_decode_retriever(cfg, models, index["store"],
                                              no_mask_embed=models.no_mask_embed)
    return scan_recall(
        np.asarray(index["embeddings"], np.float32), queries, targets, ks, query_batch,
        make_retrieve, approx=approx, quantize=quantize, rescore=rescore,
        rescore_width=rescore_width, recall_target=recall_target, device=models.device,
    )
