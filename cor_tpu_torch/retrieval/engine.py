"""Gallery scan, exact top-k, the exact second stage and the IoU-ranked store
decode on one device, the PyTorch counterpart of ``cor_tpu.retrieval.engine``.

The gallery is a [G, D] matrix of L2-normed candidate embeddings, so a cosine
score is a dot product and the scan is one GEMM (``torch.matmul``, as
``cor_tpu`` leaves it to XLA), followed by ``torch.topk``.

int8 mode quantises every gallery row and every query row symmetrically,
q = round(row * 127 / max|row|), and scores the int8 values with an fp32
matmul. That product is exact: |sum of int8 * int8| over D = 256 is at most
127^2 * 256 < 2^24, and int8 values are exact in fp32 and in TF32. The
gallery stays int8 on the device (4x less memory than fp32) and is widened
to fp32 for each scan.

``approx=True`` selects ``cor_tpu``'s ``lax.approx_max_k`` scan, a TPU
operation; the port maps it to the exact ``torch.topk`` (which is also what
``approx_max_k`` lowers to on the CPU), so an approximate scan here returns
the exact top k. ``recall_target`` is kept for ``cor_tpu``'s defaults and
reports, and selects nothing.

``rescore=True`` widens the scan to ``rescore_width * k`` candidates and
re-ranks that pool by exact fp32 cosines against a device copy of the
normalised gallery (``cor_tpu`` runs this stage on the host in numpy).

The IoU-ranked store decode (``enable_store_decode``, ``retrieve_decode``) is
``cor_tpu``'s ``make_sharded_retrieve_decode`` on one device: the scan's top
k per query are mask-decoded straight out of the int8 candidate store (K1
reads and dequantises the rows in its first layer, then K2 and K3) and
re-ranked by the decoder's predicted IoU. On an n-chip mesh ``cor_tpu``
decodes each shard's local top k and ranks the n * k pool; one device is
its n = 1 case, where the rerank reorders the cosine top k.

Ties: ``lax.top_k`` puts the lower index first; ``torch.topk`` promises no
order between equal scores.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cor_tpu_torch.models.sam_decoder import check_fused_geometry, mask_decoder

# candidates per decode call when Q * k is larger and divides by it, as
# cor_tpu's make_sharded_retrieve_decode chunks its lax.map
DECODE_CHUNK = 128


def cosine_scores(queries: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """[Q, D] x [G, D] -> [Q, G] fp32; both inputs L2-normed."""
    return torch.matmul(queries.float(), gallery.float().T)


def top_k_retrieve(
    queries: torch.Tensor, gallery: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k], indices [Q, k]) over the whole gallery, best first."""
    return torch.topk(cosine_scores(queries, gallery), k, dim=1)


def quantize_rows_int8(emb: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 on the host (cor_tpu ``quantize_rows_int8``)."""
    emb = np.asarray(emb, np.float32)
    scales = np.abs(emb).max(axis=1) / 127.0
    scales = np.maximum(scales, 1e-12)
    q = np.clip(np.round(emb / scales[:, None]), -127, 127).astype(np.int8)
    return q, scales.astype(np.float32)


def quantize_queries(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same per-row scheme on the device (cor_tpu
    ``_quantize_queries_in_graph``): int8-valued fp32 rows and fp32 scales."""
    q = queries.float()
    qscale = torch.clamp(q.abs().amax(dim=1) / 127.0, min=1e-12)
    return torch.clamp(torch.round(q / qscale[:, None]), -127, 127), qscale


def quantize_candidate_store(
    store: torch.Tensor, no_mask_embed=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 per-candidate-row symmetric quantisation of a SAM candidate store
    [S, H, W, C] on the store's device -> (int8 store, fp32 scales [S])
    (cor_tpu ``quantize_candidate_store``). The dense no-mask prompt, when
    given, is added in fp32 before quantisation; the bits of
    ``quantize_candidate_store_host``."""
    x = store.float()
    if no_mask_embed is not None:
        x = x + torch.as_tensor(np.asarray(no_mask_embed), dtype=torch.float32, device=x.device)
    flat = x.reshape(x.shape[0], -1)
    scales = torch.clamp(flat.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(flat / scales[:, None]), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scales


def quantize_candidate_store_host(
    store, no_mask_embed=None, chunk: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """int8 per-candidate-row symmetric quantisation of a SAM candidate store
    [S, H, W, C] (often memory-mapped fp16) -> (int8 store, fp32 scales [S]),
    chunk by chunk in numpy so that host memory stays bounded; bit for bit
    cor_tpu's ``quantize_candidate_store_host``. The dense no-mask prompt,
    when given, is added in fp32 before quantisation, so the decode needs
    no dense-prompt pass; row s dequantises as ``q[s] * scales[s]``."""
    S = store.shape[0]
    q = np.empty(store.shape, np.int8)
    scales = np.empty((S,), np.float32)
    bias = None if no_mask_embed is None else np.asarray(no_mask_embed, np.float32)
    for s in range(0, S, chunk):
        rows = np.asarray(store[s : s + chunk], np.float32)
        if bias is not None:
            rows = rows + bias
        flat = rows.reshape(rows.shape[0], -1)
        sc = np.maximum(np.abs(flat).max(axis=1) / 127.0, 1e-12)
        q[s : s + chunk] = (
            np.clip(np.round(flat / sc[:, None]), -127, 127).astype(np.int8).reshape(rows.shape)
        )
        scales[s : s + chunk] = sc
    return q, scales


def cosine_scores_int8(
    queries_q: torch.Tensor,  # [Q, D] int8 values
    qscales: torch.Tensor,  # [Q] fp32
    gallery_q: torch.Tensor,  # [G, D] int8 values
    gscales: torch.Tensor,  # [G] fp32
) -> torch.Tensor:
    """Exact integer dot products (fp32 matmul on int8 values), rescaled to
    fp32 cosine scores."""
    raw = torch.matmul(queries_q.float(), gallery_q.float().T)
    return raw * qscales[:, None] * gscales[None, :]




class RetrievalEngine:
    """Hold a gallery on one device; retrieve the top k for query batches."""

    def __init__(
        self,
        k: int = 10,
        approx: bool = False,
        recall_target: Optional[float] = None,
        quantize: bool = False,
        rescore: bool = False,
        rescore_width: int = 4,
        device="cuda",
    ):
        """``approx`` is the exact ``torch.topk`` (see the module's
        docstring). ``recall_target`` defaults as ``cor_tpu``'s: 0.99, or
        0.999 with ``approx`` and ``rescore``. ``rescore=True`` scans for a
        pool of ``k_scan = rescore_width * k`` candidates and returns the top
        k of that pool by exact fp32 cosine."""
        self.k = k
        self.quantize = quantize
        self.approx = approx
        if recall_target is None:
            recall_target = 0.999 if (rescore and approx) else 0.99
        self.recall_target = recall_target
        self.rescore = rescore
        self.k_scan = rescore_width * k if rescore else k
        self.device = torch.device(device)
        self.gallery: Optional[torch.Tensor] = None  # [G, D] fp32, or int8 when quantized
        self.scales: Optional[torch.Tensor] = None  # [G] fp32 (int8 mode)
        self._exact: Optional[torch.Tensor] = None  # [G, D] fp32, the rescore's rows
        self.store_q: Optional[torch.Tensor] = None  # [G, g, g, C] int8 (store decode)
        self.store_scales: Optional[torch.Tensor] = None  # [G] fp32

    @property
    def size(self) -> int:
        return 0 if self.gallery is None else int(self.gallery.shape[0])

    def set_gallery(self, embeddings: np.ndarray) -> None:
        """L2-normalise the rows on the host and put them on the device (with
        ``rescore``, the fp32 rows too when the scan is int8)."""
        embeddings = np.asarray(embeddings, np.float32)
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        embeddings = (embeddings / np.maximum(norms, 1e-12)).astype(np.float32)
        rows = torch.from_numpy(embeddings).to(self.device)
        if self.quantize:
            q, s = quantize_rows_int8(embeddings)
            self.gallery = torch.from_numpy(q).to(self.device)
            self.scales = torch.from_numpy(s).to(self.device)
        else:
            self.gallery = rows
        self._exact = rows if self.rescore else None

    def _scores(self, queries: torch.Tensor) -> torch.Tensor:
        if self.gallery is None:
            raise ValueError("call set_gallery first")
        if self.quantize:
            qq, qs = quantize_queries(queries)
            return cosine_scores_int8(qq, qs, self.gallery, self.scales)
        return cosine_scores(queries, self.gallery)

    def retrieve(self, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """queries [Q, D] (L2-normed) -> (scores, indices) [Q, min(k, G)],
        best first. With ``rescore`` the scores are true fp32 cosines."""
        scores, idx = torch.topk(self._scores(queries), min(self.k_scan, self.size), dim=1)
        if not self.rescore:
            return scores, idx
        return self._exact_rescore(queries, idx)

    def _exact_rescore(
        self, queries: torch.Tensor, pool_idx: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The exact second stage on the device: the pool's fp32 rows
        [Q, k_scan, D] gathered from the normalised gallery, their cosines
        summed in fp32 (no TF32), and the top k of the pool."""
        rows = self._exact[pool_idx]
        s = (rows * queries.float()[:, None, :]).sum(dim=-1)
        s, pos = torch.topk(s, min(self.k, pool_idx.shape[1]), dim=1)
        return s, torch.gather(pool_idx, 1, pos)

    def enable_store_decode(self, store, no_mask_embed=None) -> None:
        """Put the SAM image-embedding store on the device as int8, row-aligned
        with the gallery, for ``retrieve_decode``. ``store`` is [G, g, g, C]
        (numpy or a memory map, quantised on the host chunk by chunk with
        ``no_mask_embed`` baked in, so that only int8 ships) or a quantised
        ``(q int8, scales)`` pair, whose dense prompt is already baked in
        (``protocol.encode_manifest(keep_store=True)``)."""
        if self.gallery is None:
            raise ValueError("set_gallery first: store rows align with gallery rows")
        if isinstance(store, tuple):
            q, scales = store
            if q.dtype not in (np.int8, torch.int8) or no_mask_embed is not None:
                raise ValueError("a quantised store (q int8, scales) carries its own scales "
                                 "with the dense prompt already baked in")
            rows = q.shape[0]
        else:
            rows = store.shape[0]
        if rows != self.size:
            raise ValueError(f"store rows {rows} != gallery size {self.size}")
        if not isinstance(store, tuple):
            q, scales = quantize_candidate_store_host(store, no_mask_embed)
        self.store_q = torch.as_tensor(q).to(self.device)
        self.store_scales = torch.as_tensor(scales, dtype=torch.float32).to(self.device)

    @torch.inference_mode()
    def retrieve_decode(
        self, queries: torch.Tensor, decoder, image_pe: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Scan, then mask-decode every query's top k out of the int8 store
        and rank them by predicted IoU: queries [Q, D] (L2-normed) ->
        (cosine scores, IoU, indices), each [Q, min(k, G)], by IoU.

        ``decoder`` is the ``MaskDecoder`` and ``image_pe`` [1, g, g, C] the
        dense PE, both in the compute dtype. Each candidate is decoded with
        its query as the one sparse token (6 tokens), one mask
        (``multimask_output=False``) and that mask's IoU, whatever the
        config's ``multimask_output``. Q * k candidates go through the fused
        decoder in chunks of ``DECODE_CHUNK`` when Q * k is larger and a
        multiple of it, else in one call; on the card a call of more
        candidates than the kernels take is refused before the scan."""
        if self.store_q is None:
            raise ValueError("call enable_store_decode first")
        k = min(self.k, self.size)
        B = queries.shape[0] * k
        n = DECODE_CHUNK if B > DECODE_CHUNK and B % DECODE_CHUNK == 0 else B
        if self.device.type != "cpu":
            _, _, W, C = self.store_q.shape
            check_fused_geometry(W, 2 + decoder.cfg.num_mask_tokens, C, n)
        scores, idx = torch.topk(self._scores(queries), k, dim=1)
        flat = idx.reshape(-1).to(torch.int32)
        prompts = queries.to(image_pe.dtype).repeat_interleave(k, dim=0)[:, None, :]
        ious = [
            mask_decoder(decoder, self.store_q, image_pe, prompts[s:s + n], None, False,
                         store_idx=flat[s:s + n], store_scale=self.store_scales)[1][:, 0]
            for s in range(0, B, n)
        ]
        iou = torch.cat(ious).reshape(-1, k).float()
        iou, pos = torch.topk(iou, k, dim=1)
        return torch.gather(scores, 1, pos), iou, torch.gather(idx, 1, pos)


def recall_at_k(
    retrieved_indices: np.ndarray, target_indices: np.ndarray, ks=(1, 5, 10)
) -> Dict[str, float]:
    """Recall@K given [Q, k_max] retrieved ids and [Q] targets (cor_tpu
    ``recall_at_k``)."""
    out = {}
    for k in ks:
        hits = (retrieved_indices[:, :k] == target_indices[:, None]).any(axis=1)
        out[f"recall@{k}"] = float(hits.mean())
    return out
