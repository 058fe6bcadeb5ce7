"""Gallery scan and exact top-k on one device, the PyTorch counterpart of the
single-device part of ``cor_tpu.retrieval.engine``.

The gallery is a [G, D] matrix of L2-normed candidate embeddings, so a cosine
score is a dot product and the scan is one GEMM (``torch.matmul``, as
``cor_tpu`` leaves it to XLA), followed by ``torch.topk``.

int8 mode quantises every gallery row and every query row symmetrically,
q = round(row * 127 / max|row|), and scores the int8 values with an fp32
matmul. That product is exact: |sum of int8 * int8| over D = 256 is at most
127^2 * 256 < 2^24, and int8 values are exact in fp32 and in TF32. The
gallery stays int8 on the device (4x less memory than fp32) and is widened
to fp32 for each scan.

Ties: ``lax.top_k`` puts the lower index first; ``torch.topk`` promises no
order between equal scores.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


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

    def __init__(self, k: int = 10, quantize: bool = False, device="cuda"):
        self.k = k
        self.quantize = quantize
        self.device = torch.device(device)
        self.gallery: Optional[torch.Tensor] = None  # [G, D] fp32, or int8 when quantized
        self.scales: Optional[torch.Tensor] = None  # [G] fp32 (int8 mode)

    @property
    def size(self) -> int:
        return 0 if self.gallery is None else int(self.gallery.shape[0])

    def set_gallery(self, embeddings: np.ndarray) -> None:
        """L2-normalise the rows on the host and put them on the device."""
        embeddings = np.asarray(embeddings, np.float32)
        norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
        embeddings = (embeddings / np.maximum(norms, 1e-12)).astype(np.float32)
        if self.quantize:
            q, s = quantize_rows_int8(embeddings)
            self.gallery = torch.from_numpy(q).to(self.device)
            self.scales = torch.from_numpy(s).to(self.device)
        else:
            self.gallery = torch.from_numpy(embeddings).to(self.device)

    def retrieve(self, queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """queries [Q, D] (L2-normed) -> (scores, indices) [Q, min(k, G)]."""
        if self.gallery is None:
            raise RuntimeError("call set_gallery first")
        if self.quantize:
            qq, qs = quantize_queries(queries)
            scores = cosine_scores_int8(qq, qs, self.gallery, self.scales)
        else:
            scores = cosine_scores(queries, self.gallery)
        return torch.topk(scores, min(self.k, self.size), dim=1)
