"""Online retrieval serving on one device, the PyTorch counterpart of the
retrieval-only path of ``cor_tpu.retrieval.serve.RetrievalServer``.

A ``RetrievalServer`` owns the gallery (``RetrievalEngine``) and the query
encoder (the support branch: SigLIP towers, mask pooling, fusion and
projection — the only per-request model work). Requests and responses are
plain dicts; the CLI speaks them as JSON lines:

    {"id": 7, "support_img": "s.jpg", "support_mask": "m.png",
     "text": "make the cat blue"}                       # or "synthetic": seed
 -> {"id": 7, "results": [{"pair_id": 123, "score": 0.83}, ...]}

Batches are padded to power-of-two buckets by repeating the first row, so
few shapes reach the device. Candidate-mask decode is a later slice of the
port.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from cor_tpu.data.tokenizer import get_tokenizer  # numpy only: shared with cor_tpu
from cor_tpu_torch.data.synthetic import SyntheticDataset
from cor_tpu_torch.models.core_model import CoreConfig, _cast
from cor_tpu_torch.retrieval.engine import RetrievalEngine
from cor_tpu_torch.retrieval.index import make_query_encoder

log = logging.getLogger("cor_tpu_torch.serve")

# cor_tpu.data.pipeline's image statistics (torchvision ImageNet normalisation)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _to_float_img(img, size: int, normalize: bool) -> np.ndarray:
    """A PIL image -> HWC fp32 at size x size (bilinear), optionally
    ImageNet-normalised (cor_tpu.data.pipeline._to_float_img's PIL path)."""
    from PIL import Image

    arr = np.asarray(img.resize((size, size), Image.BILINEAR), np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if normalize:
        arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    return arr


class RetrievalServer:
    def __init__(
        self,
        core_cfg: CoreConfig,
        model: torch.nn.Module,
        index: Dict[str, np.ndarray],
        k: int = 10,
        quantize: bool = False,
        tokenizer_path: Optional[str] = None,
        device=None,
    ):
        """``model`` is a ``SupportBranch``; the server moves it to ``device``
        (default: where its parameters are) and casts it in place to the
        config's compute dtype."""
        self.cfg = core_cfg
        self.device = torch.device(device) if device is not None else next(model.parameters()).device
        self.model = _cast(model.to(self.device), core_cfg.dtype).eval()
        self.k = min(k, len(index["pair_ids"]))
        self.engine = RetrievalEngine(k=self.k, quantize=quantize, device=self.device)
        self.engine.set_gallery(index["embeddings"])
        self.pair_ids = np.asarray(index["pair_ids"])
        self.encode_query = make_query_encoder(core_cfg)
        self.batches_encoded = 0  # encode+scan dispatches, warmup included
        self._syn_cache: Dict[int, tuple] = {}  # bounded synthetic-query memo
        self.tokenizer = get_tokenizer(
            tokenizer_path, core_cfg.support.siglip.text.context_length
        )

    # -- query assembly ----------------------------------------------------

    def _synthetic_query(self, seed: int):
        # a deterministic function of the seed, so it is memoised (bounded):
        # the sample draws a full query image before the support triple
        seed = int(seed)
        cached = self._syn_cache.get(seed)
        if cached is not None:
            return cached
        sig = self.cfg.support.siglip
        s = SyntheticDataset(
            length=1,
            query_img_size=self.cfg.query_img_size,
            support_img_size=sig.vision.image_size,
            context_length=sig.text.context_length,
            vocab_size=sig.text.vocab_size,
            seed=seed,
        )[0]
        out = (s["support_img"], s["support_mask"], s["text"])
        if len(self._syn_cache) >= 64:
            self._syn_cache.pop(next(iter(self._syn_cache)))
        self._syn_cache[seed] = out
        return out

    def _file_query(self, request: Dict):
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                "requests with image files need Pillow (PIL) to decode them; "
                "synthetic requests do not"
            ) from e
        size = self.cfg.support.siglip.vision.image_size
        img = Image.open(request["support_img"]).convert("RGB")
        mask = Image.open(request["support_mask"]).convert("L")
        return (
            _to_float_img(img, size, True),
            _to_float_img(mask, size, False),
            self.tokenizer(str(request.get("text", "")))[0],
        )

    def _assemble(self, request: Dict):
        """Request dict -> (support_img, support_mask, text_ids) host arrays.
        Raises on a malformed request."""
        if "synthetic" in request:
            return self._synthetic_query(request["synthetic"])
        return self._file_query(request)

    # -- request handling ----------------------------------------------------

    def handle(self, request: Dict) -> Dict:
        """One request -> one response. Raises on a malformed request."""
        return self._respond_batch([request], [self._assemble(request)])[0]

    def handle_batch(self, requests: List[Dict]) -> List[Dict]:
        """N requests -> N responses in order, with one encode and one scan
        for the batch. A malformed request yields an error response in its
        own slot without failing its batchmates."""
        assembled, errors, good_requests = [], {}, []
        for slot, req in enumerate(requests):
            try:
                assembled.append(self._assemble(req))
                good_requests.append(req)
            except Exception as e:  # isolate per-request assembly failures
                rid = req.get("id") if isinstance(req, dict) else None
                errors[slot] = {"id": rid, "error": f"{type(e).__name__}: {e}"}
        good = iter(self._respond_batch(good_requests, assembled) if assembled else [])
        return [errors[s] if s in errors else next(good) for s in range(len(requests))]

    @staticmethod
    def _bucket(n: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return b

    def _batch_tensors(self, assembled):
        """Stack a batch padded to its bucket (first row repeated) onto the device."""
        rows = assembled + [assembled[0]] * (self._bucket(len(assembled)) - len(assembled))
        return tuple(
            torch.from_numpy(np.stack([r[i] for r in rows])).to(self.device) for i in range(3)
        )  # images [Bp,S,S,3], masks [Bp,S,S,1], texts [Bp,L]

    def encode_and_scan(self, imgs, masks, texts):
        """Encode a padded batch and scan the gallery: (scores, idx) [Bp, k]."""
        q = self.encode_query(self.model, imgs, texts, masks)
        self.batches_encoded += 1
        return self.engine.retrieve(q)

    def _respond_batch(self, requests, assembled) -> List[Dict]:
        B = len(assembled)
        scores, idx = self.encode_and_scan(*self._batch_tensors(assembled))
        scores = scores[:B].cpu().numpy()
        idx = idx[:B].cpu().numpy()
        return [
            {
                "id": req.get("id"),
                "results": [
                    {"pair_id": int(self.pair_ids[i]), "score": float(s)}
                    for i, s in zip(idx[b], scores[b])
                ],
            }
            for b, req in enumerate(requests)
        ]

    def warmup(self, batch_buckets=(1,)) -> None:
        """Run every batch bucket once on synthetic requests, so that the
        first real request pays no first-call cost (kernel build, cuBLAS
        handles, allocator growth)."""
        for b in batch_buckets:
            self.handle_batch([{"id": "warmup", "synthetic": i} for i in range(b)])
        log.info("RetrievalServer warm: gallery=%d k=%d buckets=%s device=%s",
                 len(self.pair_ids), self.k, list(batch_buckets), self.device)
