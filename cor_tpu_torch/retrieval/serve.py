"""Online retrieval serving on one device, the PyTorch counterpart of
``cor_tpu.retrieval.serve.RetrievalServer``.

A ``RetrievalServer`` owns the gallery (``RetrievalEngine``), the query
encoder (the support branch: SigLIP towers, mask pooling, fusion and
projection) and, when it decodes masks, the prompt encoder and mask decoder
with the candidate store. Requests and responses are plain dicts; the CLI
speaks them as JSON lines:

    {"id": 7, "support_img": "s.jpg", "support_mask": "m.png",
     "text": "make the cat blue"}                       # or "synthetic": seed
 -> {"id": 7, "results": [{"pair_id": 123, "score": 0.83}, ...],
     "masks": ["out/7_123.png", ...]}                   # when decoding

Batches are padded to power-of-two buckets by repeating the first row, so
few shapes reach the device; only the real B * k candidates are decoded.
The candidate-mask decode has two configurations, as in ``cor_tpu``:

- host-streamed (``decode_dir`` alone): the retrieved rows of the
  memory-mapped fp16 store are gathered on the host, shipped in chunks of
  ``HOST_STREAM_DECODE_CAP`` and decoded with the dense prompt added;
- ``store_hbm``: the store is quantised to int8 once (the no-mask prompt
  pre-baked) and kept on the device; the scan's top-k indices go straight
  into the decode, whose first layer reads and dequantises the store rows
  itself, with no host round trip between scan and decode. With
  ``rescore`` the exact second stage runs on the device too, so the path
  stays on the device (``cor_tpu`` splits its graph there for a host
  stage).

The scan options are the engine's (``retrieval/engine.py``): ``quantize``
(int8), ``approx`` (``cor_tpu``'s approximate scan, run as the exact top
k), ``rescore`` with ``rescore_width`` and ``recall_target``.

Masks are binarised (``logit > 0``) and bit-packed on the device, fetched,
and written as one PNG per candidate, ``{safe_id}_{pair_id}.png``, by a
pool of ``PNG_WRITERS`` threads.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from cor_tpu_torch.data.synthetic import SyntheticDataset
from cor_tpu_torch.data.tokenizer import get_tokenizer
from cor_tpu_torch.models.core_model import CoreConfig, DecodeModel, _cast, check_kernel_dtype
from cor_tpu_torch.retrieval.engine import RetrievalEngine, quantize_candidate_store_host
from cor_tpu_torch.retrieval.index import (
    make_candidate_mask_decoder,
    make_query_encoder,
    make_store_indexed_mask_decoder,
)
from cor_tpu_torch.utils.png import png_encode_gray

log = logging.getLogger("cor_tpu_torch.serve")

# threads that encode and write the mask PNGs of a batch (zlib and the file
# writes release the GIL)
PNG_WRITERS = min(8, os.cpu_count() or 1)

_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.unpackbits' big-endian order


def pack_masks(logits: torch.Tensor) -> torch.Tensor:
    """[n, m, H, W] logits -> [n, m, H, W/8] uint8: ``logit > 0`` (the
    serving threshold sigmoid > 0.5), 8 pixels per byte, big-endian."""
    b = (logits > 0).to(torch.uint8)
    b = b.reshape(*b.shape[:-1], b.shape[-1] // 8, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=logits.device)
    return (b * w).sum(dim=-1).to(torch.uint8)


def _write_mask_png(job) -> None:
    path, mask = job  # mask: [H, W] uint8 0/1
    path.write_bytes(png_encode_gray(mask * np.uint8(255), level=1))


class RetrievalServer:
    # the host-streamed decode ships the retrieved fp16 rows ([g, g, C], 2 MiB
    # each at the flagship geometry) in chunks of at most this many, so a large
    # --max-batch x k cannot grow one device buffer without bound
    HOST_STREAM_DECODE_CAP = 32

    def __init__(
        self,
        core_cfg: CoreConfig,
        model: torch.nn.Module,
        index: Dict[str, np.ndarray],
        k: int = 10,
        quantize: bool = False,
        tokenizer_path: Optional[str] = None,
        device="cuda",
        decode_model: Optional[DecodeModel] = None,
        decode_dir: Optional[str] = None,
        store_hbm: bool = False,
        approx: bool = False,
        rescore: bool = False,
        rescore_width: int = 4,
        recall_target: Optional[float] = None,
    ):
        """``model`` is a ``SupportBranch`` and ``decode_model`` (needed with
        ``decode_dir``) a ``DecodeModel``; the server moves both to ``device``
        and casts them in place to the config's compute dtype."""
        check_kernel_dtype(core_cfg, device)
        self.cfg = core_cfg
        self.device = torch.device(device)
        self.model = _cast(model.to(self.device), core_cfg.dtype).eval()
        self.k = min(k, len(index["pair_ids"]))
        self.engine = RetrievalEngine(
            k=self.k, approx=approx, recall_target=recall_target, quantize=quantize,
            rescore=rescore, rescore_width=rescore_width, device=self.device,
        )
        self.engine.set_gallery(index["embeddings"])
        self.pair_ids = np.asarray(index["pair_ids"])
        self.store = index.get("store")  # [G, g, g, C] fp16 memory map, or None
        self.encode_query = make_query_encoder(core_cfg)
        self.batches_encoded = 0  # encode+scan dispatches, warmup included
        self.decode_calls = 0  # mask-decode calls (one per host-streamed chunk)
        self._syn_cache: Dict[int, tuple] = {}  # bounded synthetic-query memo
        self._anon_requests = 0  # file-name counter for requests without an id
        self.decode_dir = Path(decode_dir) if decode_dir else None
        self.decode_model = None
        self._decode = self._decode_hbm = None
        if self.decode_dir is not None and self.store is None:
            raise ValueError(
                "decode_dir requested but the gallery index carries no image-"
                "embedding store — rebuild it with cor_tpu.cli.index --with-store"
            )
        if store_hbm and self.decode_dir is None:
            raise ValueError(
                "store_hbm=True without decode_dir does nothing — the HBM-"
                "resident int8 store only serves the candidate-mask decode "
                "path; pass decode_dir (cli: --decode-masks) or drop the flag"
            )
        if self.decode_dir is not None:
            if decode_model is None:
                raise ValueError("decode_dir needs a decode_model (prompt encoder + mask decoder)")
            # the prompt is baked into the int8 store from the fp32 weights,
            # before the model is cast (as cor_tpu bakes its uncast params)
            no_mask = decode_model.prompt_encoder.no_mask_embed.detach().float().cpu().numpy()[0]
            self.decode_model = _cast(decode_model.to(self.device), core_cfg.dtype).eval()
            self._png_writers = ThreadPoolExecutor(PNG_WRITERS, thread_name_prefix="png")
            if store_hbm:
                q, scales = quantize_candidate_store_host(self.store, no_mask)
                self._store_q = torch.from_numpy(q).to(self.device)
                self._store_scales = torch.from_numpy(scales).to(self.device)
                self._decode_hbm = make_store_indexed_mask_decoder(core_cfg)
                log.info("candidate store on the device: %d int8 rows (%.2f GiB)",
                         q.shape[0], q.nbytes / 2**30)
            else:
                self._decode = make_candidate_mask_decoder(core_cfg)
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
        """A request naming files: read as the manifest dataset reads them
        (PNGs by the port's reader, other formats by Pillow where it is
        installed; the resize and normalize of the ``preproc`` library)."""
        from cor_tpu_torch.data.pipeline import _to_float_img
        from cor_tpu_torch.utils.png import read_image

        size = self.cfg.support.siglip.vision.image_size
        return (
            _to_float_img(read_image(request["support_img"], "RGB"), size, True),
            _to_float_img(read_image(request["support_mask"], "L"), size, False),
            self.tokenizer(str(request.get("text", "")))[0],
        )

    def _assemble(self, request: Dict):
        """Request dict -> (support_img, support_mask, text_ids) host arrays.
        Raises on a malformed request."""
        if "synthetic" in request:
            return self._synthetic_query(request["synthetic"])
        return self._file_query(request)

    # -- request handling ----------------------------------------------------

    def handle(self, request: Dict, save_masks: bool = True) -> Dict:
        """One request -> one response. Raises on a malformed request.
        ``save_masks=False`` decodes but writes no file (warmup)."""
        return self._respond_batch([request], [self._assemble(request)], save_masks)[0]

    def handle_batch(self, requests: List[Dict], save_masks: bool = True) -> List[Dict]:
        """N requests -> N responses in order, with one encode, one scan and
        (when decoding) one decode of the B * k candidates for the batch. A
        malformed request yields an error response in its own slot without
        failing its batchmates."""
        assembled, errors, good_requests = [], {}, []
        for slot, req in enumerate(requests):
            try:
                assembled.append(self._assemble(req))
                good_requests.append(req)
            except Exception as e:  # isolate per-request assembly failures
                rid = req.get("id") if isinstance(req, dict) else None
                errors[slot] = {"id": rid, "error": f"{type(e).__name__}: {e}"}
        good = iter(
            self._respond_batch(good_requests, assembled, save_masks) if assembled else []
        )
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
        """Encode a padded batch and scan the gallery: (queries [Bp, D],
        scores [Bp, k], idx [Bp, k]), all on the device."""
        q = self.encode_query(self.model, imgs, texts, masks)
        self.batches_encoded += 1
        scores, idx = self.engine.retrieve(q)
        return q, scores, idx

    def encode_scan_decode(self, imgs, masks, texts, B: int):
        """The ``store_hbm`` path of a padded batch whose first B rows are
        real: encode, scan, decode every retrieved candidate out of the int8
        store and pack its mask, without leaving the device: (scores [B, k],
        idx [B, k], packed masks [B * k, 1, 4g, 4g / 8])."""
        q, scores, idx = self.encode_and_scan(imgs, masks, texts)
        scores, idx = scores[:B], idx[:B]
        k = idx.shape[1]
        flat = idx.reshape(-1).clamp(0, self._store_q.shape[0] - 1).to(torch.int32)
        logits = self._decode_hbm(self.decode_model, self._store_q, self._store_scales, flat,
                                  q[:B].repeat_interleave(k, dim=0))
        self.decode_calls += 1
        return scores, idx, pack_masks(logits)

    def _decode_host_stream(self, idx: np.ndarray, q: torch.Tensor) -> torch.Tensor:
        """[B, k] store rows + [B, D] queries -> packed masks [B * k, 1, 4g,
        4g / 8] on the host: the rows are gathered from the memory-mapped
        store and decoded in chunks of at most ``HOST_STREAM_DECODE_CAP``."""
        flat = idx.reshape(-1)
        feats = q.repeat_interleave(idx.shape[1], dim=0)
        cap = self.HOST_STREAM_DECODE_CAP
        chunks = []
        for s in range(0, len(flat), cap):
            rows = torch.from_numpy(np.asarray(self.store[flat[s : s + cap]])).to(self.device)
            logits = self._decode(self.decode_model, rows, feats[s : s + cap])
            self.decode_calls += 1
            chunks.append(pack_masks(logits).cpu())
        return torch.cat(chunks)

    def _respond_batch(self, requests, assembled, save_masks: bool = True) -> List[Dict]:
        B = len(assembled)
        tensors = self._batch_tensors(assembled)
        packed = None
        if self._decode_hbm is not None:
            scores, idx, packed = self.encode_scan_decode(*tensors, B)
            scores, idx, packed = scores.cpu().numpy(), idx.cpu().numpy(), packed.cpu()
        else:
            q, scores, idx = self.encode_and_scan(*tensors)
            scores, idx = scores[:B].cpu().numpy(), idx[:B].cpu().numpy()
            if self._decode is not None:
                packed = self._decode_host_stream(idx, q[:B])
        resps = [
            {
                "id": req.get("id"),
                "results": [
                    {"pair_id": int(self.pair_ids[i]), "score": float(s)}
                    for i, s in zip(idx[b], scores[b])
                ],
            }
            for b, req in enumerate(requests)
        ]
        if packed is not None:
            masks = np.unpackbits(packed.numpy(), axis=-1)[:, 0]  # [B*k, 4g, 4g] 0/1
            masks = masks.reshape(B, idx.shape[1], *masks.shape[1:])
            jobs = []
            for b, resp in enumerate(resps):
                paths = self._mask_paths(requests[b].get("id"), idx[b]) if save_masks else []
                resp["masks"] = [str(p) for p in paths]
                jobs += zip(paths, masks[b])
            if jobs:
                self.decode_dir.mkdir(parents=True, exist_ok=True)
                list(self._png_writers.map(_write_mask_png, jobs))
        return resps

    def _mask_paths(self, req_id, idx: np.ndarray) -> List[Path]:
        """The PNG path of each retrieved candidate of one request."""
        # request ids come from untrusted clients: keep a file-name-safe token
        # (no separators, so no path out of decode_dir); id-less requests get
        # a per-server counter instead of colliding
        safe_id = "".join(ch for ch in str(req_id) if ch.isalnum() or ch in "-_.").lstrip(".")
        if req_id is None or not safe_id:
            self._anon_requests += 1
            safe_id = f"req{self._anon_requests}"
        return [self.decode_dir / f"{safe_id}_{int(self.pair_ids[row])}.png" for row in idx]

    def warmup(self, batch_buckets=(1,)) -> None:
        """Run every batch bucket once on synthetic requests, writing no
        mask, so that the first real request pays no first-call cost (kernel
        build, cuBLAS handles, allocator growth)."""
        for b in batch_buckets:
            self.handle_batch([{"id": "warmup", "synthetic": i} for i in range(b)],
                              save_masks=False)
        log.info("RetrievalServer warm: gallery=%d k=%d decode=%s buckets=%s device=%s",
                 len(self.pair_ids), self.k,
                 "hbm-int8" if self._decode_hbm is not None else self._decode is not None,
                 list(batch_buckets), self.device)
