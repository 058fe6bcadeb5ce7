"""Deterministic synthetic triplets, bit-identical to
``cor_tpu.data.pipeline.SyntheticDataset`` without importing PIL.

Sample ``idx`` draws from ``np.random.default_rng((seed, idx))`` in the order
of ``cor_tpu``'s dict literal: the query image (``query_img_size``^2 x 3
normals), the query mask (a blob), the support image, the support mask (a
blob), then the text ids. The query image is drawn before the support triple
even where only the support triple is used (serving), so that
``{"synthetic": i}`` gives the same inputs in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class SyntheticDataset:
    length: int = 64
    query_img_size: int = 1024
    support_img_size: int = 384
    context_length: int = 64
    vocab_size: int = 32000
    native_hw: Optional[tuple] = None  # defaults to (query_img_size,)*2
    seed: int = 0
    train: bool = False

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, idx))
        q, s = self.query_img_size, self.support_img_size

        def blob(size):
            yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
            cy, cx, r = rng.uniform(0.25, 0.75, 3) * np.array([1, 1, 0.35])
            m = ((yy - cy) ** 2 + (xx - cx) ** 2 < (0.08 + r * 0.2) ** 2)
            return m.astype(np.float32)[:, :, None]

        native = self.native_hw or (q, q)
        return {
            "pair_id": np.int64(idx),
            "query_img": rng.standard_normal((q, q, 3)).astype(np.float32),
            "query_mask": blob(q),
            "support_img": rng.standard_normal((s, s, 3)).astype(np.float32),
            "support_mask": blob(s),
            "text": rng.integers(2, self.vocab_size, self.context_length).astype(np.int32),
            "native_hw": np.array(native, np.int32),
        }
