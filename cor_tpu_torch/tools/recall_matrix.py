"""The retrieval engine's accuracy matrix, the port of ``cor_tpu``'s
``tools/recall_matrix.py``: {fp32, int8} x {exact, approx} x {rescore off,
on} over clustered galleries (408 classes of Gaussian blobs, COR127K's
category count, at decreasing spread) and an isotropic control, each with
Recall@{1,5,10} against known targets and top-k agreement with the exact
fp32 scan.

    python3 -m cor_tpu_torch.tools.recall_matrix [--gallery-rows 127166] [--queries 256]
    python3 -m cor_tpu_torch.tools.recall_matrix --device cpu --gallery-rows 4096

Two query regimes per gallery: ``qnoise=0.0``, the queries are gallery rows;
``qnoise=0.05``, perturbed rows, so that even the exact scan misses at tight
spreads. Every cell runs ``RetrievalEngine`` as serving does: its scan on
the device, and with ``rescore`` its exact second stage on the device over a
``--rescore-width`` times wider pool. The port's ``approx`` is the exact
top k, so each approx row equals its exact row; the matrix keeps it to show
that. ``cor_tpu``'s tool also measures the pool an 8-shard mesh would rank by
IoU (the union of 8 shards' int8 approximate top k); the port runs on one
device and has no such pool, so that part is not ported. The galleries are
made from ``--seed`` with numpy; the tool prints a table and then one JSON
line.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from cor_tpu_torch.retrieval.engine import RetrievalEngine

DIM = 256
CLASSES = 408
SPREADS = (None, 0.5, 0.2, 0.1, 0.05)  # None: the isotropic control
CONFIGS = (("fp32-exact", False, False), ("fp32-approx", False, True),
           ("int8-exact", True, False), ("int8-approx", True, True))


def _normed(x: np.ndarray) -> np.ndarray:
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def gallery(rows: int, sigma: Optional[float], rng: np.random.Generator) -> np.ndarray:
    """[rows, 256] unit rows: isotropic, or CLASSES blobs of spread sigma."""
    if sigma is None:
        return _normed(rng.standard_normal((rows, DIM), dtype=np.float32))
    centers = _normed(rng.standard_normal((CLASSES, DIM), dtype=np.float32))
    labels = rng.integers(0, CLASSES, rows)
    return _normed(centers[labels] + sigma * rng.standard_normal((rows, DIM), dtype=np.float32))


def run(gallery_rows: int = 127_166, queries: int = 256, k: int = 10, rescore_width: int = 4,
        device="cuda", seed: int = 0) -> Dict[str, dict]:
    """{"<gallery>/qnoise=<q>": {config: {"r@1", "r@5", "r@10", "agree"}}}."""
    rng = np.random.default_rng(seed)
    dev = torch.device(device)
    results = {}
    for sigma in SPREADS:
        g = gallery(gallery_rows, sigma, rng)
        engines = {}
        for name, int8, approx in CONFIGS:
            for rescore in (False, True):
                e = RetrievalEngine(k=k, approx=approx, quantize=int8, rescore=rescore,
                                    rescore_width=rescore_width, device=dev)
                e.set_gallery(g)
                engines[name + ("+rescore" if rescore else "")] = e
        for qnoise in (0.0, 0.05):
            targets = rng.integers(0, gallery_rows, queries)
            probe = g[targets]
            if qnoise:
                probe = _normed(probe + qnoise * rng.standard_normal(probe.shape,
                                                                     dtype=np.float32))
            q = torch.from_numpy(probe).to(dev)
            ref = engines["fp32-exact"].retrieve(q)[1].cpu().numpy()
            rows = {}
            for name, e in engines.items():
                got = e.retrieve(q)[1].cpu().numpy()
                row = {f"r@{r}": float((got[:, :r] == targets[:, None]).any(axis=1).mean())
                       for r in (1, 5, 10) if r <= k}
                row["agree"] = float(np.mean([len(set(a) & set(b)) / k
                                              for a, b in zip(ref, got)]))
                rows[name] = row
            results[f"{'isotropic' if sigma is None else f'sigma={sigma}'}/qnoise={qnoise}"] = rows
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gallery-rows", type=int, default=127_166)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--rescore-width", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA card is available; pass --device cpu to run on the CPU")
    results = run(args.gallery_rows, args.queries, args.k, args.rescore_width, args.device,
                  args.seed)
    print(f"{'gallery/qnoise':>24s} {'config':>22s} {'r@1':>7s} {'r@5':>7s} {'r@10':>7s} "
          f"{'agree':>7s}")
    for key, rows in results.items():
        for name, row in rows.items():
            print(f"{key:>24s} {name:>22s} " + " ".join(
                f"{row.get(c, float('nan')):>7.4f}" for c in ("r@1", "r@5", "r@10", "agree")))
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
