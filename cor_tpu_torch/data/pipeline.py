"""Batching with background prefetch, the PyTorch counterpart of
``cor_tpu.data.pipeline.DataLoader`` for the port's datasets.

Samples are made by a pool of ``num_workers`` threads and batched by
stacking each key. A synthetic sample draws a 1024 x 1024 x 3 normal image
(tens of ms on one host core); numpy's generators and casts release the GIL
on fills that large, so threads scale. At most ``num_workers + prefetch``
batches are in flight, and each is dropped once consumed. The manifest
dataset (``CORDataset``: decode and augment with PIL) is not ported yet
(ROADMAP Queue 1, item 10).
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from collections import deque
from typing import Dict, Iterator, List

import numpy as np


def collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    """Batches of ``batch_size`` consecutive samples, in order, the last one
    short when ``len(dataset)`` is not a multiple."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8, prefetch: int = 4):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def _batch(self, start: int) -> Dict[str, np.ndarray]:
        stop = min(start + self.batch_size, len(self.dataset))
        return collate([self.dataset[i] for i in range(start, stop)])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        done = object()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()

        def produce():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    starts = iter(range(0, len(self.dataset), self.batch_size))
                    pending: deque = deque()
                    while not cancel.is_set():
                        while len(pending) < self.num_workers + self.prefetch:
                            start = next(starts, None)
                            if start is None:
                                break
                            pending.append(pool.submit(self._batch, start))
                        if not pending:
                            break
                        q.put(pending.popleft().result())
                    for f in pending:
                        f.cancel()
                q.put(done)
            except Exception as e:  # a sample failed: raise it in the consumer
                q.put(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            cancel.set()
            while producer.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
