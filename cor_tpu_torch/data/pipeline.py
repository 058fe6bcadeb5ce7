"""Batching with background prefetch, the PyTorch counterpart of
``cor_tpu.data.pipeline.DataLoader`` for the port's datasets.

Samples are made by a pool of ``num_workers`` threads and batched by
stacking each key. ``shuffle`` permutes the order with
``np.random.default_rng((seed, epoch))`` and ``drop_last`` drops a short last
batch, as ``cor_tpu``'s loader does; ``set_epoch`` pins the epoch (a resumed
run continues the uninterrupted run's order), which otherwise counts the
passes from 0. A synthetic sample draws a 1024 x 1024 x 3 normal image
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
    """Batches of ``batch_size`` samples, in order (or shuffled), the last one
    short when ``len(dataset)`` is not a multiple (or dropped)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8, prefetch: int = 4,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 42):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def _batch(self, idxs) -> Dict[str, np.ndarray]:
        return collate([self.dataset[int(i)] for i in idxs])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        self.epoch += 1
        batches = [order[i:i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        done = object()
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()

        def produce():
            try:
                with cf.ThreadPoolExecutor(self.num_workers) as pool:
                    todo = iter(batches)
                    pending: deque = deque()
                    while not cancel.is_set():
                        while len(pending) < self.num_workers + self.prefetch:
                            idxs = next(todo, None)
                            if idxs is None:
                                break
                            pending.append(pool.submit(self._batch, idxs))
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
