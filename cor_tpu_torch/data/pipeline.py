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
batches are in flight, and each is dropped once consumed.

The manifest side, the counterpart of ``cor_tpu.data.pipeline``'s:
``load_manifest`` reads a COR127K triplet CSV (``REQUIRED_COLUMNS``; rows
with ``Compose == 0``) with the standard library's ``csv`` and types each
column as pandas' ``read_csv`` does wherever a value reaches a path, a
sample or the metric CSV: a column whose values are all integers is int64
(``Id``; a zero-padded ``Target`` such as ``007`` becomes 7, so its folder
is ``7``), one with a missing value among numbers float64, one of
True/False bool, any other text, pandas' NA spellings (an empty cell among
them) read as NaN (text ``"nan"``). ``CORDataset`` decodes PNGs with the
port's reader (``utils/png.py``; JPEG through Pillow where it is installed)
and resizes with the ``preproc`` library (Pillow's BILINEAR, bit for bit).
With ``train=True`` it augments the query image and mask at their native
size after decoding (``data/augment.py``, drawn from
``np.random.default_rng((seed, epoch, idx))``; ``native_hw`` is the mask's
size before the augmentation), and the ``DataLoader`` sets the dataset's
``epoch`` to its own at each pass, so each epoch draws afresh.
``get_train_loader`` shuffles a split and drops the short last batch;
``get_valid_loader`` batches one in manifest order.
"""

from __future__ import annotations

import concurrent.futures as cf
import csv
import queue
import re
import threading
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


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
        if hasattr(self.dataset, "epoch"):
            self.dataset.epoch = self.epoch  # fresh augmentation draws each epoch
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


# ---------------------------------------------------------------------------
# the manifest
# ---------------------------------------------------------------------------

REQUIRED_COLUMNS = ("Id", "Compose", "Dataset", "Target", "Query_img", "Query_mask",
                    "Support_img", "Support_mask", "Text")
# pandas' default NA spellings (read_csv's na_values)
NA_VALUES = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"})
_INT = re.compile(r"[+-]?[0-9]+$")
_TRUE, _FALSE = ("True", "TRUE", "true"), ("False", "FALSE", "false")


def _is_float(text: str) -> bool:
    try:
        float(text)
    except ValueError:
        return False
    return True


def _typed_column(values: List[str]) -> List[Any]:
    """One column's cells typed as pandas' ``read_csv`` types them: int64,
    float64 (a missing value among numbers, or a decimal), bool, else text;
    NA spellings are NaN."""
    present = [v for v in values if v not in NA_VALUES]
    nan = float("nan")
    if present and all(_INT.match(v) for v in present):
        if len(present) == len(values):
            return [int(v) for v in values]
        return [nan if v in NA_VALUES else float(int(v)) for v in values]
    if present and all(_is_float(v) for v in present):
        return [nan if v in NA_VALUES else float(v) for v in values]
    if present and len(present) == len(values) and all(v in _TRUE + _FALSE for v in values):
        return [v in _TRUE for v in values]
    return [nan if v in NA_VALUES else v for v in values]


class Manifest:
    """A triplet CSV's rows (dicts of typed values) in file order."""

    def __init__(self, columns: List[str], rows: List[Dict[str, Any]]):
        self.columns = list(columns)
        self.rows = rows

    def __len__(self) -> int:
        return len(self.rows)

    def column(self, name: str) -> List[Any]:
        return [r[name] for r in self.rows]

    def head(self, n: int) -> "Manifest":
        return Manifest(self.columns, self.rows[:n])


def load_manifest(csv_path, compose_filter: int = 0) -> Manifest:
    """Read the triplet CSV and keep the rows with ``Compose ==
    compose_filter``."""
    with open(csv_path, newline="", encoding="utf-8-sig") as f:
        lines = [r for r in csv.reader(f) if r]
    if not lines:
        raise ValueError(f"Manifest {csv_path} is empty")
    columns, cells = lines[0], lines[1:]
    missing = [c for c in REQUIRED_COLUMNS if c not in columns]
    if missing:
        raise ValueError(f"Manifest {csv_path} missing columns: {missing}")
    for n, r in enumerate(cells, start=2):
        if len(r) > len(columns):
            raise ValueError(f"Manifest {csv_path} line {n}: {len(r)} fields, the header "
                             f"has {len(columns)}")
    typed = {c: _typed_column([r[i] if i < len(r) else "" for r in cells])
             for i, c in enumerate(columns)}
    rows = [{c: typed[c][j] for c in columns} for j in range(len(cells))]
    return Manifest(columns, [r for r in rows if r["Compose"] == compose_filter])


# ---------------------------------------------------------------------------
# the manifest dataset
# ---------------------------------------------------------------------------


def _to_float_img(img: np.ndarray, size: int, normalize: bool) -> np.ndarray:
    """uint8 [H, W] or [H, W, 3] -> float32 [size, size, C]: Pillow's
    BILINEAR resize, then /255 and (with ``normalize``) the ImageNet
    mean/std, in one call of the ``preproc`` library."""
    from cor_tpu_torch.native.preproc import resize_normalize_f32

    return resize_normalize_f32(img, size, size, IMAGENET_MEAN if normalize else None,
                                IMAGENET_STD if normalize else None)


@dataclass
class CORDataset:
    """Map-style dataset over a COR127K manifest: the samples of
    ``cor_tpu.data.pipeline.CORDataset``, key for key (with ``train``, the
    same augmentation draws for the same ``seed``, ``epoch`` and index)."""

    csv_path: str
    dataset_path: str
    train: bool = False
    query_img_size: int = 1024
    support_img_size: int = 384
    tokenizer_path: Optional[str] = None
    context_length: int = 64
    seed: int = 42
    capitalized_dirs: bool = False  # the reference's single-test layout: Image/, Mask/
    limit: Optional[int] = None
    epoch: int = 0
    vocab_size: int = 32000  # the hash tokenizer's, where no tokenizer_path is set

    def __post_init__(self):
        from cor_tpu_torch.data.tokenizer import get_tokenizer

        self.df = load_manifest(self.csv_path)
        if self.limit is not None and self.limit < 1:
            raise ValueError(f"limit must be a positive row count, got {self.limit}")
        if self.limit:
            self.df = self.df.head(self.limit)
        self.tokenizer = get_tokenizer(self.tokenizer_path, self.context_length, self.vocab_size)
        self._img_dir = "Image" if self.capitalized_dirs else "image"
        self._mask_dir = "Mask" if self.capitalized_dirs else "mask"

    def __len__(self) -> int:
        return len(self.df)

    def _paths(self, row) -> Dict[str, Path]:
        root = Path(self.dataset_path) / str(row["Dataset"])
        return {
            "query_img": root / self._img_dir / row["Query_img"],
            "query_mask": root / self._mask_dir / str(row["Target"]) / row["Query_mask"],
            "support_img": root / self._img_dir / row["Support_img"],
            "support_mask": root / self._mask_dir / "sup" / row["Support_mask"],
        }

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        from cor_tpu_torch.data.augment import train_augment
        from cor_tpu_torch.utils.png import read_image

        row = self.df.rows[idx]
        paths = self._paths(row)
        q_img = read_image(paths["query_img"], "RGB")
        q_mask = read_image(paths["query_mask"], "L")
        native_hw = np.array(q_mask.shape[:2], np.int32)
        if self.train:
            # (seed, epoch, idx): the same draws in every run, fresh each epoch
            rng = np.random.default_rng((self.seed, self.epoch, idx))
            q_img, q_mask = train_augment(q_img, q_mask, rng)
        return {
            "pair_id": np.int64(row["Id"]),
            "query_img": _to_float_img(q_img, self.query_img_size, True),
            "query_mask": _to_float_img(q_mask, self.query_img_size, False),
            "support_img": _to_float_img(read_image(paths["support_img"], "RGB"),
                                         self.support_img_size, True),
            "support_mask": _to_float_img(read_image(paths["support_mask"], "L"),
                                          self.support_img_size, False),
            "text": self.tokenizer(str(row["Text"]))[0],
            "native_hw": native_hw,
            "query_mask_path": str(paths["query_mask"]),
        }


def model_sizes(core_cfg) -> Dict[str, int]:
    """The sample sizes the model takes: the query and support image sizes,
    the text context and the hash tokenizer's vocab. Without a model config,
    none: ``CORDataset``'s defaults (1024, 384, 64, 32000), the flagship
    model's."""
    if core_cfg is None:
        return {}
    text = core_cfg.support.siglip.text
    return dict(query_img_size=core_cfg.encoder.img_size,
                support_img_size=core_cfg.support.siglip.vision.image_size,
                context_length=text.context_length, vocab_size=text.vocab_size)


def valid_dataset(cfg, csv_path=None, tokenizer_path=None, limit: Optional[int] = None,
                  core_cfg=None) -> CORDataset:
    """A split's ``CORDataset(train=False)``, sized by ``model_sizes``."""
    return CORDataset(csv_path=csv_path or getattr(cfg, "val_csv", None),
                      dataset_path=cfg.dataset_path, train=False,
                      tokenizer_path=tokenizer_path or getattr(cfg, "tokenizer_path", None),
                      limit=limit, **model_sizes(core_cfg))


def get_train_loader(cfg, tokenizer_path=None, core_cfg=None) -> DataLoader:
    """The training split (``cfg.train_csv``) as ``CORDataset(train=True,
    seed=cfg.seed)``, sized by ``model_sizes``, in batches of
    ``cfg.batch_size``: shuffled by ``(seed, epoch)``, the short last batch
    dropped. One device reads the whole split (no shards)."""
    ds = CORDataset(csv_path=cfg.train_csv, dataset_path=cfg.dataset_path, train=True,
                    tokenizer_path=tokenizer_path or getattr(cfg, "tokenizer_path", None),
                    seed=cfg.seed, **model_sizes(core_cfg))
    return DataLoader(ds, cfg.batch_size, num_workers=cfg.num_workers, shuffle=True,
                      drop_last=True, seed=cfg.seed)


def get_valid_loader(cfg, csv_path=None, tokenizer_path=None, limit: Optional[int] = None,
                     core_cfg=None) -> DataLoader:
    """A split's loader in manifest order (unshuffled, the last batch
    short): ``valid_dataset``'s samples in batches of ``cfg.batch_size``."""
    return DataLoader(valid_dataset(cfg, csv_path, tokenizer_path, limit, core_cfg),
                      cfg.batch_size, num_workers=cfg.num_workers)
