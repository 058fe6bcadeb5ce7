"""``cor_tpu``'s Orbax checkpoint directories, read and written without
``orbax`` and without ``jax``: the port's own reader and writer of the
format that ``orbax.checkpoint.StandardCheckpointer`` writes.

A directory holds:

- ``_METADATA``: JSON whose ``tree_metadata`` maps each leaf's key path
  (the ``repr`` of a tuple of strings, e.g. ``"('params', 'a', 'w')"``) to
  its ``key_metadata`` (each key and its type: 1 a sequence index, 2 a dict
  key) and ``value_metadata`` (``value_type``; ``skip_deserialize`` for a
  ``None`` leaf); ``use_ocdbt`` and ``use_zarr3`` say how the arrays are
  stored;
- ``_CHECKPOINT_METADATA``: the handler's name and timestamps;
- the arrays: one zarr array a leaf, at the path of its keys joined by dots,
  in an OCDBT key-value database at the directory's root (``manifest.ocdbt``
  and its data files), or in plain files without OCDBT.

The arrays are read and written through ``tensorstore`` (which imports no
jax). It is imported at first use: where it is not installed (the card's
machine), an Orbax directory is refused naming the package.

``read_tree`` gives a checkpoint's tree (or some of its top-level entries)
as nested dicts and lists of numpy arrays, ``read_params`` its parameters;
``write_params`` writes a
parameters-only checkpoint, ``{"params": tree}``, the layout of
``cor_tpu``'s ``best_model``, which ``cor_tpu.utils.convert.
load_trained_params`` restores.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")
SEQUENCE_KEY, DICT_KEY = 1, 2


def is_orbax_checkpoint(path) -> bool:
    """A directory that Orbax wrote (or ``write_params``)."""
    path = Path(path)
    return path.is_dir() and ((path / METADATA).is_file()
                              or (path / CHECKPOINT_METADATA).is_file())


def tensorstore():
    """The ``tensorstore`` module, or an error naming it."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "reading or writing an Orbax checkpoint directory needs the 'tensorstore' package, "
            "which is not installed here; convert the checkpoint on a machine that has it "
            "(python -m cor_tpu_torch.cli.export)") from e
    return ts


def _kvstore(root: Path, key: str, ocdbt: bool) -> dict:
    if ocdbt:
        return {"driver": "ocdbt", "base": f"file://{root}", "path": key}
    return {"driver": "file", "path": str(root / key)}


def _leaf_entries(meta: dict) -> List[Tuple[List[Tuple[str, int]], dict]]:
    return [([(k["key"], int(k["key_type"])) for k in entry["key_metadata"]],
             entry["value_metadata"]) for entry in meta["tree_metadata"].values()]


def _insert(tree: dict, keys: List[Tuple[str, int]], value: Any) -> None:
    """Put ``value`` at ``keys`` into nested dicts (sequences kept as dicts
    keyed by int until ``_sequences``)."""
    node = tree
    for key, kind in keys[:-1]:
        node = node.setdefault(int(key) if kind == SEQUENCE_KEY else key, {})
    key, kind = keys[-1]
    node[int(key) if kind == SEQUENCE_KEY else key] = value


def _sequences(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    out = {k: _sequences(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def read_tree(path, keys: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The checkpoint's tree of numpy arrays (``None`` leaves kept): a dict
    of its top-level entries, or of those among ``keys`` that it holds."""
    root = Path(path).absolute()
    meta_path = root / METADATA
    if not meta_path.is_file():
        raise ValueError(f"{root} is not an Orbax checkpoint directory (no {METADATA})")
    meta = json.loads(meta_path.read_text())
    ts = tensorstore()
    ocdbt = bool(meta.get("use_ocdbt", True))
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    ctx = ts.Context()
    tree: dict = {}
    pending = []
    for leaf_keys, value_md in _leaf_entries(meta):
        if keys is not None and leaf_keys[0][0] not in keys:
            continue
        if value_md.get("skip_deserialize") or value_md.get("value_type") == "None":
            _insert(tree, leaf_keys, None)
            continue
        name = ".".join(k for k, _ in leaf_keys)
        store = ts.open({"driver": driver, "kvstore": _kvstore(root, name, ocdbt)},
                        open=True, context=ctx)
        pending.append((leaf_keys, store))
    for leaf_keys, store in pending:
        _insert(tree, leaf_keys, np.asarray(store.result().read().result()))
    return _sequences(tree)


def read_params(path) -> Any:
    """A checkpoint's parameters: its ``params`` subtree where it has one (a
    full training state, or ``best_model``), else its whole tree, as
    ``cor_tpu.utils.convert.load_trained_params`` takes them."""
    tree = read_tree(path, ("params",))
    return tree["params"] if "params" in tree else read_tree(path)


def _flatten(node: Any, keys: Tuple[Tuple[str, int], ...] = ()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _flatten(v, keys + ((str(k), DICT_KEY),))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _flatten(v, keys + ((str(i), SEQUENCE_KEY),))
    else:
        yield keys, node


def write_params(path, params: Any) -> Path:
    """Write ``{"params": params}`` (nested dicts and lists of arrays, e.g.
    ``utils/weights.to_cor_tpu_tree``'s) as an Orbax checkpoint directory
    at ``path``, replacing it: zarr arrays (zstd, one chunk a leaf) in an
    OCDBT database, and the metadata files. The directory is written under
    a temporary name and renamed into place."""
    ts = tensorstore()
    path = Path(path).absolute()
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    started = time.time_ns()
    ctx = ts.Context()
    tree_md: Dict[str, dict] = {}
    writes = []
    for keys, leaf in _flatten({"params": params}):
        arr = np.asarray(leaf, order="C")  # ascontiguousarray would make a scalar 1-d
        names = tuple(k for k, _ in keys)
        tree_md[repr(names)] = {
            "key_metadata": [{"key": k, "key_type": kind} for k, kind in keys],
            "value_metadata": {"value_type": "np.ndarray", "skip_deserialize": False}}
        store = ts.open({
            "driver": "zarr", "kvstore": _kvstore(tmp, ".".join(names), True),
            "metadata": {"shape": list(arr.shape), "chunks": [max(d, 1) for d in arr.shape],
                         "dtype": arr.dtype.str, "compressor": {"id": "zstd", "level": 1},
                         "fill_value": None, "order": "C", "filters": None,
                         "dimension_separator": "."}},
            create=True, context=ctx).result()
        writes.append(store.write(arr))
    for w in writes:
        w.result()
    (tmp / METADATA).write_text(json.dumps({
        "tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (tmp / CHECKPOINT_METADATA).write_text(json.dumps({
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path
