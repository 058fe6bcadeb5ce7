"""The weight bridge: a ``cor_tpu`` parameter tree -> the port's modules, and
back.

A ``cor_tpu`` tree is nested dicts and lists of arrays (numpy, or anything
``np.asarray`` takes), e.g. ``init_core_model(...)["support_branch"]``. The
port's modules name their parameters after that tree's paths (list items by
index), so ``blocks[3]["attn"]["qkv"]["w"]`` is the parameter
``blocks.3.attn.qkv.w``. Every layout conversion lives here:

- a dense weight (``w`` of a ``Dense``) goes from [in, out] to [out, in];
- a convolution weight (``w`` of a ``Conv2d``) goes from HWIO to OIHW;
- everything else is copied as it is, the mask decoder's transposed-conv
  ``w`` (kept in ``cor_tpu``'s [C_in, 2, 2, C_out]) and its token and PE
  leaves included.

Loading fails if a leaf of the tree is left unused, if a parameter (or
buffer: the PE matrix) of the module is left unset, or if a converted shape
disagrees. Values keep the parameter's dtype, so a tree loads into a
training model as its fp32 masters. ``to_cor_tpu_tree`` is the reverse: a
module's parameters and buffers as a ``cor_tpu`` tree of fp32 numpy leaves,
in ``cor_tpu``'s layouts (copies: later updates of the module do not
reach them).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from cor_tpu_torch.ops.common import Conv2d, Dense


def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> {"a.b.0.c": array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _leaves(module: nn.Module) -> Dict[str, torch.Tensor]:
    """Every parameter and buffer of ``module`` by name."""
    return {**dict(module.named_parameters()), **dict(module.named_buffers())}


def to_port_layout(owner: nn.Module, leaf: str, arr: np.ndarray) -> np.ndarray:
    """Convert one ``cor_tpu`` leaf to the layout of the port parameter
    ``leaf`` of module ``owner``."""
    if leaf == "w" and isinstance(owner, Dense):
        return arr.T
    if leaf == "w" and isinstance(owner, Conv2d):
        return arr.transpose(3, 2, 0, 1)
    return arr


@torch.no_grad()
def load_cor_tpu_params(module: nn.Module, tree: Any) -> nn.Module:
    """Copy a ``cor_tpu`` parameter tree into ``module`` (in place; returns it).
    Values keep the parameter's dtype and device."""
    flat = flatten_tree(tree)
    params = _leaves(module)
    unused = sorted(set(flat) - set(params))
    unset = sorted(set(params) - set(flat))
    if unused or unset:
        raise ValueError(
            f"weight bridge: cor_tpu leaves without a port parameter: {unused}; "
            f"port parameters without a cor_tpu leaf: {unset}"
        )
    for name, arr in flat.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name) if owner_name else module
        value = np.ascontiguousarray(to_port_layout(owner, leaf, arr))
        p = params[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(
                f"weight bridge: {name} is {tuple(arr.shape)} in cor_tpu, which converts to "
                f"{tuple(value.shape)}; the port parameter is {tuple(p.shape)}"
            )
        p.copy_(torch.from_numpy(value.astype(np.float32)).to(p.dtype))
    return module


def to_cor_tpu_tree(module: nn.Module, state=None) -> Any:
    """The module's parameters and buffers as a ``cor_tpu`` tree: nested
    dicts, and lists where a path component is an index; fp32 numpy leaves
    in ``cor_tpu``'s layouts (the inverse of ``to_port_layout``). With
    ``state`` (a state dict of the module, e.g. a checkpoint's), its values
    instead: the module then only gives the layouts (it may live on the
    ``meta`` device), and the keys must be the module's own."""
    if state is not None:
        want = set(_leaves(module))
        if set(state) != want:
            raise ValueError(
                f"weight bridge: state keys without a port parameter: "
                f"{sorted(set(state) - want)[:10]}; port parameters without a state key: "
                f"{sorted(want - set(state))[:10]}")
    tree: Dict[str, Any] = {}
    for name, t in (_leaves(module) if state is None else state).items():
        arr = to_cor_tpu_layout(module, name, t.detach().cpu().float().numpy().copy())
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.ascontiguousarray(arr)
    return _lists(tree)


def to_cor_tpu_layout(module: nn.Module, name: str, arr: np.ndarray) -> np.ndarray:
    """The value (or gradient) ``arr`` of ``module``'s parameter ``name`` in
    ``cor_tpu``'s layout."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    if leaf == "w" and isinstance(owner, Dense):
        return arr.T
    if leaf == "w" and isinstance(owner, Conv2d):
        return arr.transpose(2, 3, 1, 0)
    return arr


def _lists(node: Any) -> Any:
    """Dicts keyed 0 .. n-1 -> lists, recursively."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out) and sorted(map(int, out)) == list(range(len(out))):
        return [out[str(i)] for i in range(len(out))]
    return out
