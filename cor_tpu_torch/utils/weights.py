"""The weight bridge: a ``cor_tpu`` parameter tree -> the port's modules.

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

Loading fails if a leaf of the tree is left unused, if a parameter of the
module is left unset, or if a converted shape disagrees.
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
    params = dict(module.named_parameters())
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
