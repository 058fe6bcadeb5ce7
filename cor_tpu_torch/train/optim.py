"""Freezing, value clipping, the epoch schedules and the optimizers, the
PyTorch counterpart of ``cor_tpu.train.optim``.

- Freezing: the reference freezes the SigLIP towers, the image encoder and
  the IoU head (``FROZEN_PREFIXES``, with ``freeze_towers``); the PE matrix
  is a buffer and never trains. ``cor_tpu`` masks the frozen leaves out of its optax
  chain (``optax.masked``); here the optimizer holds the trainable
  parameters only and the frozen ones stop requiring grad, so they take no
  update and no weight decay either way.
- Clipping clamps each gradient element to [-clip, clip] (not a norm clip).
- Schedules give the learning rate of an epoch (epochs count from 1), set
  on the optimizer for every step of that epoch.
- AdamW (weight decay 1e-2), Adam (betas 0.9, 0.999, eps 1e-8) and SGD with
  momentum 0.9: ``torch.optim``'s, which update as optax's do.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

FROZEN_PREFIXES = (
    ("image_encoder",),
    ("support_branch", "siglip"),
    ("mask_decoder", "iou_prediction_head"),
)


def is_trainable(name: str, freeze_towers: bool = True) -> bool:
    """Whether the parameter ``name`` (dotted, e.g. ``image_encoder.blocks.0
    .attn.qkv.w``) receives updates."""
    path = tuple(name.split("."))
    return not freeze_towers or not any(path[: len(p)] == p for p in FROZEN_PREFIXES)


def trainable_mask(model: nn.Module, freeze_towers: bool = True) -> Dict[str, bool]:
    """{name: trainable} over every parameter and buffer (the PE matrix's
    leaf is in ``cor_tpu``'s tree, so it is counted here, never trainable)."""
    names = [n for n, _ in model.named_parameters()]
    mask = {n: is_trainable(n, freeze_towers) for n in names}
    mask.update({n: False for n, _ in model.named_buffers()})
    return mask


def count_params(model: nn.Module, mask: Dict[str, bool] = None) -> int:
    leaves = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return sum(t.numel() for n, t in leaves.items() if mask is None or mask[n])


def make_lr_schedule(
    name: str,
    base_lr: float,
    epochs: int,
    lr_decay_rate: float = 0.1,
    lr_decay_epoch: int = 50,
) -> Callable[[int], float]:
    """lr(epoch), epochs counted from 1 as the reference's
    ``scheduler.step(epoch)``; every schedule floors at 0.1 lr."""
    name = str(name)
    eta_min = 0.1 * base_lr

    def cosine(epoch):
        t = min(max(epoch, 0), epochs)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t / epochs))

    def cosine_warm_restarts(epoch, t0=10, t_mult=2.0):
        e = float(epoch)
        n = math.floor(math.log2(e / t0 * (t_mult - 1.0) + 1.0))
        t_start = t0 * (t_mult**n - 1.0) / (t_mult - 1.0)
        t_i = t0 * t_mult**n
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * (e - t_start) / t_i))

    def timm_cosine(epoch, warmup=5):
        # linear warmup 0.1 lr -> lr over 5 epochs, then a cosine to 0.1 lr
        # over the remaining epochs (timm's warmup_prefix)
        e = float(epoch)
        if e < warmup:
            return eta_min + (base_lr - eta_min) * e / warmup
        t = min(max((e - warmup) / max(epochs - warmup, 1), 0.0), 1.0)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t))

    def exponential(epoch):
        return base_lr * 0.95**epoch

    def step_decay(epoch):
        return base_lr * lr_decay_rate ** (int(epoch) // lr_decay_epoch)

    if name == "CosineAnnealingLR":
        return cosine
    if name == "CosineAnnealingWarmRestarts":
        return cosine_warm_restarts
    if name in ("TimmCosineLRScheduler", "CosineLRScheduler"):
        return timm_cosine
    if name == "ExponentialLR":
        return exponential
    if name in ("StepLR", "adjust_lr"):
        if lr_decay_epoch <= 0:
            raise ValueError(f"StepLR needs lr_decay_epoch > 0, got {lr_decay_epoch}")
        return step_decay
    if name in ("None", "none", ""):
        return lambda epoch: float(base_lr)
    raise ValueError(f"Unknown lr_scheduler: {name}")


class MaskedOptimizer:
    """A ``torch.optim`` optimizer over the trainable parameters, preceded by
    the element-wise gradient clamp (cor_tpu's ``optax.masked(chain(clip,
    base))``)."""

    def __init__(self, optimizer: torch.optim.Optimizer, params: List[nn.Parameter],
                 gradient_clip: float):
        self.optimizer = optimizer
        self.params = params
        self.gradient_clip = gradient_clip

    def update(self, lr: float) -> None:
        """Clamp the gradients and take one step at ``lr``."""
        nn.utils.clip_grad_value_(self.params, self.gradient_clip)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)


def make_optimizer(
    model: nn.Module,
    optimizer: str = "AdamW",
    lr: float = 1e-4,
    lr_scheduler: str = "None",
    epochs: int = 15,
    gradient_clip: float = 0.5,
    weight_decay: float = 1e-2,
    freeze_towers: bool = True,
    lr_decay_rate: float = 0.1,
    lr_decay_epoch: int = 50,
) -> Tuple[MaskedOptimizer, Callable[[int], float]]:
    """(optimizer, lr schedule). Sets ``requires_grad`` of every parameter of
    ``model`` to its trainable flag, so that no graph is built through the
    frozen ones."""
    schedule = make_lr_schedule(lr_scheduler, lr, epochs, lr_decay_rate, lr_decay_epoch)
    mask = trainable_mask(model, freeze_towers)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    if optimizer == "AdamW":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise ValueError(f"Unknown optimizer: {optimizer}")
    return MaskedOptimizer(opt, params, gradient_clip), schedule
