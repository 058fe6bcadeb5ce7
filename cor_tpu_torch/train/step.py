"""The train, eval and predict steps, the PyTorch counterpart of
``cor_tpu.train.step``.

A train step is the forward in the compute dtype (``core_forward`` with
``train=True``: bf16 copies of the fp32 masters), the fp32 loss, the
backward, the gradient's global norm (over every leaf, before clipping, as
``optax.global_norm`` reads it), the element-wise clamp and one optimizer
update of the masters, in place. With ``grad_accum > 1`` the batch is split
into that many microbatches whose gradients are accumulated in the masters'
fp32 ``.grad``, each weighted by its count of valid rows, before the one
update (cor_tpu's ``lax.scan`` over microbatches): only one microbatch's
activations are alive at a time. The dropouts draw from a ``torch.Generator``
seeded from (seed, step, microbatch); ``cor_tpu`` folds the step and the
microbatch into its key the same way, but its bits are JAX's.

Eval steps return per-batch (sums, count) so that padded rows (``valid``
0) drop out of the epoch means.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from cor_tpu_torch.models.core_model import CoreConfig, CoreModel, core_forward
from cor_tpu_torch.ops.resize import resize_bilinear
from cor_tpu_torch.train.losses import core_total_loss
from cor_tpu_torch.train.metrics import all_soft_metrics, normalize_prediction
from cor_tpu_torch.train.optim import MaskedOptimizer

BATCH_KEYS = ("query_img", "query_mask", "support_img", "support_mask", "text")


@dataclass
class TrainState:
    model: CoreModel  # fp32 masters, updated in place
    optimizer: MaskedOptimizer
    step: int = 0  # optimizer steps taken


def dropout_generator(seed: int, step: int, micro: int, device) -> torch.Generator:
    """The generator of one (micro)batch's dropout draws."""
    s = int(np.random.SeedSequence((seed, step, micro)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & (2**63 - 1))


def train_loss(cfg: CoreConfig, model: CoreModel, batch: Dict[str, torch.Tensor],
               generator=None):
    """(total, {seg, fg, bg, total}_loss) of one forward with ``train=True``."""
    pred, qemb, sfeat = core_forward(
        model, batch["query_img"], batch["support_img"], batch["text"], batch["support_mask"],
        cfg, train=True, generator=generator)
    return core_total_loss(pred.permute(0, 2, 3, 1), batch["query_mask"], qemb, sfeat,
                           valid=batch.get("valid"))


def make_train_step(cfg: CoreConfig, seed: int = 0, grad_accum: int = 1):
    """Returns train_step(state, batch, lr) -> metrics: the loss terms
    ({seg, fg, bg, total}_loss, means over the valid rows) and grad_norm, as
    0-d tensors on the model's device (reading them waits for the step)."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor], lr: float):
        model = state.model
        device = next(model.parameters()).device
        for p in state.optimizer.params:
            p.grad = None
        if grad_accum == 1:
            gen = dropout_generator(seed, state.step, 0, device)
            total, aux = train_loss(cfg, model, batch, gen)
            total.backward()
            aux = {k: v.detach() for k, v in aux.items()}
        else:
            b = batch[BATCH_KEYS[0]].shape[0]
            if b % grad_accum:
                raise ValueError(f"batch {b} is not divisible by grad_accum={grad_accum} "
                                 "(the trainer pads to a multiple of it)")
            m = b // grad_accum
            aux, w_acc = {}, 0.0
            for a in range(grad_accum):
                mb = {k: v[a * m:(a + 1) * m] for k, v in batch.items()}
                w = mb["valid"].float().sum() if "valid" in mb else torch.tensor(
                    float(m), device=device)
                gen = dropout_generator(seed, state.step, a, device)
                total, parts = train_loss(cfg, model, mb, gen)
                (w * total).backward()
                for k, v in parts.items():
                    aux[k] = aux.get(k, 0.0) + w * v.detach()
                w_acc = w_acc + w
            w_acc = w_acc.clamp_min(1.0)
            for p in state.optimizer.params:
                if p.grad is not None:
                    p.grad.div_(w_acc)
            aux = {k: v / w_acc for k, v in aux.items()}
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        aux["grad_norm"] = (torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in grads])) if grads
            else torch.zeros((), device=device))
        state.optimizer.update(lr)
        state.step += 1
        return aux

    return train_step


def _pred_nhwc(cfg: CoreConfig, model: CoreModel, batch) -> torch.Tensor:
    pred, _, _ = core_forward(model, batch["query_img"], batch["support_img"], batch["text"],
                              batch["support_mask"], cfg, train=False)
    return pred.permute(0, 2, 3, 1)


def make_eval_step(cfg: CoreConfig):
    """Returns eval_step(model, batch) -> ({metric: sum over valid rows},
    count): the logits upsampled to the mask's resolution, sigmoid,
    per-sample min-max renormalised, then the five soft metrics."""

    @torch.inference_mode()
    def eval_step(model: CoreModel, batch) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        gt = batch["query_mask"].float()
        pred = resize_bilinear(_pred_nhwc(cfg, model, batch), tuple(gt.shape[1:3]))
        per_sample = all_soft_metrics(normalize_prediction(pred), gt)
        valid = batch.get("valid")
        valid = torch.ones(gt.shape[0], device=gt.device) if valid is None else valid.float()
        return {k: (v * valid).sum() for k, v in per_sample.items()}, valid.sum()

    return eval_step


def make_predict_step(cfg: CoreConfig):
    """Returns predict(model, batch) -> normalised probabilities [B, H, W, 1]
    at the decoder's resolution."""

    @torch.inference_mode()
    def predict(model: CoreModel, batch) -> torch.Tensor:
        return normalize_prediction(_pred_nhwc(cfg, model, batch))

    return predict
