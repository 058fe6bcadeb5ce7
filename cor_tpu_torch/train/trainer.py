"""The epoch loop, the PyTorch counterpart of ``cor_tpu.train.trainer``.

- The learning rate of each epoch from the schedule, set before its steps.
- The loss meter (cumulative mean) and ETA logging every
  ``batch_record_interval`` batches; the step's loss is read only there, so
  the host does not wait for the card on every step.
- Periodic checkpoints every ``train_model_save_epoch`` epochs.
- ^C or SIGTERM: an emergency ``interrupted_checkpoint_epoch_N`` (during
  validation, the epoch's training being complete, ``checkpoint_epoch_N``).
- Validation: metric sums over the valid rows of each batch, divided by the
  count once per epoch; the best model on Dice + IoU is saved twice,
  ``best_model`` (parameters) and ``best_model_full`` (resumable).
- Batches are padded on the host to a multiple of ``grad_accum`` (a short
  last validation batch to the batch size), with ``valid`` 0 on the padding.

One device, no mesh: the parallel keys (``mesh_data``/``mesh_model`` > 1,
``mesh_stage`` > 1, ``seq_shard``, ``shard_optimizer_state``) and
``async_checkpoint`` are refused with the ROADMAP item that ports them.
"""

from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from cor_tpu_torch.models.core_model import check_kernel_dtype
from cor_tpu_torch.train.checkpoint import save_checkpoint
from cor_tpu_torch.train.step import BATCH_KEYS, TrainState, make_eval_step, make_train_step
from cor_tpu_torch.utils.meters import AverageMeter, StepTimer

PARALLEL_ITEM = "ROADMAP Queue 1, item 9 (parallel)"
ASYNC_CHECKPOINT_ITEM = "ROADMAP Queue 1, item 11 (training: the async checkpoint writer)"


def check_single_device(cfg) -> None:
    """Refuse the keys that need a mesh or a background writer."""
    parallel = [k for k, bad in (
        ("mesh_data", cfg.mesh_data not in (None, 1)), ("mesh_model", cfg.mesh_model > 1),
        ("mesh_stage", cfg.mesh_stage > 1), ("seq_shard", cfg.seq_shard),
        ("shard_optimizer_state", cfg.shard_optimizer_state)) if bad]
    if parallel:
        raise ValueError(f"{parallel} need a device mesh: cor_tpu_torch trains on one device "
                         f"({PARALLEL_ITEM})")
    if cfg.async_checkpoint:
        raise ValueError(f"async_checkpoint is not ported: checkpoints are written in the "
                         f"loop ({ASYNC_CHECKPOINT_ITEM})")


@dataclass
class BestTracker:
    """The best epoch on Dice + IoU."""

    best_score: float = float("-inf")
    best_epoch: int = -1
    best_metrics: Dict[str, float] = field(default_factory=dict)

    def update(self, epoch: int, metrics: Dict[str, float]) -> bool:
        score = metrics["dice"] + metrics["iou"]
        if score > self.best_score:
            self.best_score, self.best_epoch, self.best_metrics = score, epoch, dict(metrics)
            return True
        return False


class Trainer:
    def __init__(self, cfg, core_cfg, state: TrainState, lr_schedule: Callable[[int], float],
                 logger, device, writer=None, profile_steps: int = 0, profile_dir=None):
        check_single_device(cfg)
        check_kernel_dtype(core_cfg, device)
        self.cfg = cfg
        self.core_cfg = core_cfg
        self.state = state
        self.lr_schedule = lr_schedule
        self.logger = logger
        self.device = torch.device(device)
        self.writer = writer
        self.train_step = make_train_step(core_cfg, cfg.seed, grad_accum=cfg.grad_accum)
        self.eval_step = make_eval_step(core_cfg)
        self.best = BestTracker()
        # --profile N: a torch.profiler trace of the first N train steps
        self.profile_steps = profile_steps
        self.profile_dir = Path(profile_dir) if profile_dir is not None else None
        self._prof = None
        self._profiled = 0

    # ------------------------------------------------------------------
    def train_epoch(self, loader, epoch: int) -> float:
        cfg = self.cfg
        if hasattr(loader, "set_epoch"):
            loader.set_epoch(epoch)  # a resumed run continues the data order
        self.logger.info("=" * 35 + f" Training Epoch: {epoch} " + "=" * 35)
        lr = float(self.lr_schedule(epoch))
        self.state.model.train()
        loss_meter, timer = AverageMeter(), StepTimer()
        total_batches = len(loader)
        t_epoch = time.time()
        pending: list = []

        def drain():
            for v in pending:
                loss_meter.update(float(v))
            pending.clear()

        try:
            for batch_idx, batch in enumerate(loader, start=1):
                if self.profile_steps and self._prof is None:
                    self._start_profile()
                timer.tic()
                metrics = self.train_step(self.state, self._device_batch(batch), lr)
                pending.append(metrics["total_loss"])
                timer.toc()
                if self._prof is not None:
                    self._profiled += 1
                    if self._profiled >= self.profile_steps:
                        self._stop_profile()
                if batch_idx == 1 or batch_idx % cfg.batch_record_interval == 0 or \
                        batch_idx == total_batches:
                    drain()
                    self.logger.info(
                        f"[Epo: {epoch:03d}/{cfg.epoch:03d}] => "
                        f"[Batch: {batch_idx:04d}/{total_batches:04d}] => "
                        f"[BLoss: {loss_meter.value:.4f}] => [LAvgLoss: {loss_meter.average:.4f}] "
                        f"=> [Lr: {lr:g}] => [ETA: {timer.eta(total_batches - batch_idx)}]")
        except KeyboardInterrupt:
            self.logger.info("[Train Info]: Keyboard Interrupt: saving and exiting!")
            self._save(f"interrupted_checkpoint_epoch_{epoch}", epoch)
            raise
        drain()
        loss = loss_meter.average
        duration = time.time() - t_epoch
        self.logger.info(
            f"[Train Info]: [Epoch {epoch:03d}/{cfg.epoch:03d}], [LocalAvgLoss: {loss:.4f}], "
            f"[GlobalAvgLoss: {loss:.4f}], [Lr: {lr:g}], [Duration: {int(duration)}s]")
        if self.writer is not None:
            self.writer.add_scalar("Train/LearningRate", lr, epoch)
            self.writer.add_scalar("Train/LocalTotalLoss", loss, epoch)
            self.writer.add_scalar("Train/GlobalTotalLoss", loss, epoch)
            self.writer.add_scalar("Train/EpochDuration", duration, epoch)
        if epoch % cfg.train_model_save_epoch == 0:
            self._save(f"checkpoint_epoch_{epoch}", epoch, loss=loss)
        return loss

    # ------------------------------------------------------------------
    def val_epoch(self, loader, epoch: int) -> Dict[str, float]:
        self.logger.info("=" * 35 + f" Val Epoch: {epoch} " + "=" * 35)
        self.state.model.eval()
        sums = {k: 0.0 for k in ("dice", "mae", "iou", "mdice", "miou")}
        count = 0.0
        t_epoch = time.time()
        for batch in loader:
            batch_sums, n = self.eval_step(self.state.model, self._device_batch(batch))
            for k in sums:
                sums[k] += float(batch_sums[k])
            count += float(n)
        metrics = {k: v / max(count, 1.0) for k, v in sums.items()}
        duration = time.time() - t_epoch
        self.logger.info(
            f"[Val Info]: Epoch: {epoch}, "
            + ", ".join(f"Global {k.capitalize()}: {v:.4f}" for k, v in metrics.items())
            + f", [Duration: {int(duration)}s]")
        if self.writer is not None:
            for k, v in metrics.items():
                self.writer.add_scalar(f"Val/Global{k.capitalize()}", v, epoch)
            self.writer.add_scalar("Val/EpochDuration", duration, epoch)
        if self.best.update(epoch, metrics):
            self.logger.info(f"[Val Info]: New best model at epoch {epoch} "
                             f"(Dice+IoU = {self.best.best_score:.4f})")
            self._save("best_model", epoch, params_only=True)
            self._save("best_model_full", epoch)
        return metrics

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader, start_epoch: int = 1) -> BestTracker:
        def _sigterm(signum, frame):
            self.logger.warning("[Train Info]: SIGTERM: saving an emergency checkpoint")
            raise KeyboardInterrupt

        prev_handler = None
        try:
            prev_handler = signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            pass  # not the main thread
        try:
            for epoch in range(start_epoch, self.cfg.epoch + 1):
                self.train_epoch(train_loader, epoch)
                try:
                    self.val_epoch(val_loader, epoch)
                except KeyboardInterrupt:
                    # the epoch's training is complete: resume at the next one
                    self.logger.info("[Train Info]: Interrupt during validation: saving and "
                                     "exiting!")
                    self._save(f"checkpoint_epoch_{epoch}", epoch)
                    raise
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
            if self._prof is not None:  # --profile N outlasted the steps
                self._stop_profile()
        return self.best

    # ------------------------------------------------------------------
    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.profile_dir.mkdir(parents=True, exist_ok=True)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.logger.info(f"[Profile]: tracing {self.profile_steps} steps -> {self.profile_dir}")

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(str(self.profile_dir / "trace.json"))
        (self.profile_dir / "key_averages.txt").write_text(
            self._prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=40))
        self.logger.info(f"[Profile]: trace written to {self.profile_dir}")
        self._prof = None
        self.profile_steps = 0  # once

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The model's inputs on the device, padded on the host (the last row
        repeated) to a multiple of grad_accum and at least the batch size,
        with ``valid`` 1 on the real rows."""
        out = {k: np.asarray(batch[k]) for k in BATCH_KEYS}
        multiple = max(self.cfg.grad_accum, 1)
        target = -(-self.cfg.batch_size // multiple) * multiple
        n = out[BATCH_KEYS[0]].shape[0]
        size = -(-max(n, target) // multiple) * multiple
        pad = size - n
        if pad:
            out = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)]) for k, v in out.items()}
        out["valid"] = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        return {k: torch.from_numpy(v).to(self.device) for k, v in out.items()}

    def _save(self, name: str, epoch: int, loss: Optional[float] = None,
              params_only: bool = False) -> None:
        state = self.state
        payload = {"params": state.model.state_dict()}
        if not params_only:
            payload.update(opt_state=state.optimizer.state_dict(), step=state.step, epoch=epoch,
                           best_score=self.best.best_score, best_epoch=self.best.best_epoch)
            if loss is not None:
                payload["loss"] = loss
        path = save_checkpoint(self.cfg.train_model_save_path, name, payload)
        self.logger.info(f"[Train Info]: Saved checkpoint to {path}")
