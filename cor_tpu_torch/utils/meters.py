"""Meters and the training logger, the port's copies of
``cor_tpu.utils.meters``."""

from __future__ import annotations

import logging
import time
from collections import deque
from datetime import datetime
from pathlib import Path


class AverageMeter:
    """Cumulative mean, or the mean of the last ``window_size`` values."""

    def __init__(self, window_size: int = 0):
        self.window_size = window_size
        self.reset()

    def reset(self):
        self.count = 0
        self.total_sum = 0.0
        self._window = deque(maxlen=self.window_size or None)

    def update(self, value: float, n: int = 1):
        self.count += n
        self.total_sum += value * n
        self._window.append(value)

    @property
    def average(self) -> float:
        if self.window_size:
            return sum(self._window) / max(len(self._window), 1)
        return self.total_sum / max(self.count, 1)

    @property
    def value(self) -> float:
        """The most recent value."""
        return self._window[-1] if self._window else 0.0


def init_logger(log_dir, prefix: str = "train") -> logging.Logger:
    """A logger to a timestamped file under ``log_dir`` and to the console."""
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    logger = logging.getLogger(f"cor_tpu_torch.{prefix}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    fh = logging.FileHandler(Path(log_dir) / f"{prefix}_{stamp}.log")
    fh.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
    logger.addHandler(fh)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter("%(message)s"))
    logger.addHandler(sh)
    logger.propagate = False
    return logger


class StepTimer:
    """Wall-clock step timing and ETA strings."""

    def __init__(self):
        self.meter = AverageMeter()
        self._t0 = time.time()

    def tic(self):
        self._t0 = time.time()

    def toc(self) -> float:
        dt = time.time() - self._t0
        self.meter.update(dt)
        return dt

    def eta(self, remaining_steps: int) -> str:
        secs = int(self.meter.average * remaining_steps)
        h, rem = divmod(secs, 3600)
        m, s = divmod(rem, 60)
        return f"{h:d}:{m:02d}:{s:02d}"
