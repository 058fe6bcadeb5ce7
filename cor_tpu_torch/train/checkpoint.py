"""Checkpoints, the PyTorch counterpart of ``cor_tpu.train.checkpoint``.

A checkpoint is a directory ``{train_model_save_path}/{name}`` holding one
``state.pt`` (``torch.save``): ``params`` (the model's fp32 state dict),
and, in a full save, ``opt_state``, ``step``, ``epoch``, ``best_score``,
``best_epoch`` and ``loss``, under ``cor_tpu``'s names
(``checkpoint_epoch_N``, ``interrupted_checkpoint_epoch_N``, ``best_model``,
``best_model_full``). A save writes a temporary directory and renames it into
place, so a cut-off save never leaves a half-written checkpoint under a
resumable name. ``CheckpointWriter`` (``async_checkpoint``) writes in a
background thread from a host copy of the payload, so training goes on
while the file is written. The resume rules are ``cor_tpu``'s
(``resolve_resume``). ``cor_tpu``'s Orbax directories are read and written
by ``utils/orbax.py`` (parameters only).
"""

from __future__ import annotations

import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def save_checkpoint(directory, name: str, payload: Dict[str, Any]) -> Path:
    """Write ``payload`` as ``directory/name/state.pt``, replacing it."""
    path = Path(directory).absolute() / name
    tmp = path.with_name(f".{name}.{os.getpid()}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(payload, tmp / STATE_FILE)
    if path.exists():
        shutil.rmtree(path)
    os.replace(tmp, path)
    return path


def host_snapshot(payload: Any) -> Any:
    """A copy of ``payload`` whose tensors are fresh CPU tensors: nested
    dicts, lists and tuples are rebuilt, other values kept. Training changes
    the model's and the optimizer's tensors in place, so a background write
    must not hold references to them."""
    if isinstance(payload, torch.Tensor):
        return payload.detach().to("cpu", copy=True)
    if isinstance(payload, dict):
        return {k: host_snapshot(v) for k, v in payload.items()}
    if isinstance(payload, (list, tuple)):
        return type(payload)(host_snapshot(v) for v in payload)
    return payload


class CheckpointWriter:
    """The training loop's checkpoint writer, ``cor_tpu``'s
    ``CheckpointWriter`` on ``torch.save``.

    With ``async_save`` a ``save`` copies the payload to host memory
    (``host_snapshot``) and returns; a background thread writes it with
    ``save_checkpoint``. Saves are serialised: a save first waits for the
    one before it, so at most one write is in flight and a directory is
    never replaced under its own pending write. ``wait()`` drains the
    writer. An error in the writer thread is raised by the next ``save`` or
    ``wait``, never dropped. Without ``async_save`` a save writes before it
    returns."""

    def __init__(self, async_save: bool = False):
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._pending: Optional[Path] = None

    def save(self, directory, name: str, payload: Dict[str, Any]) -> Path:
        self.wait()
        if not self.async_save:
            return save_checkpoint(directory, name, payload)
        snapshot = host_snapshot(payload)
        path = Path(directory).absolute() / name

        def write():
            try:
                save_checkpoint(directory, name, snapshot)
            except Exception as e:  # raised by the next save or wait
                self._error = e

        self._pending = path
        self._thread = threading.Thread(target=write, name=f"checkpoint-{name}")
        self._thread.start()
        return path

    def wait(self) -> None:
        """Block until the pending write (if any) is on disk; raise its
        error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        path, self._pending = self._pending, None
        if error is not None:
            raise RuntimeError(f"the background write of the checkpoint {path} failed: "
                               f"{error!r}") from error


def restore_checkpoint(directory, name: str) -> Dict[str, Any]:
    """The payload of ``directory/name``, tensors on the CPU."""
    return torch.load(Path(directory).absolute() / name / STATE_FILE, map_location="cpu",
                      weights_only=True)


def latest_epoch_checkpoint(directory) -> Optional[str]:
    """The checkpoint a run resumes from: of the periodic
    ``checkpoint_epoch_N`` (epoch N complete: resume at N + 1) and emergency
    ``interrupted_checkpoint_epoch_N`` (epoch N cut short: re-run N) saves,
    the one whose resume point is latest; a tie prefers the complete save."""
    d = Path(directory).absolute()
    if not d.exists():
        return None
    best, best_resume, best_complete = None, -1, False
    for entry in d.iterdir():
        if not entry.is_dir():
            continue
        complete = entry.name.startswith("checkpoint_epoch_")
        interrupted = entry.name.startswith("interrupted_checkpoint_epoch_")
        if not (complete or interrupted):
            continue
        try:
            e = int(entry.name.rsplit("_", 1)[1])
        except ValueError:
            continue
        resume_at = e + 1 if complete else e
        if resume_at > best_resume or (resume_at == best_resume and complete and not best_complete):
            best, best_resume, best_complete = entry.name, resume_at, complete
    return best


def resolve_resume(cfg, state, logger):
    """(state, start_epoch, best): ``cor_tpu``'s resume rules.

    - An explicit ``cfg.load_checkpoint_path`` that is missing or cannot be
      restored is an error, never a fresh start.
    - Otherwise the newest ``[interrupted_]checkpoint_epoch_N`` under
      ``train_model_save_path`` is restored; one that cannot be restored
      gives a fresh start with a warning.
    - An ``interrupted_`` save re-runs its epoch, a periodic save resumes at
      the next one.
    ``best`` is {"best_score", "best_epoch"} where the checkpoint holds them,
    so that a resumed run cannot overwrite ``best_model`` with a worse epoch;
    else None. ``state``'s model and optimizer are loaded in place."""
    explicit = bool(cfg.load_checkpoint_path)
    resume = cfg.load_checkpoint_path or latest_epoch_checkpoint(cfg.train_model_save_path)
    root = Path(str(cfg.train_model_save_path))
    if explicit and not (root / str(resume)).exists():
        raise FileNotFoundError(
            f"load_checkpoint_path={resume!r} not found under {cfg.train_model_save_path!r}")
    if not resume or not (root / str(resume)).exists():
        return state, 1, None
    try:
        restored = restore_checkpoint(root, str(resume))
        state.model.load_state_dict(restored["params"])
        state.optimizer.load_state_dict(restored["opt_state"])
        state.step = int(restored["step"])
    except (OSError, RuntimeError, KeyError, ValueError) as e:
        if explicit:
            raise RuntimeError(f"load_checkpoint_path={resume!r} could not be restored: {e}") from e
        logger.warning(
            f"AUTO-RESUME FAILED: found {resume!r} under {cfg.train_model_save_path!r} but it "
            f"could not be restored ({e}). Training RESTARTS FROM SCRATCH at epoch 1; point "
            "load_checkpoint_path at a good checkpoint to continue instead (explicit paths "
            "fail instead of restarting).")
        return state, 1, None
    interrupted = str(resume).startswith("interrupted_")
    start_epoch = max(int(restored["epoch"]) + (0 if interrupted else 1), 1)
    best = None
    if "best_score" in restored:
        best = {"best_score": float(restored["best_score"]),
                "best_epoch": int(restored["best_epoch"])}
    logger.info(f"Resumed from {resume} at epoch {start_epoch}")
    return state, start_epoch, best
