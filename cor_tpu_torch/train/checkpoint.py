"""Checkpoints, the PyTorch counterpart of ``cor_tpu.train.checkpoint``.

A checkpoint is a directory ``{train_model_save_path}/{name}`` holding one
``state.pt`` (``torch.save``): ``params`` (the model's fp32 state dict),
and, in a full save, ``opt_state``, ``step``, ``epoch``, ``best_score``,
``best_epoch`` and ``loss``, under ``cor_tpu``'s names
(``checkpoint_epoch_N``, ``interrupted_checkpoint_epoch_N``, ``best_model``,
``best_model_full``). A save writes a temporary directory and renames it into
place, so a cut-off save never leaves a half-written checkpoint under a
resumable name. The resume rules are ``cor_tpu``'s (``resolve_resume``).
Reading ``cor_tpu``'s Orbax checkpoints is not ported (the card's machine
has no orbax).
"""

from __future__ import annotations

import os
import shutil
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
