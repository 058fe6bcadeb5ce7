"""The port's training entry point, the counterpart of ``cor_tpu.cli.train``:

    python -m cor_tpu_torch.cli.train --config configs/train_config_m3.yaml [--synthetic]

trains the CORE model (the SAM image encoder, the SigLIP towers,
MaskAdapterPooling, CirFuse, the SAM prompt encoder and mask decoder) in the
config's compute dtype with fp32 master weights, the port's seeded random
weights from the config's ``seed``. ``freeze_towers: false`` fine-tunes the
towers too. Each epoch trains, validates (the five soft metrics), keeps the
best model on Dice + IoU (``best_model``, ``best_model_full``) and saves
``checkpoint_epoch_N`` every ``train_model_save_epoch`` epochs under
``train_model_save_path``; a rerun resumes from the newest one. The model
runs on the CUDA card (``--device cpu`` asks for the CPU); ``--profile N``
writes a ``torch.profiler`` trace of the first N steps under
``{train_model_save_path}/profile``.

The config's ``load_sam_pretrained_checkpoint`` (a SAM ``.pth``: the image
encoder and the mask decoder) and ``load_siglip_pretrained_checkpoint`` (an
open_clip ``.bin``) load over the seeded weights, in ``cor_tpu``'s order; a
named file that does not exist is refused. ``load_checkpoint_path`` resumes
from a checkpoint directory of the port under ``train_model_save_path``
(``train/checkpoint.resolve_resume``). ``async_checkpoint: true`` writes
checkpoints in a background thread. Data comes from the config's COR127K
manifests, ``train_csv`` (augmented, shuffled: ``data/pipeline.
get_train_loader``) and ``val_csv`` under ``dataset_path``, sized for the
model; the paths are checked before anything is built, as ``cor_tpu``'s are.
``--synthetic`` takes the synthetic dataset instead (4 batches to train on,
2 to validate on, as ``cor_tpu``'s). The keys of a device mesh are refused
with the ROADMAP item that ports them. Returns the ``Trainer``.
"""

from __future__ import annotations

import argparse
import logging
import random
import sys
from pathlib import Path

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser(description="cor_tpu_torch trainer")
    parser.add_argument("--config", required=True, help="experiment YAML")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data instead of the config's manifests")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="a torch.profiler trace of the first N train steps "
                             "(under {train_model_save_path}/profile)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model trains (default: the CUDA card)")
    args = parser.parse_args(argv)

    from cor_tpu_torch.config import load_train_config
    from cor_tpu_torch.data.pipeline import (
        DataLoader,
        get_train_loader,
        get_valid_loader,
        model_sizes,
    )
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.models.core_model import check_kernel_dtype, init_core_model
    from cor_tpu_torch.train.checkpoint import resolve_resume
    from cor_tpu_torch.train.optim import count_params, make_optimizer, trainable_mask
    from cor_tpu_torch.train.step import TrainState
    from cor_tpu_torch.train.trainer import Trainer, check_single_device
    from cor_tpu_torch.utils.meters import init_logger
    from cor_tpu_torch.utils.convert import load_configured_weights
    from cor_tpu_torch.utils.observability import SummaryWriter

    cfg = load_train_config(args.config)
    if cfg.missing_checkpoints():
        parser.error(f"config names checkpoints that do not exist: {cfg.missing_checkpoints()}")
    if not args.synthetic:
        # fail fast, before the model is built
        for key in ("dataset_path", "train_csv", "val_csv"):
            path = getattr(cfg, key)
            if not path or not Path(path).exists():
                parser.error(f"Required data path missing: {key}={path!r}")
    try:
        check_kernel_dtype(cfg.core_config(), args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to train on the CPU")
    try:
        check_single_device(cfg)
    except ValueError as e:
        parser.error(str(e))
    random.seed(cfg.seed)
    np.random.seed(cfg.seed)
    torch.manual_seed(cfg.seed)
    core_cfg = cfg.core_config()
    save = Path(cfg.train_model_save_path)
    logger = init_logger(save / "logs", "train")
    where = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    logger.info(f"device: {where}; torch {torch.__version__}")
    if not args.synthetic and not cfg.tokenizer_path and (
            cfg.load_siglip_pretrained_checkpoint or cfg.load_checkpoint_path):
        logger.warning(
            "tokenizer_path is unset while pretrained SigLIP/CORE weights are configured: "
            "texts will be HASH-tokenized with ids unrelated to the trained vocab, so the "
            "change-text conditioning is lost. Set tokenizer_path to the SigLIP "
            "sentencepiece artifact.")

    model = init_core_model(core_cfg, cfg.seed)
    # pretrained towers over the seeded init; load_checkpoint_path resumes below
    load_configured_weights(cfg, core_cfg, model, logger, trained=False)
    model = model.to(args.device)  # fp32 masters
    optimizer, schedule = make_optimizer(
        model, cfg.optimizer, cfg.lr, cfg.lr_scheduler, cfg.epoch, cfg.gradient_clip,
        freeze_towers=cfg.freeze_towers, lr_decay_rate=cfg.lr_decay_rate,
        lr_decay_epoch=cfg.lr_decay_epoch)
    mask = trainable_mask(model, cfg.freeze_towers)
    logger.info(f"params: {count_params(model):,} total, {count_params(model, mask):,} trainable")
    state, start_epoch, best_resume = resolve_resume(cfg, TrainState(model, optimizer), logger)

    if args.synthetic:
        sizes = model_sizes(core_cfg)
        train_loader = DataLoader(
            SyntheticDataset(length=4 * cfg.batch_size, seed=cfg.seed, train=True, **sizes),
            cfg.batch_size, num_workers=cfg.num_workers, shuffle=True, drop_last=True)
        val_loader = DataLoader(
            SyntheticDataset(length=2 * cfg.batch_size, seed=cfg.seed + 1, **sizes),
            cfg.batch_size, num_workers=cfg.num_workers)
    else:
        train_loader = get_train_loader(cfg, core_cfg=core_cfg)
        val_loader = get_valid_loader(cfg, core_cfg=core_cfg)
        logger.info(f"train: {len(train_loader.dataset)} triplets ({len(train_loader)} batches) "
                    f"from {cfg.train_csv}; val: {len(val_loader.dataset)} from {cfg.val_csv}")

    writer = SummaryWriter(save / "tb")
    trainer = Trainer(cfg, core_cfg, state, schedule, logger, args.device, writer=writer,
                      profile_steps=args.profile, profile_dir=save / "profile")
    if best_resume is not None:
        # a resumed run must not overwrite best_model with a worse epoch
        trainer.best.best_score = best_resume["best_score"]
        trainer.best.best_epoch = best_resume["best_epoch"]
    try:
        best = trainer.fit(train_loader, val_loader, start_epoch=start_epoch)
    finally:
        writer.close()
    logger.info(f"Best epoch {best.best_epoch}: "
                + ", ".join(f"{k}={v:.4f}" for k, v in best.best_metrics.items()))
    return trainer


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
