"""The port's training entry point, the counterpart of ``cor_tpu.cli.train``:

    python -m cor_tpu_torch.cli.train --config configs/train_config_m3.yaml --synthetic

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

Data comes from the synthetic dataset (``--synthetic``: 4 batches to train
on, 2 to validate on, as ``cor_tpu``'s). A manifest, configs that name a
checkpoint to load, and the keys of a device mesh are refused with the
ROADMAP item that ports them. Returns the ``Trainer``.
"""

from __future__ import annotations

import argparse
import logging
import random
import sys
from pathlib import Path

import numpy as np
import torch

MANIFEST_ITEM = ("ROADMAP Queue 1, item 10 (the manifest data pipeline: CORDataset, decode "
                 "and augment, PIL)")
CHECKPOINT_ITEM = "ROADMAP Queue 1, item 5 (checkpoint loaders)"


def main(argv=None):
    parser = argparse.ArgumentParser(description="cor_tpu_torch trainer")
    parser.add_argument("--config", required=True, help="experiment YAML")
    parser.add_argument("--synthetic", action="store_true",
                        help="train on synthetic data (the only data ported)")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="a torch.profiler trace of the first N train steps "
                             "(under {train_model_save_path}/profile)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model trains (default: the CUDA card)")
    args = parser.parse_args(argv)

    from cor_tpu_torch.config import load_train_config
    from cor_tpu_torch.data.pipeline import DataLoader
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.models.core_model import check_kernel_dtype, init_core_model
    from cor_tpu_torch.train.checkpoint import resolve_resume
    from cor_tpu_torch.train.optim import count_params, make_optimizer, trainable_mask
    from cor_tpu_torch.train.step import TrainState
    from cor_tpu_torch.train.trainer import Trainer, check_single_device
    from cor_tpu_torch.utils.meters import init_logger
    from cor_tpu_torch.utils.observability import SummaryWriter

    cfg = load_train_config(args.config)
    if cfg.checkpoint_keys():
        # never train from random weights while the config promises trained ones
        parser.error(f"config sets {cfg.checkpoint_keys()}: cor_tpu_torch loads no checkpoints "
                     f"yet ({CHECKPOINT_ITEM})")
    if not args.synthetic:
        parser.error(f"only --synthetic is ported: a manifest needs {MANIFEST_ITEM}")
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

    model = init_core_model(core_cfg, cfg.seed).to(args.device)  # fp32 masters
    optimizer, schedule = make_optimizer(
        model, cfg.optimizer, cfg.lr, cfg.lr_scheduler, cfg.epoch, cfg.gradient_clip,
        freeze_towers=cfg.freeze_towers, lr_decay_rate=cfg.lr_decay_rate,
        lr_decay_epoch=cfg.lr_decay_epoch)
    mask = trainable_mask(model, cfg.freeze_towers)
    logger.info(f"params: {count_params(model):,} total, {count_params(model, mask):,} trainable")
    state, start_epoch, best_resume = resolve_resume(cfg, TrainState(model, optimizer), logger)

    sig = core_cfg.support.siglip
    sizes = dict(query_img_size=core_cfg.encoder.img_size, support_img_size=sig.vision.image_size,
                 context_length=sig.text.context_length, vocab_size=sig.text.vocab_size)
    train_loader = DataLoader(
        SyntheticDataset(length=4 * cfg.batch_size, seed=cfg.seed, train=True, **sizes),
        cfg.batch_size, num_workers=cfg.num_workers, shuffle=True, drop_last=True)
    val_loader = DataLoader(SyntheticDataset(length=2 * cfg.batch_size, seed=cfg.seed + 1, **sizes),
                            cfg.batch_size, num_workers=cfg.num_workers)

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
