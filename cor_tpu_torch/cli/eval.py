"""The port's evaluation entry point, the counterpart of ``cor_tpu.cli.eval``:

    python -m cor_tpu_torch.cli.eval --config configs/vaild_config.yaml [--soft] [--limit N] \\
        [--visualize N]

Scores the CORE model on the config's manifest splits: ``val_csv_A`` as
``Test_1`` and ``val_csv_B`` as ``Test_2`` (an empty key skips its split).
For each split, one forward per batch (``train/step.make_predict_step``)
feeds the hard masks (``{vaild_model_save_path}/{split}/pred_masks/
{pair_id}_{Query_mask}``, 0/255 PNGs at the GT's native size), with
``--soft`` the soft ones (``soft_pred_masks/``), the per-sample metric CSV
(``val_metric.csv``), and with ``--visualize N`` the comparison panels of
the first N triplets (``visualizations/{pair_id}.png``,
``eval/visualize.py``); the log gives the metrics' means, the skipped
samples and the sweep's images/s split into the loader's host seconds and
the forward's device seconds.

Weights: the port's seeded init from the config's ``seed``
(``core_model.init_core_model``), then what the checkpoint keys name, in
``cor_tpu``'s order (``utils/convert.load_configured_weights``): a SAM
``.pth``, a SigLIP ``.bin``, and ``load_checkpoint_path``, a trained CORE
``.pth`` or a checkpoint directory of the port's trainer. The model runs in
the config's compute dtype on the CUDA card (``--device cpu`` asks for the
CPU; there is no fallback). The manifests' images are PNGs read by the
port's reader, or JPEGs where Pillow is installed. Returns {split: ``run_eval_split``'s result}.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from pathlib import Path

import torch


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="cor_tpu_torch evaluator")
    parser.add_argument("--config", required=True, help="eval YAML")
    parser.add_argument("--soft", action="store_true", help="also dump soft (grayscale) masks")
    parser.add_argument("--limit", type=int, default=0, metavar="N",
                        help="evaluate only the first N manifest rows per split")
    parser.add_argument("--visualize", type=int, default=0, metavar="N",
                        help="write the comparison panels of the first N triplets per split")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the CUDA card)")
    args = parser.parse_args(argv)

    from cor_tpu_torch.config import load_eval_config
    from cor_tpu_torch.data.pipeline import get_valid_loader
    from cor_tpu_torch.eval.validator import run_eval_split
    from cor_tpu_torch.models.core_model import (
        _cast,
        check_kernel_dtype,
        describe,
        init_core_model,
    )
    from cor_tpu_torch.train.step import make_predict_step
    from cor_tpu_torch.utils.convert import load_configured_weights
    from cor_tpu_torch.utils.meters import init_logger

    cfg = load_eval_config(args.config)
    core_cfg = cfg.core_config()
    if cfg.missing_checkpoints():
        parser.error(f"config names checkpoints that do not exist: {cfg.missing_checkpoints()}")
    splits = [(name, path) for name, path in (("Test_1", cfg.val_csv_A),
                                              ("Test_2", cfg.val_csv_B)) if path]
    absent = [str(p) for _, p in splits if not Path(p).is_file()]
    if absent:
        parser.error(f"manifest not found: {absent}")
    try:
        check_kernel_dtype(core_cfg, args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to evaluate on the CPU")
    logger = init_logger(Path(cfg.vaild_model_save_path) / "logs", "eval")
    if not cfg.tokenizer_path and cfg.load_checkpoint_path:
        logger.warning("tokenizer_path is unset while evaluating a trained checkpoint: texts "
                       "will be HASH-tokenized with ids unrelated to the trained vocab; set "
                       "tokenizer_path to the SigLIP sentencepiece artifact.")

    t0 = time.perf_counter()
    model = init_core_model(core_cfg, cfg.seed)
    load_configured_weights(cfg, core_cfg, model, logger)
    model = _cast(model.to(args.device), core_cfg.dtype).eval()
    predict = make_predict_step(core_cfg)
    logger.info(f"evaluating {describe(core_cfg)} on {args.device}: model ready in "
                f"{time.perf_counter() - t0:.1f} s")

    results = {}
    for split_name, csv_path in splits:
        loader = get_valid_loader(cfg, csv_path=csv_path, limit=args.limit or None,
                                  core_cfg=core_cfg)
        out_dir = Path(cfg.vaild_model_save_path) / split_name
        # dump names are {pair_id}_{Query_mask}, the reference's; the loader is
        # unshuffled and keeps the last batch, so sample order is manifest order
        mask_names = [str(v) for v in loader.dataset.df.column("Query_mask")]
        result = run_eval_split(predict, model, loader, out_dir, manifest=loader.dataset.df,
                                mask_names=mask_names, soft=args.soft,
                                visualize_n=args.visualize)
        timing = result["timing"]
        wall = timing["wall_s"]
        logger.info(f"[{split_name}] wrote {len(result['hard'])} hard masks to {out_dir}"
                    + (f", {len(result['soft'])} soft masks" if args.soft else "")
                    + (f", {len(result['panels'])} panels" if args.visualize else "")
                    + f"; skipped samples: {result['skipped']}")
        logger.info(f"[{split_name}] "
                    + ", ".join(f"{k}={v:.4f}" for k, v in result["summary"].items()))
        logger.info(f"[{split_name}] {timing['samples']} images in {wall:.2f} s "
                    f"({timing['samples'] / max(wall, 1e-9):.2f} images/s): loader wait "
                    f"{timing['load_s']:.2f} s, forward {sum(timing['forward_ms']) / 1e3:.2f} s "
                    f"({'device, CUDA events' if args.device == 'cuda' else 'wall'}) in "
                    f"{timing['batches']} batches, masks and metrics {timing['post_s']:.2f} s")
        results[split_name] = result
    return results


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
