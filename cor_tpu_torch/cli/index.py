"""The port's gallery-index build: encode the candidates once, serve them
with ``cor_tpu_torch.cli.serve``.

    python -m cor_tpu_torch.cli.index --out /data/idx --synthetic 1024 --with-store

One pass of the SAM image encoder and the masked pooling over every
(query image, query mask) candidate, written as the gallery-index artifact
of ``cor_tpu`` (either package's server loads it). ``--with-store`` also
keeps the [G, 64, 64, 256] image embeddings (fp16, 2 MiB per candidate) for
``cli.serve --decode-masks``. The model runs on the CUDA card
(``--device cpu`` asks for the CPU) with the port's seeded weights: the
image encoder from the config's ``seed + 2`` (``core_model.init_core_model``).
Without ``--config`` the model keys of ``configs/vaild_config.yaml`` apply.

The checkpoint keys load over the seeded weights as ``cor_tpu``'s builder
loads them: the image encoder of a SAM ``.pth``
(``load_sam_pretrained_checkpoint``), then that of ``load_checkpoint_path``
(a trained CORE ``.pth`` or a checkpoint directory of the port's trainer);
a named checkpoint that does not exist is refused. Candidates come from the
synthetic dataset (``--synthetic N``, the bits of ``cor_tpu``'s) or from the
config's manifest (``val_csv_A``, else ``val_csv_B``: ``CORDataset``, the
first ``--limit`` rows). The last line printed is ``cor_tpu``'s JSON: rows,
dim, with_store, out.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path

import torch

log = logging.getLogger("cor_tpu_torch.index")


def check_checkpoints_and_manifest(parser, cfg, synthetic: bool) -> Path:
    """Refuse (``parser.error``) a config whose checkpoint keys name files
    that do not exist, and, without ``synthetic``, one whose manifest
    (``val_csv_A``, else ``val_csv_B``) does not exist; the manifest's path."""
    if cfg.missing_checkpoints():
        parser.error(f"config names checkpoints that do not exist: {cfg.missing_checkpoints()}")
    csv_path = cfg.val_csv_A or cfg.val_csv_B
    if not synthetic and (not csv_path or not Path(csv_path).is_file()):
        parser.error(f"Manifest {csv_path!r} not found; pass --synthetic N to run on "
                     "synthetic triplets")
    return Path(csv_path) if csv_path else None


def main(argv=None):
    """Build and save the index; returns the JSON line's dict."""
    parser = argparse.ArgumentParser(description="cor_tpu_torch gallery-index build")
    parser.add_argument("--config", default=None,
                        help="eval YAML; default: configs/vaild_config.yaml's "
                             "model keys")
    parser.add_argument("--out", required=True, help="output artifact directory")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="index N synthetic candidates")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="candidates per encoder batch (default: the config's batch_size)")
    parser.add_argument("--limit", type=int, default=0, metavar="N",
                        help="only the first N manifest rows (ignored with --synthetic)")
    parser.add_argument("--with-store", action="store_true",
                        help="also save the SAM image embeddings for image-free mask decode")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the CUDA card)")
    args = parser.parse_args(argv)

    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.data.pipeline import DataLoader, valid_dataset
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.models.core_model import (
        _cast,
        check_kernel_dtype,
        describe,
        init_image_encoder,
    )
    from cor_tpu_torch.retrieval.index import build_gallery, save_gallery_index
    from cor_tpu_torch.utils.convert import load_configured_weights

    cfg = load_eval_config(args.config) if args.config else EvalConfig()
    csv_path = check_checkpoints_and_manifest(parser, cfg, bool(args.synthetic))
    try:
        check_kernel_dtype(cfg.core_config(), args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to build on the CPU")
    core_cfg = cfg.core_config()
    sig = core_cfg.support.siglip
    if args.synthetic:
        ds = SyntheticDataset(
            length=args.synthetic,
            query_img_size=core_cfg.encoder.img_size,
            support_img_size=sig.vision.image_size,
            context_length=sig.text.context_length,
            vocab_size=sig.text.vocab_size,
            seed=cfg.seed,
        )
    else:
        ds = valid_dataset(cfg, csv_path, limit=args.limit or None, core_cfg=core_cfg)
    loader = DataLoader(ds, args.batch_size or cfg.batch_size, num_workers=cfg.num_workers)
    t0 = time.perf_counter()
    model = init_image_encoder(core_cfg, cfg.seed + 2)
    load_configured_weights(cfg, core_cfg, {"image_encoder": model}, log)
    model = _cast(model.to(args.device), core_cfg.dtype).eval()
    t1 = time.perf_counter()
    emb, ids, store = build_gallery(core_cfg, model, loader, with_store=args.with_store)
    save_gallery_index(args.out, emb, ids, image_embeddings=store)
    log.info("indexed %d candidates with %s on %s: model init %.1f s, build and save %.1f s",
             emb.shape[0], describe(core_cfg), args.device, t1 - t0, time.perf_counter() - t1)
    out = {"rows": int(emb.shape[0]), "dim": int(emb.shape[1]),
           "with_store": bool(args.with_store), "out": str(args.out)}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
