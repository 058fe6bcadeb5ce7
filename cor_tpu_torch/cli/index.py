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

Candidates come from the synthetic dataset (``--synthetic N``, the bits of
``cor_tpu``'s). A manifest (``CORDataset``), and configs that name a
checkpoint, are refused with the ROADMAP item that ports them. The last line
printed is ``cor_tpu``'s JSON: rows, dim, with_store, out.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import torch

MANIFEST_ITEM = ("ROADMAP Queue 1, item 10 (the manifest data pipeline: CORDataset, decode "
                 "and augment, PIL)")
CHECKPOINT_ITEM = "ROADMAP Queue 1, item 5 (checkpoint loaders)"
log = logging.getLogger("cor_tpu_torch.index")


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
    parser.add_argument("--with-store", action="store_true",
                        help="also save the SAM image embeddings for image-free mask decode")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the CUDA card)")
    args = parser.parse_args(argv)

    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.data.pipeline import DataLoader
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.models.core_model import (
        _cast,
        check_kernel_dtype,
        describe,
        init_image_encoder,
    )
    from cor_tpu_torch.retrieval.index import build_gallery, save_gallery_index

    cfg = load_eval_config(args.config) if args.config else EvalConfig()
    if cfg.checkpoint_keys():
        # never index with random weights while the config promises trained ones
        parser.error(
            f"config sets {cfg.checkpoint_keys()}: cor_tpu_torch loads no checkpoints "
            f"yet ({CHECKPOINT_ITEM})"
        )
    if not args.synthetic:
        parser.error(f"only --synthetic N is ported: a manifest needs {MANIFEST_ITEM}")
    try:
        check_kernel_dtype(cfg.core_config(), args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to build on the CPU")
    core_cfg = cfg.core_config()
    sig = core_cfg.support.siglip
    ds = SyntheticDataset(
        length=args.synthetic,
        query_img_size=core_cfg.encoder.img_size,
        support_img_size=sig.vision.image_size,
        context_length=sig.text.context_length,
        vocab_size=sig.text.vocab_size,
        seed=cfg.seed,
    )
    loader = DataLoader(ds, args.batch_size or cfg.batch_size, num_workers=cfg.num_workers)
    t0 = time.perf_counter()
    model = init_image_encoder(core_cfg, cfg.seed + 2).to(args.device)
    model = _cast(model, core_cfg.dtype).eval()
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
