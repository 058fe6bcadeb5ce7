"""The Recall@K protocol of the port: every triplet's (query image, query
mask) is a gallery candidate, its (support image, support mask, change text)
a query, and query i's target is candidate i.

    python -m cor_tpu_torch.cli.retrieve --synthetic 128 --k 10 [--rerank]
    python -m cor_tpu_torch.cli.retrieve --synthetic 128 --gallery-index IDX

``--rerank`` mask-decodes every query's top k out of an int8 store of the
candidates' SAM image embeddings (K1 reads the store rows itself, then K2
and K3) and ranks them by predicted IoU; ``--gallery-index`` scores the
queries against an index built by ``cli.index`` (``--with-store`` for the
rerank) instead of encoding the candidates. ``--int8`` scans an int8
gallery, ``--rescore`` re-ranks a ``--rescore-width`` times wider pool by
exact fp32 cosines on the device, and ``--approx`` is ``cor_tpu``'s
approximate scan, which the port runs as the exact top k (``--recall-target``
is accepted and selects nothing). The last line printed is one JSON object:
recall@K for K in 1, 5, 10 below ``--k`` and ``--k`` itself, and
gallery_size.

The models run on the CUDA card (``--device cpu`` asks for the CPU) with the
port's seeded weights, as ``cli.index`` and ``cli.serve`` make them: the
image encoder from the config's ``seed + 2``, the support branch and the
prompt encoder from ``seed``, the mask decoder from ``seed + 1``; so an index
built by ``cli.index`` pairs the same weights. Without ``--config`` the model
keys of ``configs/vaild_config.yaml`` apply. Only ``--synthetic N`` triplets
are ported: a manifest, and configs that name a checkpoint, are refused with
the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time

import numpy as np
import torch

from cor_tpu_torch.cli.index import CHECKPOINT_ITEM, MANIFEST_ITEM

log = logging.getLogger("cor_tpu_torch.retrieve")


def main(argv=None):
    """Run the protocol and print its JSON line; returns the line's dict."""
    parser = argparse.ArgumentParser(description="cor_tpu_torch Recall@K protocol")
    parser.add_argument("--config", default=None,
                        help="eval YAML; default: configs/vaild_config.yaml's model keys")
    parser.add_argument("--k", type=int, default=10, help="max K for Recall@K")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="run the protocol on N synthetic triplets")
    parser.add_argument("--batch-size", type=int, default=0,
                        help="triplets per encoder batch (default: the config's batch_size)")
    parser.add_argument("--limit", type=int, default=0, metavar="N",
                        help="only the first N manifest rows (ignored with --synthetic)")
    parser.add_argument("--rerank", action="store_true",
                        help="mask-decode every query's top k from an int8 store of the "
                             "candidates' SAM embeddings and rank them by predicted IoU")
    parser.add_argument("--approx", action="store_true",
                        help="cor_tpu's approximate scan; the port runs the exact top k")
    parser.add_argument("--int8", action="store_true",
                        help="int8 per-row-quantized gallery scan")
    parser.add_argument("--rescore", action="store_true",
                        help="two-stage retrieval: a --rescore-width times wider pool re-ranked "
                             "by exact fp32 cosines on the device. Mutually exclusive with "
                             "--rerank, which ranks by decoded mask IoU instead")
    parser.add_argument("--rescore-width", type=int, default=4, metavar="W",
                        help="first-stage pool width multiplier for --rescore (pool = W*k)")
    parser.add_argument("--recall-target", type=float, default=None, metavar="R",
                        help="cor_tpu's recall target for --approx (default 0.99; 0.999 with "
                             "--rescore); kept for its defaults, selects nothing here")
    parser.add_argument("--gallery-index", default=None, metavar="DIR",
                        help="score against an index built by cli.index instead of encoding "
                             "the gallery (queries are still encoded)")
    parser.add_argument("--dump-top1", action="store_true",
                        help="also decode the first triplets' candidates and report the mask "
                             "shape")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the models run (default: the CUDA card)")
    args = parser.parse_args(argv)
    if args.rerank and args.rescore:
        # the rerank ranks by predicted mask IoU, so the exact-fp32 second
        # stage never runs: refuse rather than report rescore numbers that
        # are rerank-only
        parser.error(
            "--rerank and --rescore are mutually exclusive: rerank ranks by "
            "decoded mask IoU (the embedding-score rescore stage does not "
            "apply). Run them separately to compare protocols."
        )

    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.data.pipeline import DataLoader
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.models.core_model import (
        check_kernel_dtype,
        describe,
        init_decode_model,
        init_image_encoder,
        init_support_branch,
    )
    from cor_tpu_torch.retrieval.index import (
        load_gallery_index,
        make_candidate_encoder,
        make_candidate_mask_decoder,
    )
    from cor_tpu_torch.retrieval.protocol import (
        evaluate_retrieval,
        evaluate_retrieval_with_index,
        prepare_models,
    )

    cfg = load_eval_config(args.config) if args.config else EvalConfig()
    if cfg.checkpoint_keys():
        # never report recalls of random weights while the config promises trained ones
        parser.error(
            f"config sets {cfg.checkpoint_keys()}: cor_tpu_torch loads no checkpoints "
            f"yet ({CHECKPOINT_ITEM})"
        )
    if not args.synthetic:
        parser.error(f"only --synthetic N is ported: a manifest needs {MANIFEST_ITEM}")
    core_cfg = cfg.core_config()
    try:
        check_kernel_dtype(core_cfg, args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to run on the CPU")
    index = None
    if args.gallery_index:
        index = load_gallery_index(args.gallery_index)
        if args.rerank and index.get("store") is None:
            parser.error("--rerank needs the SAM image-embedding store in the gallery index — "
                         "rebuild it with `cor_tpu_torch.cli.index --with-store`")

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
    # an index carries its candidates: the image encoder runs only to encode them
    need_encoder = index is None or args.dump_top1
    models = prepare_models(
        core_cfg,
        init_image_encoder(core_cfg, cfg.seed + 2) if need_encoder else None,
        init_support_branch(core_cfg, cfg.seed),
        init_decode_model(core_cfg, cfg.seed) if args.rerank or args.dump_top1 else None,
        device=args.device,
    )
    t1 = time.perf_counter()

    # the user's --k is always reported, with the standard 1/5/10 below it
    ks = tuple(sorted({k for k in (1, 5, 10) if k < args.k} | {args.k}))
    kw = dict(ks=ks, rerank=args.rerank, approx=args.approx, quantize=args.int8,
              rescore=args.rescore, rescore_width=args.rescore_width,
              recall_target=args.recall_target)
    if index is not None:
        result = evaluate_retrieval_with_index(core_cfg, models, loader, index, **kw)
    else:
        result = evaluate_retrieval(core_cfg, models, loader, **kw)

    if args.dump_top1:
        head = [ds[i] for i in range(min(4, len(ds)))]
        batch = {k: np.stack([s[k] for s in head]) for k in ("query_img", "query_mask")}
        dev = models.device
        emb, img_emb = make_candidate_encoder(core_cfg)(
            models.image_encoder, *(torch.from_numpy(batch[k]).to(dev)
                                    for k in ("query_img", "query_mask")))
        masks = make_candidate_mask_decoder(core_cfg)(models.decode_model, img_emb, emb)
        result["top1_mask_shape"] = list(masks.shape)
    log.info("protocol with %s on %s: %d triplets, model init %.1f s, encode, scan%s %.1f s",
             describe(core_cfg), args.device, args.synthetic, t1 - t0,
             " and rerank" if args.rerank else "", time.perf_counter() - t1)
    out = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in result.items()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
