"""Retrieval serving entry point of the port: JSON lines on stdin/stdout.

    python -m cor_tpu_torch.cli.serve --gallery-index /data/idx --k 10 \\
        --max-batch 4 [--decode-masks OUT [--store-hbm]] [--int8] <<'EOF'
    {"id": 1, "support_img": "s.jpg", "support_mask": "m.png", "text": "..."}
    EOF

One request per input line, one JSON response per output line (logs go to
stderr). ``{"synthetic": <seed>}`` requests make a deterministic random query;
``--self-test N`` serves N of them and exits. With ``--decode-masks OUT``
every retrieved candidate is segmented from the index's store and written as
``OUT/{id}_{pair_id}.png``; ``--store-hbm`` keeps the store int8 on the
device. The model runs on the CUDA card (``--device cpu`` asks for the CPU)
with the port's own seeded weights: the support branch from the config's
``seed``, the prompt encoder from the same seed and the mask decoder from
``seed + 1``. Without ``--config`` the model keys of
``configs/vaild_config.yaml`` apply.

``--approx``, ``--rescore`` and ``--tcp``, and configs that name a
checkpoint, are refused with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import sys
import threading

import torch

# flags of later slices -> the ROADMAP item that ports them
LATER_FLAGS = {
    "rescore": ("--rescore", "ROADMAP Queue 1, item 3 (serving: --approx, --rescore, --tcp)"),
    "approx": ("--approx", "ROADMAP Queue 1, item 3 (serving: --approx, --rescore, --tcp)"),
    "tcp": ("--tcp", "ROADMAP Queue 1, item 3 (serving: --approx, --rescore, --tcp)"),
}
CHECKPOINT_ITEM = "ROADMAP Queue 1, item 5 (checkpoint loaders)"
log = logging.getLogger("cor_tpu_torch.serve")


def process_lines(server, raw_lines):
    """One serving tick: parse a drained batch of JSON lines, answer the
    well-formed requests with one ``handle_batch`` call, and return responses
    in input order (parse failures become error responses in their own slot;
    a whole-batch failure falls back to per-request handling so one poisoned
    request cannot take down its batchmates). cor_tpu.cli.serve's loop."""

    def _error_resp(line, e):
        resp = {"id": None, "error": f"{type(e).__name__}: {e}"}
        try:
            parsed = json.loads(line)
            if isinstance(parsed, dict):
                resp["id"] = parsed.get("id")
        except Exception:
            pass
        return resp

    entries = []  # (kind, payload) per non-empty line, order preserved
    for raw in raw_lines:
        raw = raw.strip()
        if not raw:
            continue
        try:
            req = json.loads(raw)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
            entries.append(("req", req))
        except Exception as e:
            entries.append(("err", _error_resp(raw, e)))
    reqs = [payload for kind, payload in entries if kind == "req"]
    try:
        batch_resps = iter(server.handle_batch(reqs))
    except Exception as e:  # whole-batch failure: retry one by one
        log.warning(
            "batch dispatch failed (%s: %s); retrying requests singly", type(e).__name__, e,
        )

        def _single(r):
            try:
                return server.handle(r)
            except Exception as ee:
                return {"id": r.get("id"), "error": f"{type(ee).__name__}: {ee}"}

        batch_resps = iter([_single(r) for r in reqs])
    # a handle_batch that returned too few responses degrades to error
    # responses instead of raising StopIteration out of the serving loop
    return [payload if kind == "err"
            else next(batch_resps, {"id": None, "error": "missing response"})
            for kind, payload in entries]


def power_of_two_buckets(max_batch: int) -> list:
    """[1, 2, 4, ..., >= max_batch]: the batch buckets warmed up at start."""
    buckets = [1]
    while buckets[-1] < max_batch:
        buckets.append(buckets[-1] * 2)
    return buckets


def main(argv=None):
    """Serve; returns the ``RetrievalServer`` after ``--self-test`` or EOF."""
    parser = argparse.ArgumentParser(description="cor_tpu_torch retrieval server")
    parser.add_argument("--config", default=None,
                        help="eval YAML; default: configs/vaild_config.yaml's model keys")
    parser.add_argument("--gallery-index", required=True, metavar="DIR",
                        help="artifact written by save_gallery_index (either package)")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--int8", action="store_true",
                        help="int8 per-row-quantized gallery scan")
    parser.add_argument("--max-batch", type=int, default=1, metavar="B",
                        help="micro-batch up to B queued requests into one encode+scan "
                             "(power-of-two buckets)")
    parser.add_argument("--self-test", type=int, default=0, metavar="N",
                        help="serve N synthetic requests and exit")
    parser.add_argument("--decode-masks", default=None, metavar="DIR",
                        help="segment every retrieved candidate from the index's store and "
                             "write DIR/{id}_{pair_id}.png")
    parser.add_argument("--store-hbm", action="store_true",
                        help="with --decode-masks: keep the store int8 on the device and decode "
                             "straight from the scan's indices")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the CUDA card)")
    # later slices: parsed so that they fail with a clear message
    parser.add_argument("--rescore", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--approx", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tcp", type=int, default=0, metavar="PORT", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for dest, (flag, item) in LATER_FLAGS.items():
        if getattr(args, dest):
            parser.error(f"{flag} is not ported to cor_tpu_torch yet: {item}")

    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.models.core_model import (
        check_kernel_dtype,
        describe,
        init_decode_model,
        init_support_branch,
    )
    from cor_tpu_torch.retrieval.index import load_gallery_index
    from cor_tpu_torch.retrieval.serve import RetrievalServer

    cfg = load_eval_config(args.config) if args.config else EvalConfig()
    if cfg.checkpoint_keys():
        # never serve random weights while the config promises trained ones
        parser.error(
            f"config sets {cfg.checkpoint_keys()}: cor_tpu_torch loads no checkpoints "
            f"yet ({CHECKPOINT_ITEM})"
        )
    core_cfg = cfg.core_config()
    try:
        check_kernel_dtype(cfg.core_config(), args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to serve on the CPU")
    model = init_support_branch(core_cfg, cfg.seed)
    index = load_gallery_index(args.gallery_index)
    try:
        server = RetrievalServer(
            core_cfg, model, index, k=args.k, quantize=args.int8,
            tokenizer_path=cfg.tokenizer_path, device=args.device,
            decode_model=init_decode_model(core_cfg, cfg.seed) if args.decode_masks else None,
            decode_dir=args.decode_masks, store_hbm=args.store_hbm,
        )
    except ValueError as e:  # flags the index cannot serve (no store, --store-hbm alone)
        parser.error(str(e))
    max_batch = max(1, args.max_batch)
    server.warmup(batch_buckets=power_of_two_buckets(max_batch))
    log.info("serving %s on %s: gallery %d rows, k %d, %s scan, masks %s", describe(core_cfg),
             args.device, len(index["pair_ids"]), args.k, "int8" if args.int8 else "fp32",
             ("int8 store on the device" if args.store_hbm else "host-streamed store")
             if args.decode_masks else "off")

    if args.self_test:
        for start in range(0, args.self_test, max_batch):
            reqs = [{"id": i, "synthetic": i}
                    for i in range(start, min(start + max_batch, args.self_test))]
            for resp in server.handle_batch(reqs):
                print(json.dumps(resp), flush=True)
        log.info("self-test: answered %d requests; %d encoded batches, warmup included",
                 args.self_test, server.batches_encoded)
        return server

    # a reader thread drains stdin into a bounded queue, so the loop can
    # micro-batch every request that queued while the last batch ran
    lines: "queue.Queue" = queue.Queue(maxsize=max(8, 4 * max_batch))

    def _reader():
        for raw in sys.stdin:
            lines.put(raw)
        lines.put(None)  # EOF

    threading.Thread(target=_reader, daemon=True).start()
    eof = False
    while not eof:
        batch_raw = [lines.get()]
        if batch_raw[0] is None:
            break
        while len(batch_raw) < max_batch:
            try:
                nxt = lines.get_nowait()
            except queue.Empty:
                break
            if nxt is None:
                eof = True
                break
            batch_raw.append(nxt)
        for resp in process_lines(server, batch_raw):
            print(json.dumps(resp), flush=True)
    return server


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    main()
