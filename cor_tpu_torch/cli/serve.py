"""Retrieval serving entry point of the port: JSON lines on stdin/stdout.

    python -m cor_tpu_torch.cli.serve --gallery-index /data/idx --k 10 \\
        --max-batch 4 <<'EOF'
    {"id": 1, "support_img": "s.jpg", "support_mask": "m.png", "text": "..."}
    EOF

One request per input line, one JSON response per output line (logs go to
stderr). ``{"synthetic": <seed>}`` requests make a deterministic random query;
``--self-test N`` serves N of them and exits. The model runs on the GPU when
there is one, else on the CPU, with the port's own seeded weights
(``seed`` of the config). Without ``--config`` the model keys of
``configs/vaild_config.yaml`` apply.

This slice serves retrieval only. The flags of later slices, and configs
that name a checkpoint, are refused with the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import sys
import threading

import torch

from cor_tpu.cli.serve import power_of_two_buckets, process_lines  # stdlib only

# flags of later slices -> the ROADMAP item that ports them
LATER_FLAGS = {
    "decode_masks": ("--decode-masks", "ROADMAP Queue 1, item 2 (slice 2: mask decode)"),
    "store_hbm": ("--store-hbm", "ROADMAP Queue 1, item 2 (slice 2: int8 HBM store)"),
    "rescore": ("--rescore", "ROADMAP Queue 1, item 3 (serving: --approx, --rescore, --tcp)"),
    "approx": ("--approx", "ROADMAP Queue 1, item 3 (serving: --approx, --rescore, --tcp)"),
    "tcp": ("--tcp", "ROADMAP Queue 1, item 3 (serving: --approx, --rescore, --tcp)"),
}
CHECKPOINT_ITEM = "ROADMAP Queue 1, item 5 (checkpoint loaders)"


def main(argv=None):
    """Serve; returns the ``RetrievalServer`` after ``--self-test`` or EOF."""
    parser = argparse.ArgumentParser(description="cor_tpu_torch retrieval server")
    parser.add_argument("--config", default=None,
                        help="eval YAML (needs PyYAML); default: configs/vaild_config.yaml's model keys")
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
    # later slices: parsed so that they fail with a clear message
    parser.add_argument("--decode-masks", default=None, metavar="DIR", help=argparse.SUPPRESS)
    parser.add_argument("--store-hbm", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rescore", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--approx", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--tcp", type=int, default=0, metavar="PORT", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    for dest, (flag, item) in LATER_FLAGS.items():
        if getattr(args, dest):
            parser.error(f"{flag} is not ported to cor_tpu_torch yet: {item}")

    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.models.core_model import init_support_branch
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
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    model = init_support_branch(core_cfg, cfg.seed)
    index = load_gallery_index(args.gallery_index)
    server = RetrievalServer(
        core_cfg, model, index, k=args.k, quantize=args.int8,
        tokenizer_path=cfg.tokenizer_path, device=device,
    )
    max_batch = max(1, args.max_batch)
    server.warmup(batch_buckets=power_of_two_buckets(max_batch))

    if args.self_test:
        for start in range(0, args.self_test, max_batch):
            reqs = [{"id": i, "synthetic": i}
                    for i in range(start, min(start + max_batch, args.self_test))]
            for resp in server.handle_batch(reqs):
                print(json.dumps(resp), flush=True)
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
