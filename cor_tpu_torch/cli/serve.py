"""Retrieval serving entry point of the port: JSON lines on stdin/stdout, or
a multi-client TCP line protocol.

    python -m cor_tpu_torch.cli.serve --gallery-index /data/idx --k 10 \\
        --max-batch 4 [--decode-masks OUT [--store-hbm]] [--int8] <<'EOF'
    {"id": 1, "support_img": "s.jpg", "support_mask": "m.png", "text": "..."}
    EOF
    python -m cor_tpu_torch.cli.serve --gallery-index /data/idx --tcp 7000

One request per input line, one JSON response per output line (logs go to
stderr). ``{"synthetic": <seed>}`` requests make a deterministic random query;
``--self-test N`` serves N of them and exits. With ``--decode-masks OUT``
every retrieved candidate is segmented from the index's store and written as
``OUT/{id}_{pair_id}.png``; ``--store-hbm`` keeps the store int8 on the
device. ``--tcp PORT`` serves every client that connects (``--tcp-host``,
loopback by default), batching requests across clients up to
``--max-batch``. ``--int8``, ``--approx`` (``cor_tpu``'s approximate scan,
run as the exact top k), ``--rescore`` (a ``--rescore-width`` times wider
pool re-ranked by exact fp32 cosines on the device) and ``--recall-target``
select the scan. The model runs on the CUDA card (``--device cpu`` asks for
the CPU) with the port's own seeded weights: the support branch from the
config's ``seed``, the prompt encoder from the same seed and the mask decoder
from ``seed + 1``. Without ``--config`` the model keys of
``configs/vaild_config.yaml`` apply. The checkpoint keys load over them in
``cor_tpu``'s order (``utils/convert.load_configured_weights``: a SAM
``.pth``'s mask decoder, a SigLIP ``.bin``, then a trained CORE ``.pth`` or a
checkpoint directory of the port's trainer); a named checkpoint that does
not exist is refused.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import socket
import sys
import threading

import torch

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


MAX_LINE_BYTES = 1 << 20  # TCP clients are untrusted: request lines are capped


def serve_tcp(server, host: str, port: int, max_batch: int, ready_event=None):
    """Multi-client TCP line protocol (cor_tpu ``serve_tcp``): one JSON
    request per line, one JSON response per line, per connection. A reader
    thread per client feeds one bounded inbox; one dispatcher thread drains
    up to ``max_batch`` queued requests, across clients, into each
    ``handle_batch``.

    Against untrusted or slow clients: request lines are capped at
    ``MAX_LINE_BYTES`` (the connection is dropped); responses go through a
    bounded outbox per connection drained by a writer thread, so a client
    that stops reading fills its own outbox and is dropped instead of
    blocking the dispatcher; the bounded inbox pushes back on readers.

    ``ready_event`` (a ``threading.Event``) is set once listening starts,
    with the bound (host, port) as its ``bound``. Serves until interrupted;
    returns the bound address."""
    inbox: "queue.Queue" = queue.Queue(maxsize=max(8, 4 * max_batch))
    CLOSE = object()

    class Client:
        def __init__(self, conn, addr):
            self.conn = conn
            self.addr = addr
            self.outbox: "queue.Queue" = queue.Queue(maxsize=max(16, 8 * max_batch))
            self.dead = False

        def send(self, resp: dict):
            """From the dispatcher, never blocking: a full outbox means the
            client stopped reading, so it is dropped."""
            if self.dead:
                return
            try:
                self.outbox.put_nowait(resp)
            except queue.Full:
                log.info("client %s not consuming responses; dropping", self.addr)
                self.kill()

        def kill(self):
            self.dead = True
            try:
                self.outbox.put_nowait(None)
            except queue.Full:
                pass  # the writer is behind: it meets the closed socket
            try:
                self.conn.close()
            except Exception:
                pass

        def finish(self):
            """Close after the writer has sent every answer already queued:
            a client that shut its write side (``cat reqs | nc -N``) still
            reads the responses to what it sent. The reader's CLOSE follows
            the client's requests in the inbox, and the dispatcher sends a
            batch's responses before it handles the batch's CLOSEs."""
            if self.dead:
                return
            try:
                self.outbox.put_nowait(None)
            except queue.Full:
                self.kill()

    def writer(client: Client):
        while True:
            resp = client.outbox.get()
            if resp is None or client.dead:
                if not client.dead:  # drained: close now
                    try:
                        client.conn.close()
                    except Exception:
                        pass
                return
            try:
                client.conn.sendall((json.dumps(resp) + "\n").encode())
            except Exception as e:
                log.info("client %s write failed: %s", client.addr, e)
                client.kill()
                return

    def reader(client: Client):
        buf = b""
        try:
            while True:
                chunk = client.conn.recv(65536)
                if not chunk:
                    break
                buf += chunk
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line = buf[:nl].decode("utf-8", errors="replace")
                    buf = buf[nl + 1:]
                    if line.strip():
                        inbox.put((client, line))
                if len(buf) > MAX_LINE_BYTES:
                    log.info("client %s exceeded the %d-byte line cap; dropping", client.addr,
                             MAX_LINE_BYTES)
                    break
        except Exception as e:
            if not client.dead:
                log.info("client %s reader ended: %s", client.addr, e)
        finally:
            inbox.put((client, CLOSE))

    def dispatcher():
        while True:
            batch = [inbox.get()]
            while len(batch) < max_batch:
                try:
                    batch.append(inbox.get_nowait())
                except queue.Empty:
                    break
            closes = [c for c, line in batch if line is CLOSE]
            batch = [(c, line) for c, line in batch if line is not CLOSE]
            if batch:
                try:
                    resps = process_lines(server, [line for _, line in batch])
                except Exception as e:
                    # process_lines isolates request and batch failures; what
                    # escapes is a server fault: answer with errors rather than
                    # end the dispatcher and hang every client
                    log.exception("dispatcher batch failed: %s", e)
                    resps = [{"id": None, "error": f"internal: {type(e).__name__}"}
                             for _ in batch]
                # process_lines answers every non-blank line in order, and
                # readers enqueue only non-blank lines: the slots align
                for (c, _), resp in zip(batch, resps):
                    c.send(resp)
            for c in closes:
                c.finish()

    threading.Thread(target=dispatcher, daemon=True).start()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(64)
    bound = srv.getsockname()
    log.info("serving TCP on %s:%d (max_batch=%d)", bound[0], bound[1], max_batch)
    if ready_event is not None:
        ready_event.bound = bound
        ready_event.set()
    try:
        while True:
            conn, addr = srv.accept()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            client = Client(conn, addr)
            threading.Thread(target=writer, args=(client,), daemon=True).start()
            threading.Thread(target=reader, args=(client,), daemon=True).start()
    except KeyboardInterrupt:
        log.info("TCP server interrupted; closing")
    finally:
        srv.close()
    return bound


def main(argv=None, ready_event=None):
    """Serve; returns the ``RetrievalServer`` after ``--self-test`` or EOF.
    With ``--tcp``, ``ready_event`` goes to ``serve_tcp``."""
    parser = argparse.ArgumentParser(description="cor_tpu_torch retrieval server")
    parser.add_argument("--config", default=None,
                        help="eval YAML; default: configs/vaild_config.yaml's model keys")
    parser.add_argument("--gallery-index", required=True, metavar="DIR",
                        help="artifact written by save_gallery_index (either package)")
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument("--int8", action="store_true",
                        help="int8 per-row-quantized gallery scan")
    parser.add_argument("--approx", action="store_true",
                        help="cor_tpu's approximate scan; the port runs the exact top k")
    parser.add_argument("--rescore", action="store_true",
                        help="two-stage scan: a widened pool re-ranked by exact fp32 cosines "
                             "on the device")
    parser.add_argument("--rescore-width", type=int, default=4, metavar="W",
                        help="first-stage pool width multiplier for --rescore (pool = W*k)")
    parser.add_argument("--recall-target", type=float, default=None, metavar="R",
                        help="cor_tpu's recall target for --approx (default 0.99; 0.999 with "
                             "--rescore); kept for its defaults, selects nothing here")
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
    parser.add_argument("--tcp", type=int, default=0, metavar="PORT",
                        help="serve a multi-client TCP line protocol on this port instead of "
                             "stdin/stdout (0 = stdio); requests batch across clients up to "
                             "--max-batch")
    parser.add_argument("--tcp-host", default="127.0.0.1", metavar="ADDR",
                        help="TCP bind address (default loopback: requests carry client-chosen "
                             "file paths, so expose it only on trusted networks)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs (default: the CUDA card)")
    args = parser.parse_args(argv)

    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.models.core_model import (
        check_kernel_dtype,
        describe,
        init_decode_model,
        init_support_branch,
    )
    from cor_tpu_torch.retrieval.index import load_gallery_index
    from cor_tpu_torch.retrieval.serve import RetrievalServer
    from cor_tpu_torch.utils.convert import load_configured_weights

    cfg = load_eval_config(args.config) if args.config else EvalConfig()
    if cfg.missing_checkpoints():
        parser.error(f"config names checkpoints that do not exist: {cfg.missing_checkpoints()}")
    core_cfg = cfg.core_config()
    try:
        check_kernel_dtype(cfg.core_config(), args.device)
    except ValueError as e:
        parser.error(str(e))
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is available; pass --device cpu to serve on the CPU")
    model = init_support_branch(core_cfg, cfg.seed)
    decode_model = init_decode_model(core_cfg, cfg.seed) if args.decode_masks else None
    load_configured_weights(cfg, core_cfg, {"support_branch": model, **(
        dict(decode_model.named_children()) if decode_model is not None else {})}, log)
    index = load_gallery_index(args.gallery_index)
    try:
        server = RetrievalServer(
            core_cfg, model, index, k=args.k, quantize=args.int8,
            tokenizer_path=cfg.tokenizer_path, device=args.device,
            decode_model=decode_model,
            decode_dir=args.decode_masks, store_hbm=args.store_hbm, approx=args.approx,
            rescore=args.rescore, rescore_width=args.rescore_width,
            recall_target=args.recall_target,
        )
    except ValueError as e:  # flags the index cannot serve (no store, --store-hbm alone)
        parser.error(str(e))
    max_batch = max(1, args.max_batch)
    server.warmup(batch_buckets=power_of_two_buckets(max_batch))
    log.info("serving %s on %s: gallery %d rows, k %d, %s%s%s scan, masks %s",
             describe(core_cfg), args.device, len(index["pair_ids"]), args.k,
             "int8" if args.int8 else "fp32", " approx (exact)" if args.approx else "",
             " + exact rescore" if args.rescore else "",
             ("int8 store on the device" if args.store_hbm else "host-streamed store")
             if args.decode_masks else "off")

    if args.tcp:
        serve_tcp(server, args.tcp_host, args.tcp, max_batch, ready_event)
        return server

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
