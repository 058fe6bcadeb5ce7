"""Decode-only benchmark: the store-indexed mask decode of the serving
pipeline, isolated, for each schedule of the fused two-way transformer. The
port of ``cor_tpu``'s ``tools/decode_bench.py``, with its shapes and
defaults: the SAM-base mask decoder in bf16 (random weights from a seed), a
synthetic store of ``--store`` rows of [64, 64, 256] with the dense no-mask
prompt added (int8 per row with ``--int8``), and ``--chunks`` chunks of
``--chunk`` candidates, each a random store row with one random sparse
prompt (6 tokens):

    python3 -m cor_tpu_torch.tools.decode_bench                  # K1 per layer
    python3 -m cor_tpu_torch.tools.decode_bench --variant dma    # K1-dma per layer
    python3 -m cor_tpu_torch.tools.decode_bench --variant stack  # K1-stack
    python3 -m cor_tpu_torch.tools.decode_bench --variant grid   # K1-grid
    python3 -m cor_tpu_torch.tools.decode_bench --int8           # int8 store (layer, dma)
    python3 -m cor_tpu_torch.tools.decode_bench --device cpu --chunk 2 --chunks 1 --store 2

The variant sets the flags of ``models/sam_decoder.py`` (``GRID_FUSED``,
``STACK_FUSED``, ``DMA_FUSED``) for the run. On the card each window decodes
every chunk once, timed with CUDA events after a warm-up pass; the tool
prints one JSON line: ms per chunk (the median of ``--iters`` windows and
their spread), candidates/s, the variant, each decoder kernel's launches per
chunk, and the card's name and power limit. ``--device cpu`` runs the
kernels' plain versions and times with the host's clock.

``cor_tpu``'s ``--semantics`` and ``--cost`` are Mosaic scheduler hints,
which have no CUDA counterpart: they are refused. ``--variant grid`` or
``stack`` with ``--int8`` is refused too: ``cor_tpu``'s router sends an int8
store to the per-layer kernel, and the tool would report K1's time under
another kernel's name.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cor_tpu_torch.models import sam_decoder
from cor_tpu_torch.models.core_model import CoreConfig, init_decode_model
from cor_tpu_torch.models.prompt_encoder import get_dense_pe
from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash, t2i_flash_kv
from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_dma
from cor_tpu_torch.ops.kernels.two_way_stack import two_way_grid_fused, two_way_stack_fused

VARIANTS = {"layer": (), "dma": ("DMA_FUSED",), "stack": ("STACK_FUSED",),
            "grid": ("GRID_FUSED",)}
DECODER_KERNELS = (two_way_layer, two_way_layer_dma, two_way_stack_fused, two_way_grid_fused,
                   t2i_flash_kv, proj_q_t2i_flash, i2t_attention_fused, decoder_tail)
GRID, WIDTH = 64, 256  # SAM-base's image-embedding grid and width
MIN_WINDOWS = 5


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()


def quantize_rows(x: torch.Tensor):
    """int8 per-row symmetric quantisation of a store [S, H, W, C] (fp32):
    (int8 store, fp32 scales [S]), ``engine.quantize_candidate_store_host``'s
    arithmetic on the tensor's device."""
    flat = x.reshape(x.shape[0], -1)
    sc = (flat.abs().amax(dim=1) / 127.0).clamp_min(1e-12)
    q = torch.clamp(torch.round(flat / sc[:, None]), -127, 127).to(torch.int8)
    return q.reshape(x.shape), sc


@torch.inference_mode()
def make_inputs(store: int, chunk: int, chunks: int, int8: bool, device, seed: int = 0) -> dict:
    """The decoder and prompt PE (bf16), the store (bf16, or int8 with its
    scales) and per chunk the store rows and sparse prompts."""
    cfg = CoreConfig()
    model = init_decode_model(cfg, seed).to(device, torch.bfloat16).eval()
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    no_mask = model.prompt_encoder.no_mask_embed[0].float()
    raw = torch.randn(store, GRID, GRID, WIDTH, generator=gen, device=device)
    raw = raw.to(torch.bfloat16).float() + no_mask
    scales = None
    if int8:
        rows, scales = quantize_rows(raw)
    else:
        rows = raw.to(torch.bfloat16)
    del raw
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, store, (chunks, chunk)).astype(np.int32)).to(device)
    prompts = torch.from_numpy(rng.standard_normal((chunks, chunk, 1, WIDTH), dtype=np.float32))
    return {"decoder": model.mask_decoder, "pe": get_dense_pe(model.prompt_encoder).to(
                device, torch.bfloat16),
            "store": rows, "scales": scales, "idx": idx,
            "prompts": prompts.to(device, torch.bfloat16)}


def decode_all(x: dict) -> torch.Tensor:
    """Every chunk once: masks, predicted IoU and their sum (kept on the
    device)."""
    total = torch.zeros((), device=x["store"].device)
    for c in range(x["idx"].shape[0]):
        masks, iou, _ = sam_decoder.mask_decoder(
            x["decoder"], x["store"], x["pe"], x["prompts"][c], None, False,
            store_idx=x["idx"][c], store_scale=x["scales"])
        total = total + masks.float().sum() + iou.float().sum()
    return total


@torch.inference_mode()
def run(variant: str = "layer", int8: bool = False, store: int = 128, chunks: int = 8,
        iters: int = 20, chunk: int = 128, device: str = "cuda", seed: int = 0) -> dict:
    """Build the inputs, decode them under ``variant``'s flag and time it;
    the result line as a dict."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {sorted(VARIANTS)}")
    if int8 and variant in ("grid", "stack"):
        raise ValueError(f"--variant {variant} takes no int8 store: cor_tpu's router runs the "
                         f"per-layer kernel (K1) there")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("decode_bench --device cuda needs a CUDA card")
    if dev.type == "cuda" and iters < MIN_WINDOWS:
        raise ValueError(f"--iters {iters}: the card's time is the median of at least "
                         f"{MIN_WINDOWS} windows")
    x = make_inputs(store, chunk, chunks, int8, dev, seed)
    flags = {f: getattr(sam_decoder, f) for f in ("GRID_FUSED", "STACK_FUSED", "DMA_FUSED")}
    try:
        for f in flags:
            setattr(sam_decoder, f, f in VARIANTS[variant])
        before = [(k.launches, k.launches_fp32) for k in DECODER_KERNELS]
        check = decode_all(x)  # warm-up (and on the card the kernels' build)
        launches = {k.__name__: (k.launches + k.launches_fp32 - sum(b)) / chunks
                    for k, b in zip(DECODER_KERNELS, before)}
        if not torch.isfinite(check):
            raise RuntimeError(f"decode_bench {variant}: the masks are not finite")
        per_chunk = []
        for _ in range(iters):
            if dev.type == "cuda":
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                decode_all(x)
                end.record()
                end.synchronize()
                per_chunk.append(start.elapsed_time(end) / chunks)
            else:
                t0 = time.perf_counter()
                decode_all(x)
                per_chunk.append((time.perf_counter() - t0) * 1e3 / chunks)
    finally:
        for f, v in flags.items():
            setattr(sam_decoder, f, v)
    ms = statistics.median(per_chunk)
    return {"variant": variant, "int8": int8, "store": store, "chunk": chunk, "chunks": chunks,
            "windows": iters, "ms_per_chunk": ms, "ms_min": min(per_chunk),
            "ms_max": max(per_chunk), "candidates_per_s": chunk / ms * 1e3,
            "timer": "cuda events" if dev.type == "cuda" else "host clock",
            "launches_per_chunk": {k: v for k, v in launches.items() if v},
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "card": card() if dev.type == "cuda" else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", choices=sorted(VARIANTS), default="layer")
    ap.add_argument("--int8", action="store_true",
                    help="int8 per-row quantised store, dequantised in the first layer")
    ap.add_argument("--iters", type=int, default=20, help="timed windows")
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=128, help="candidates per chunk")
    ap.add_argument("--store", type=int, default=128, help="store rows")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--semantics", choices=["parallel", "arbitrary"], default=None)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args(argv)
    if args.semantics is not None or args.cost:
        ap.error("--semantics and --cost are Mosaic (TPU) scheduler hints, which have no CUDA "
                 "counterpart")
    if args.int8 and args.variant in ("grid", "stack"):
        ap.error(f"--variant {args.variant} takes no int8 store: cor_tpu's router runs the "
                 f"per-layer kernel (K1) there, and its time would be reported as "
                 f"{args.variant}'s")
    out = run(args.variant, args.int8, args.store, args.chunks, args.iters, args.chunk,
              args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
