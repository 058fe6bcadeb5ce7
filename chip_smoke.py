#!/usr/bin/env python3
"""Drive cor_tpu_torch once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; no phase catches an exception):
 1. device: the card's name and power limit (nvidia-smi), and torch's TF32
    flags as found. Each phase prints the flags it finds on entry; the
    kernel-check phases (3, 10, 14, 18, 23-24, 29, 33, 35, 37) turn TF32
    off for themselves, so that the plain fp32 versions they hold the
    kernels to are full fp32, and restore it; every other phase runs the
    entry points under torch's default flags (cuDNN TF32 allowed), as a
    user's run does;
 2. build: every CUDA kernel from cor_tpu_torch/csrc (one nvcc per source,
    in parallel), with each kernel's registers and spills from ptxas; then
    the twelve test files that hold tests marked `gpu` (GPU_TEST_FILES) in a
    pytest process of their own, their count and
    test_two_way_layer_dma_kernel_equals_k1's cases by name. From here on
    the seeded CPU inits draw once per configuration
    (``memoize_seeded_inits``): every entry point that asks again gets a
    copy of the same weights;
 3. kernels: each kernel against its plain PyTorch version on identical bf16
    inputs at the serving path's shapes (K4, K5: batch 16 of
    ViT-B-16-SigLIP-384; K1, K2, K3: 40 candidates of the SAM-base decoder
    on the 64 x 64 grid, K1's layer 0 out of a 2,048-row int8 store), both
    timed with CUDA events beside the one PyTorch call that computes the
    same function where there is one (SDPA for K4, F.layer_norm for K5);
    K4, K5 and their library calls (here and in phases 18, 29 and 37, K4′
    and K5′ too) also as CUDA-graph replays (``device_ms``,
    ``library_device_ms``), which leave the host's launches out;
 4. serve: a synthetic 127,166 x 256 gallery index (the COR127K triplet
    count), then ``cor_tpu_torch.cli.serve.main`` with --self-test 8 at full
    ViT-B-16-SigLIP-384 width (random weights from seed 0), fp32 and --int8
    scans; checks every response and the kernels' launch counts;
 5. numerics: GPU bf16 queries against the same weights' CPU fp32 queries,
    per-query cosine >= 0.99;
 6. timings: encode+scan latency per batch bucket (1, 4, 16) and responses/s
    of the self-test loop, with the card's name and power limit, beside
    820e02d's run (before K4/K4′ and K6b were redesigned);
 7. decode serve: a synthetic 2,048-row index with a [2048, 64, 64, 256]
    fp16 store (4 GiB on disk, drawn on the card and written in chunks), then ``cli.serve.main``
    with --decode-masks, --self-test 8, --max-batch 4, --k 10, host-streamed
    and with --store-hbm; checks every response and PNG, every kernel's
    launch count per decode, and the two configurations' masks against each
    other;
 8. decode numerics: 4 candidates decoded on the card in bf16 and on the
    CPU in fp32 with the same weights, per-candidate logit cosine >= 0.99;
 9. decode timings: encode+scan+decode latency per batch at buckets 1 and 4
    (--store-hbm), responses/s of the --decode-masks loop (--store-hbm with
    and without the PNG writing, and host-streamed), and a torch.profiler
    breakdown of the device time at bucket 4 (--store-hbm);
10. encoder kernels: K6 against its plain version at the SAM-base global
    shape (qkv [2, 4096, 2304]) and windowed shape (50 windows of 14 x 14,
    the last key tile masked), with random bias factors, max relative error
    <= 2e-2, timed beside SDPA with the additive bias; K5 at the encoder's
    [8 * 4096, 768] and the neck's [8 * 4096, 256];
11. gallery build: ``cor_tpu_torch.cli.index.main`` --synthetic 64
    --batch-size 8 --with-store at full SAM-base width; checks the JSON
    line, 64 unit-norm rows, the finite [64, 64, 64, 256] fp16 store and
    K6 / K5 launches (12 / 26 per encoded batch); then ``cli.serve.main``
    --decode-masks --store-hbm --self-test 8 on that index, every response
    and PNG checked;
12. encoder numerics: one candidate through the encoder (rel-pos tables and
    pos_embed filled from a seed) on the card in bf16 and on the CPU in
    fp32 with the same weights, cosine >= 0.99 of the flattened and of the
    pooled embedding; one ``core_forward`` at full width (batch 2) on the
    card, its query embeddings equal to the encoder's;
13. build timings: the encode per batch at batch 1 and 8 (CUDA events),
    candidates/s of the encode, of the host's synthetic data alone and of
    the CLI build, the reckoned time for 127,166 candidates, and a
    torch.profiler breakdown of one batch-8 encode with the GELU and the
    window partition timed alone at the encoder's shapes;
14. K6b: the backward kernel, given K6's out and row log-sum-exp as
    autograd saves them, against its plain version at the global shape
    (qkv [2, 4096, 2304]) and the windowed one ([50, 196, 2304]), random
    bias factors and cotangent, max relative error <= 2e-2 for dqkv, drel_h
    and drel_w; timed beside the plain version and the autograd backward
    of SDPA with the materialised bias requiring grad (the bound counts the
    gradient's five N x N x D products; the kernel runs seven);
15. training: ``cor_tpu_torch.cli.train.main --synthetic`` on
    configs/train_config_m3.yaml's keys (epoch 1: 4 steps at batch 10, a
    2-batch val epoch), frozen and with ``freeze_towers: false``: finite
    losses, the val metrics line, best_model and best_model_full written;
    frozen, the towers, the IoU head and the PE matrix bit-identical and no
    K6b launch; unfrozen, a leaf of each tower moved, K6b 12 launches per
    step and K6 24 (remat) plus 12 per val batch;
16. training numerics: one unfrozen step at full width, batch 1 (rel-pos
    tables and pos_embed filled from a seed, no dropout, "add" fusion), on
    the card in bf16 and in fp32, each against the CPU in fp32: bf16 loss
    within 2e-2 and gradient cosines >= 0.99, fp32 (K6b@fp32 once per block,
    no bf16 launch) loss within 1e-4 and cosines >= 0.9999, for a windowed
    block's qkv, a global block's rel_pos_h and qkv, the patch embed, a
    SigLIP block's qkv and the decoder's first layer; then the decoder alone
    on the card in bf16 against fp32 over 3 seeds (each layer's q_proj
    gradient cosine, reported, not gated);
17. training timings at batch 10, frozen and unfrozen: seconds per step
    (CUDA events, median and spread of 6 steps), samples/s, peak memory,
    and a torch.profiler breakdown of one unfrozen step by layer; the
    unfrozen s/step beside 820e02d's;
18. the largest configuration's kernels: K4′ (head_dim 72) at
    ViT-SO400M-14-SigLIP-384's qkv [16, 729, 3456] and [16, 64, 3456]
    through both entries (fused QKV and [B, H, N, D]), K6 at sam_huge's
    head_dim 80 (global [2, 4096, 3840], windowed [50, 196, 3840]) and K5
    at widths 1152 and 1280, each against its plain version (max relative
    error <= 2e-2), timed beside the plain version, SDPA (with the
    materialised bias for K6) or F.layer_norm, and the bound;
19. gallery build at the largest configuration (CFG: a flat copy of
    configs/vaild_config.yaml with sam_model_name sam_huge and
    siglip_model_name ViT-SO400M-14-SigLIP-384, written to a temporary
    directory): ``cli.index.main`` --config CFG --synthetic 16 --batch-size
    8 --with-store; the JSON line, unit-norm rows, a finite store, and K6 /
    K5 launches of exactly 32 / 66 per encoded batch;
20. serving at CFG: ``cli.serve.main`` --config CFG --self-test 8
    --max-batch 4 over the 127,166-row gallery, fp32 and --int8 scans (K4 /
    K5 exactly 54 / 110 per encoded batch), then --decode-masks --store-hbm
    on phase 19's index, every response and PNG checked;
21. numerics at CFG: SO400M queries GPU bf16 against CPU fp32 (cosine >=
    0.99); one candidate through sam_huge at full depth (rel-pos tables and
    pos_embed filled) GPU bf16 against CPU fp32 (cosine >= 0.99); one
    ``core_forward`` at CFG, batch 2, on the card;
22. timings at CFG: encode+scan latency at buckets 1, 4, 16 (beside
    820e02d's);
    encode+scan+decode at bucket 4 (--store-hbm); the sam_huge encode at
    batch 1 and 8 with candidates/s and the reckoned time for 127,166
    candidates; the CPU init time of the random weights; peak memory; a
    torch.profiler breakdown of one bucket-16 query encode and one batch-8
    image encode;
23. K6b at sam_huge's head_dim 80 (global [2, 4096, 3840], windowed
    [50, 196, 3840]), given K6's out and lse, against its plain backward,
    max relative error <= 2e-2 (as at 64), timed beside the plain version,
    SDPA's backward with the bias and the bound;
24. K7 at SAM-base's and sam_huge's padded grids (qkv [2, 70, 70, 2304] and
    [2, 70, 70, 3840], windows of 14, cropped to 64 x 64) against its plain
    version (<= 2e-2) and, bit for bit, K6 on the partitioned windows; timed
    beside the plain version, SDPA with the bias, the bound, and the
    attention step either way (pad + K7; partition + K6 + unpartition);
25. the full-depth encoders (SAM-base, sam_huge; tables and pos_embed
    filled) at batch 8 with and without fused_window_indexing through
    make_candidate_encoder: exact launch counts (K7 8 / 28 and K6 4, or K6
    12 / 32), cosine >= 0.999 between the two, ms per batch;
26. training at CFG: ``cli.train.main --synthetic`` on m3's keys with
    sam_huge and ViT-SO400M-14-SigLIP-384, frozen then unfrozen, at full
    width, batch 10, sam_huge cut to its first 4 blocks (block 3 global, as
    in phase 28; phase 32's fp32 training takes the same cut): finite losses,
    the val line, the saves; frozen, the towers bit-identical and no K6b
    launch; unfrozen, the towers moved, K6b 4 launches per step and K6 8
    plus 4 per val batch;
27. the unfrozen CFG step (phase 26's trainer, 4 blocks): launches of one
    step, s per step (CUDA events, 3 steps; beside 820e02d's), samples/s,
    peak memory, a torch.profiler breakdown of one step;
28. numerics at CFG: phase 16's check (GPU bf16 and GPU fp32 against CPU
    fp32) with sam_huge cut to 4 blocks (block 3 global) at full width and
    the towers at full depth;
29. fp32 kernels (compute_dtype float32: 3xTF32 products): K5 at the
    towers', encoder's and neck's shapes, K4 at [16, 576, 2304] and
    [16, 64, 2304], K4′ at 72 (both entries) and 80, K6 at 64 and 80
    (global and windowed; out the same bits with its lse written), K7 at
    [2, 70, 70, 3C] (C 768 and 1280; K6 and K7 also as CUDA-graph replays
    beside SDPA with the bias, and K6 writing its lse), K6b at
    64 and 80 (global and windowed; its errors against a float64 run
    printed too), K5 also at the largest configuration's widths 1152 and
    1280, K1
    (layer 0 from the 2,048-row int8 store, layer 1 on fp32 rows), K2, K1 +
    K2 through the two-way transformer, and K3, each against its plain fp32
    version with TF32 off at cor_tpu's fp32 tolerance (FP32_TOL), timed
    beside the plain version, the library call (SDPA, SDPA with the bias,
    SDPA's backward with the bias, F.layer_norm) and the fp32 bound
    (PEAK_FP32_FLOP_S);
30. the fp32 paths at full SAM-base + ViT-B-16-SigLIP-384 width, on
    configs/vaild_config.yaml's and train_config_m3.yaml's keys with
    compute_dtype float32: cli.index --with-store (32 candidates), cli.serve
    --decode-masks --store-hbm --self-test 8 with the fp32 and --int8 scans
    (every response and PNG, exact fp32 launch counts, no bf16 launch), GPU
    fp32 against CPU fp32 cosines (queries and image embeddings >= 0.9999,
    mask logits >= 0.999), cli.train frozen (the towers bit-identical, K1-K3
    in its val step) and unfrozen (the towers moved; K6b@fp32 12 and K6@fp32
    24 per step plus 12 per val batch; no bf16 launch);
31. fp32 beside bf16, one index and the same weights: encode+scan at
    buckets 1, 4, 16, encode+scan+decode at 1 and 4, a batch-8 SAM-base
    encode (and fp32 with fused_window_indexing: K7's fp32 launches), a
    frozen and an unfrozen train step at batch 10 with their peak memory,
    and a torch.profiler breakdown of one served call at bucket 4 in each
    dtype and of one unfrozen fp32 step;
32. the fp32 paths at CFG, full depth and width: cli.index --synthetic 16
    (K6@fp32 32 and K5@fp32 66 per encoded batch), cli.serve over the
    127,166-row gallery with the fp32 and --int8 scans (K4′@fp32 54 and
    K5@fp32 110 per encoded batch), --decode-masks --store-hbm on the index,
    unfrozen cli.train on m3's keys at batch 10 with sam_huge cut to 4
    blocks (K6b@fp32 4 per step), every launch fp32; then the step's seconds
    (CUDA events), samples/s and peak memory in one pass and split by
    grad_accum 2 (K6b@fp32 8);
33. the decoder kernels at SAM's stock prompts' token counts, 40 candidates
    on the 64 x 64 grid, bf16 and fp32 (TF32 off): K1 at 5, 7 and 8 tokens
    (layer 0 from the 2,048-row int8 store, layer 1 on rows), K2 at 5, 7, 8,
    9, 16 and 32, K8a (proj_q_t2i_flash) and K8b (i2t_attention_fused) at 9,
    11, 16 and 32, each against its plain version (bf16: max relative error
    <= 2e-2; fp32: K1 and K8b 2e-4, K2 and K8a 5e-4), timed beside the plain
    version and the bound, K8a and K8b (one launch each, on K1's Hopper
    passes) also as CUDA-graph replays;
34. SAM's stock prompts at full width: the SAM-base encoder (full depth,
    tables and pos_embed filled) embeds 2 query images; the full prompt
    encoder (random weights from a seed, on the card and on the CPU) encodes
    13 prompt sets (a mask; 1, 2, 3, 10, 26 points; a box; a box and 4
    points; those up to 11 tokens again with a 256 x 256 mask prompt: 5 to
    32 tokens); mask_decoder(fused=True, multimask) decodes each on the card
    in bf16 and fp32 and on the CPU in fp32, same weights: mask-logit cosine
    >= 0.99 (bf16) and >= 0.999999 (fp32), predicted IoU within 2e-2 (bf16),
    the fp32 error beside cor_tpu's decoder tolerance, exact launches per
    call (K1 8, K2 1, K3 1 up to 8 tokens; K8a 4, K8b 2, K2 1, K3 1 above);
    one store-indexed decode at 9 tokens from an int8 store (gather and
    dequantisation in torch, then K8a/K8b), cosine >= 0.99; the decode's ms
    at batch 8 and 6, 8, 9, 16, 32 tokens in bf16 and fp32, and a
    torch.profiler breakdown at 16 tokens;
35. the opt-in decode schedules' kernels at 40 candidates on the 64 x 64
    grid, 5, 6 and 8 tokens, bf16 and fp32 (TF32 off): K1-dma
    (two_way_layer_dma) against K1 bit for bit with rows, a store through
    idx and an int8 store; K1-stack (two_way_stack_fused) and K1-grid
    (two_way_grid_fused) against their plain version (bf16 max relative
    error <= 2e-2; fp32 cor_tpu's transformer tolerance 5e-4) with and
    without a store index, K1-grid's keys against two K1 launches bit for
    bit; each timed beside its plain version (and K1-dma beside K1) and the
    bound; then one fused decode of 8 per schedule flag (exact launches:
    K1-stack or K1-grid and K3, 2 in all; an int8 store with GRID_FUSED or
    STACK_FUSED goes to K1), its ms at 6 tokens and a profile of K1-grid's;
36. cor_tpu_torch.tools.decode_bench at its defaults (the SAM-base decoder,
    bf16, a 128-row store, 8 chunks of 128 candidates, 20 windows) for
    each variant (layer, dma, stack, grid) and with --int8 for layer and
    dma: exact launches per chunk, each JSON line printed;
37. the last two TPU kernels, whose only callers in either package are
    tests: their entry points once per dtype (K5′ add_layer_norm forward,
    and forward and backward through autograd, at [32768, 256]; K9
    fused_upscale2_hyper at x [40, 128, 128, 64], O 32, N 4; exact launches,
    the kernels line's count), then K5′ at K5's shapes ([9216, 768], [32768,
    768], [32768, 256], [11664, 1152], [32768, 1280]) and K9 at cor_tpu's
    test shape and the decoder's (N 1 and 4), bf16 and fp32 (TF32 off),
    each against its plain version (K5′ bf16 max relative error <= 2e-2,
    fp32 1e-5, one fp32 backward at 1e-5; K9 1e-4 in both), timed beside
    the plain version, the library call or composition and the bound (K5′
    beside F.layer_norm(x + y), two calls, and x + y followed by K5; K9
    beside F.conv_transpose2d + F.gelu + torch.einsum and K3 on the
    [40, 64, 64, 256] input whose maps are as large);
38. P6 under torch's default flags: the fp32 SAM-base neck and the decoder's
    first upscale on the card, run as the port ran them before the repair
    (raw cuDNN calls, TF32 allowed) and through its helpers (TF32 off for
    the call, forward and backward), against the CPU in fp32 (the helpers'
    outputs and input gradients within 1e-5 relative), with their ms.
39. the Recall@K protocol (cor_tpu_torch.cli.retrieve,
    retrieval/protocol.py) at SAM-base + ViT-B-16-SigLIP-384 in bf16 and
    fp32 over 128 synthetic triplets, and at CFG in bf16 and fp32 over 32,
    k 10, random weights from seeds (recall near chance): ``cli.retrieve
    --rerank`` once (SAM-base bf16); one ``encode_manifest(keep_store=True)`` with the
    CLI's seeded weights and the recalls from it with and without the IoU
    rerank and with the int8 scan (recall@10 the same with and without the
    rerank, or the phase fails); encode, scan and decode seconds and
    candidates decoded per second (1,280 candidates in 10 chunks of 128 at
    SAM-base, 320 in one call at CFG); launches per chunk (K1 8, K2 1, K3
    1); one chunk's IoU through the kernels against the plain versions on
    the card (bf16 within IOU_TOL of max(1, |IoU|), fp32 within
    DECODE_TOL32), and the IoU-ranked ids against the plain versions' across
    IoU gaps above that; then, at SAM-base (cut at CFG for time),
    ``cli.index --with-store`` on the same triplets and ``cli.retrieve
    --gallery-index`` with and without --rerank, whose recalls without it
    equal the one pass's;
40. TCP serving: ``cli.serve --tcp`` on loopback (SAM-base bf16,
    --decode-masks --store-hbm, k 10) over phase 39's SAM-base index, in a
    thread of this process, the clients in a process of their own; {4, 8}
    closed-loop clients x --max-batch {4, 8}: responses/s, p50/p99
    latency and requests a batch (K3 launches), every response's id back to its own
    client with 10 results and 10 masks; then --rescore --int8 and --approx
    served, one request at a time, against the fp32 scan's answers (ids
    across score gaps above 1e-5, scores within 1e-5, cor_tpu's rescore
    test tolerance);
41. checkpoints at full width (SAM-base + ViT-B-16-SigLIP-384,
    MaskAdapterPooling, the seeded fp32 model): saved as the port's
    checkpoint directory, turned into the reference's .pth by
    ``cli.export``, and written as a SAM .pth (its no_mask_embed changed)
    and a SigLIP .bin by the port's exporters; ``load_trained_params`` of
    the .pth and of the directory into a model seeded otherwise gives
    every parameter bit for bit, ``build_model_with_query_support_feat``
    from the .pth and the .bin gives the encoder, the decoder and the
    towers bit for bit and leaves no_mask_embed at its fresh init; the
    write and load seconds;
42. evaluation from files: two splits of 12 triplets over two Dataset
    folders written as PNGs by the port's writer (query images at 480 x
    640, 768 x 1024, 900 x 1200 and 1024 x 1024, scanline filters 0-4;
    gray masks, an RGB and a palette query mask; Targets 007 and 12; a
    Compose = 1 row at each manifest's end), then ``cli.eval.main --soft``
    with phase 41's .pth at the config's batch 10 (batches of 10 and 2 per
    split): exact launches per batch (K4 24, K5 76, K6 12, K1 8, K2 1, K3
    1), every hard and soft mask at its native size, no sample skipped, one
    CSV row per manifest row with finite metrics in [0, 1], the first
    batch's bf16 predictions against the port's CPU path in fp32 on the
    same weights (cosine >= COS_MIN, its first EVAL_CPU_ROWS rows); then
    the sweep again, warm: images/s, the loader's host wait, the forward's
    device seconds (CUDA events) and the host's masks and metrics;
43. training from files: a training split of 2 batches (20 triplets) and a
    validation split of one batch written as phase 42's are (query images
    at its four sizes, an RGB and a palette mask each); the train loader's
    samples/s on the host with its augmentation and without (the same rows,
    train=False); ``cli.train.main`` on m3's keys with the manifests, epoch
    1, train_model_save_epoch 1 and async_checkpoint true: exact launches
    (K4 24, K5 76, K6 12 per step; K4 24, K5 76, K6 12, K1 8, K2 1, K3 1 for
    the val batch), finite losses, the val line, each step's device ms and
    the loop's seconds between steps; checkpoint_epoch_1, best_model and
    best_model_full loaded, their params the trained model's bit for bit;
    the seconds a full-state save holds the loop without and with the async
    writer; warm s/step (CUDA events), samples/s and peak memory; a second
    ``main()`` on the same path resumes ("Resumed from checkpoint_epoch_1")
    with the saved weights; then ``cli.eval.main --visualize 3`` on
    best_model (exact launches of one batch, three panel PNGs of the
    expected size with no blank panel and a caption).
The line before the last lists every kernel ({"kernels": [...]}; an fp32
instantiation is an entry of its own, name@fp32, with its fp32 launches);
the last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import zlib
from pathlib import Path

import numpy as np
import torch

SEED = 0
GALLERY_ROWS = 127_166  # COR127K triplets
DIM = 256
BATCH = 16  # the kernels are checked and timed at the largest serving bucket
KERNEL_TOL = 2e-2  # ~1 bf16 ulp at |y| <= 4; statistics and softmax are fp32 in both
DECODE_REL = 2e-2  # max |kernel - plain| / max |plain| for K1, K2, K3
COS_MIN = 0.99
CANDIDATES = 40  # --max-batch 4 x --k 10: the candidates of one decoded batch
STORE_ROWS = 2_048  # the decode phases' candidate store
GRID, SAM_C = 64, 256  # SAM-base image-embedding grid and width
SAM_BATCH = 8  # the gallery build's batch
BUILD_ROWS = 64  # candidates of the phase-11 build
# the largest configuration the repository supports, as config keys
LARGE_KEYS = {"sam_model_name": "sam_huge", "siglip_model_name": "ViT-SO400M-14-SigLIP-384"}
LARGE_BUILD_ROWS = 16  # candidates of the phase-19 build
BASE_TOWERS = (24, 50)  # K4, K5 launches per query encode: ViT-B-16-SigLIP-384
LARGE_TOWERS = (54, 110)  # the same at ViT-SO400M-14-SigLIP-384 (27 layers per tower)
MASK_AGREE_MIN = 0.99  # host-streamed fp16 vs int8 store: pixels that agree
# H100 SXM peaks (NVIDIA data sheet, dense): the bounds of the kernel table
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12
# the end-to-end figures before K4/K4′ and K6b were redesigned (this
# script's run of 820e02d on an H100 80GB HBM3 at 700 W): median [min, max]
BEFORE_REDESIGN = {
    "timings": {"1": (22.964, 21.311, 23.458), "4": (22.806, 22.424, 24.250),
                "16": (34.750, 34.714, 34.907)},  # phase 6, encode+scan ms
    "large_timings": {"1": (28.498, 27.120, 30.643), "4": (44.959, 44.214, 45.349),
                      "16": (130.079, 130.054, 130.107)},  # phase 22
    "train_unfrozen": (1.0681, 1.0372, 1.1689),  # phase 17, s per step
    "large_train": (1.1315, 1.1033, 1.1963),  # phase 27, s per step (4 blocks)
}


START = time.perf_counter()
_LAST_MARK = [START]


def mark(what: str) -> None:
    """The script's wall time so far, and the seconds since the last mark (the
    phase's own), after ``what``."""
    now = time.perf_counter()
    print(f"  [{now - START:.1f} s since the start, {now - _LAST_MARK[0]:.1f} s of its own: "
          f"{what} done]", flush=True)
    _LAST_MARK[0] = now


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, windows: int = 7, iters: int = 10):
    """Median, min and max milliseconds per call over ``windows`` windows of
    ``iters`` calls, timed with CUDA events after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call), min(per_call), max(per_call)


def device_times(kernel, library=None) -> dict:
    """The median device milliseconds of the kernel's call and of its
    library call, as CUDA-graph replays (the host's launches, which set a
    small kernel's time in ``cuda_ms``, stay out): {"device_ms": ...,
    "library_device_ms": ...}."""
    from cor_tpu_torch.tools.kernel_bits import graph_ms

    out = {"device_ms": graph_ms(kernel)}
    if library is not None:
        out["library_device_ms"] = graph_ms(library)
    return out


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}; torch's defaults: {tf32_flags()}", flush=True)
    return name, smi


def phase_build():
    from cor_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    print(f"phase 2 build: {path.name} in {dt:.1f} s", flush=True)
    # ptxas -v: per compiled kernel (template cases apart), registers, shared
    # memory and spill bytes
    names = ("layer_norm_kernel", "seq_attention_kernel", "seq_attention_f32_kernel",
             "twl_tokens_in_kernel", "t2i_image_kernel", "twl_tokens_mid_kernel",
             "twl_image_i2t_kernel", "twl_t2i_kernel", "twl_i2t_kernel",
             "twl_tokens_in_cluster_kernel", "twl_tokens_mid_cluster_kernel",
             "t2i_combine_kernel", "t2i_final_kernel", "t2i_proj_q_kernel", "decoder_tail_kernel",
             "vit_attention_relpos_kernel", "vit_attention_relpos_f32_kernel",
             "vit_attention_bwd_dq_kernel", "vit_attention_bwd_dkv_kernel",
             "vit_attention_bwd_prep_kernel",
             "vit_attention_bwd_dq_f32_kernel", "vit_attention_bwd_dkv_f32_kernel",
             "dma_t2i_kernel", "dma_i2t_kernel", "two_way_fused_kernel",
             "upscale2_hyper_kernel")
    kernel, spills, regs, done = None, {}, {}, []
    for line in path.with_suffix(".log").read_text().splitlines():
        if line.startswith("# ") and ".cu: done " in line:
            done.append(line[2:].replace(" after the build started", ""))
        elif "Compiling entry function" in line:
            mangled = line.split("'")[1]
            kernel = next((n for n in names if n in mangled), mangled)
            rest = mangled[mangled.find(kernel) + len(kernel):]
            if rest.startswith("I"):  # a template case, e.g. <Lb1ELb0E> = <true, false>
                kernel += f"<{rest[1:rest.find('EE') + 1]}>"
        elif "spill" in line and kernel:
            spills[kernel] = line.strip()
        elif "Used" in line and "registers" in line and kernel:
            regs[kernel] = line.split(":", 1)[1].strip()
    for k in regs:
        if "layer_norm" not in k or "spill stores, 0 bytes spill loads" not in spills.get(k, ""):
            print(f"  ptxas {k}: {regs[k]}; {spills.get(k, '')}")
    spilled = [k for k, v in spills.items() if not v.startswith("0 bytes stack frame, 0 bytes spill")]
    print(f"  ptxas: {len(regs)} kernels, spills in {spilled or 'none'}")
    print(f"  nvcc, each source: {'; '.join(done)}", flush=True)
    return dt


def bound(n_bytes: float, flops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k3_simt_flops(pixels: int, maps: int, dt) -> float:
    """K3's work outside the tensor cores, counted from csrc/decoder_tail.cu
    (an FMA 2): each of a pixel's 256 first-product values takes b1 (1), the
    LayerNorm's mean, variance and scale (8), GELU (bf16: the _PHI_COEF
    polynomial with its clamp, 18; fp32: the erf form, ~25) and bf16's
    rounding (1); each of its 512 second-product values b2, GELU and
    rounding; each map the dot (2 a value) and the quads' sums (128 a
    pixel)."""
    bf16 = dt == torch.bfloat16
    gelu, rnd = (18, 1) if bf16 else (25, 0)
    return pixels * (256 * (1 + 8 + gelu + rnd) + 512 * (1 + gelu + rnd) + maps * (2 * 512 + 128))


def k3_bound(src, hyper, out, dt):
    """K3's least time, the largest of three terms: the bytes (src, hyper, the
    maps), the two products on the tensor cores (bf16, or fp32's 3xTF32),
    and ``k3_simt_flops`` on the CUDA cores at 67 TFLOP/s. ((ms, "bytes" or
    "operations"), the term: "bytes", "tensor cores" or "CUDA cores")."""
    n, H, W, C = src.shape
    pixels = n * H * W
    peak = PEAK_BF16_FLOP_S if dt == torch.bfloat16 else PEAK_FP32_FLOP_S
    terms = {"bytes": nbytes(src, hyper, out) / PEAK_BYTES_S,
             "tensor cores": 2 * pixels * (C * 4 * 64 + 4 * 64 * 4 * 32) / peak,
             "CUDA cores": k3_simt_flops(pixels, hyper.shape[1], dt) / PEAK_FP32_SIMT_FLOP_S}
    term = max(terms, key=terms.get)
    return (1e3 * terms[term], "bytes" if term == "bytes" else "operations"), term


def entry(err, kern_t, plain_t, bound_ms_by, library_t=None, **extra):
    return {"max_abs_err": err, "ms": kern_t[0], "ms_min": kern_t[1], "ms_max": kern_t[2],
            "plain_ms": plain_t[0], "bound_ms": bound_ms_by[0], "bound_by": bound_ms_by[1],
            "library_ms": None if library_t is None else library_t[0], **extra}


def phase_kernels(device):
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
    from cor_tpu_torch.ops.kernels.seq_attention import (
        attention_seq_qkv,
        attention_seq_qkv_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)
    bf16 = torch.bfloat16
    rows = {"vision": BATCH * 576, "text": BATCH * 64}
    results = {}

    # K5 LayerNorm at the towers' [B*N, 768]
    scale = (1 + 0.1 * torch.randn(768, generator=gen, device=device)).to(bf16)
    bias = (0.1 * torch.randn(768, generator=gen, device=device)).to(bf16)
    ln_err, ln_t = 0.0, {}
    for tower, n in rows.items():
        x = (2 * torch.randn(n, 768, generator=gen, device=device) + 0.5).to(bf16)
        got = layer_norm(x, scale, bias, 1e-6)
        want = layer_norm_plain(x, scale, bias, 1e-6)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ln_err = max(ln_err, err)
        ln_t[tower] = (cuda_ms(lambda: layer_norm(x, scale, bias, 1e-6)),
                       cuda_ms(lambda: layer_norm_plain(x, scale, bias, 1e-6)),
                       cuda_ms(lambda: F.layer_norm(x, (768,), scale, bias, 1e-6)),
                       device_times(lambda: layer_norm(x, scale, bias, 1e-6),
                                    lambda: F.layer_norm(x, (768,), scale, bias, 1e-6)))
        dev = ln_t[tower][3]
        print(f"  K5 layer_norm [{n}, 768] bf16: max|d|={err:.3e} kernel "
              f"{ln_t[tower][0][0]:.4f} ms, plain {ln_t[tower][1][0]:.4f} ms, "
              f"F.layer_norm {ln_t[tower][2][0]:.4f} ms; graph replays: kernel "
              f"{dev['device_ms']:.4f} ms, F.layer_norm {dev['library_device_ms']:.4f} ms")
        if tower == "vision":
            ln_bound = bound(nbytes(x, scale, bias) + nbytes(x), 8 * x.numel())
    # fp32 input and ragged row count: the same kernel, other template cases
    x = torch.randn(1001, 768, generator=gen, device=device)
    err32 = (layer_norm(x, scale, bias) - layer_norm_plain(x, scale, bias)).abs().max().item()
    torch.cuda.synchronize()
    print(f"  K5 layer_norm [1001, 768] fp32: max|d|={err32:.3e}")
    if ln_err > KERNEL_TOL or err32 > 1e-4:
        fail(f"layer_norm kernel disagrees with its plain version: {ln_err} (bf16), {err32} (fp32)")
    v = ln_t["vision"]
    results["layer_norm"] = entry(ln_err, v[0], v[1], ln_bound, v[2], **v[3],
                                  text=ln_t["text"][3])

    # K4 sequence attention at qkv [B, N, 3*768], 12 heads
    at_err, at_t = 0.0, {}
    for tower, n in (("vision", 576), ("text", 64), ("ragged", 100)):
        qkv = torch.randn(BATCH, n, 3 * 768, generator=gen, device=device).to(bf16)
        got = attention_seq_qkv(qkv, 12)
        want = attention_seq_qkv_plain(qkv, 12)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        at_err = max(at_err, err)
        if tower != "ragged":
            q, k, v = (qkv[..., i * 768:(i + 1) * 768].unflatten(-1, (12, 64)).transpose(1, 2)
                       for i in range(3))
            at_t[tower] = (cuda_ms(lambda: attention_seq_qkv(qkv, 12)),
                           cuda_ms(lambda: attention_seq_qkv_plain(qkv, 12)),
                           cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)),
                           device_times(lambda: attention_seq_qkv(qkv, 12),
                                        lambda: F.scaled_dot_product_attention(q, k, v)))
            dev = at_t[tower][3]
            print(f"  K4 attention_seq_qkv [{BATCH}, {n}, 2304] bf16: max|d|={err:.3e} kernel "
                  f"{at_t[tower][0][0]:.4f} ms, plain {at_t[tower][1][0]:.4f} ms, "
                  f"SDPA {at_t[tower][2][0]:.4f} ms; graph replays: kernel "
                  f"{dev['device_ms']:.4f} ms, SDPA {dev['library_device_ms']:.4f} ms")
            if tower == "vision":
                at_bound = bound(nbytes(qkv) + nbytes(got), 4 * BATCH * 12 * n * n * 64)
        else:
            print(f"  K4 attention_seq_qkv [{BATCH}, {n}, 2304] bf16: max|d|={err:.3e}")
    if at_err > KERNEL_TOL:
        fail(f"attention_seq_qkv kernel disagrees with its plain version: {at_err}")
    v = at_t["vision"]
    results["attention_seq_qkv"] = entry(at_err, v[0], v[1], at_bound, v[2], **v[3],
                                         text=at_t["text"][3])
    results.update(decoder_kernels(device))
    print("phase 3 kernels: ok", flush=True)
    return results


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def abs_err(*pairs) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in pairs)


def k1_by_launch(label: str, args, kw) -> dict:
    """K1's device milliseconds by launch and for the layer's four launches
    together (``tools/kernel_bits.py`` ``k1_split``: CUDA-graph replays of
    ``two_way_layer.layer_launches``, which counts no launch), printed with
    the seconds the timing took."""
    from cor_tpu_torch.tools.kernel_bits import k1_split

    t0 = time.perf_counter()
    split = k1_split(*args, **kw)
    print(f"    K1 {label} by launch (device ms, graph replays): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f" [{time.perf_counter() - t0:.1f} s]", flush=True)
    return split


@torch.no_grad()
def decoder_kernels(device):
    """K1 (layer 0 out of a 2,048-row int8 store, and a bf16 layer 1), K2 and
    K3 against their plain versions at 40 candidates of the SAM-base decoder."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail, decoder_tail_plain
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv, t2i_flash_kv_plain
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain

    bf16 = torch.bfloat16
    n, N, C, I, T = CANDIDATES, GRID * GRID, SAM_C, 128, 6
    dec = init_mask_decoder(CoreConfig(), 1).to(device, bf16).eval()
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    tokens, kpe, qpe = rnd(n, T, C).to(bf16), (0.5 * rnd(N, I)).to(bf16), (0.5 * rnd(N, I)).to(bf16)
    store = torch.randint(-127, 128, (STORE_ROWS, N, C), generator=gen, device=device,
                          dtype=torch.int8)
    scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(STORE_ROWS, generator=gen, device=device))
    idx = torch.randperm(STORE_ROWS, generator=gen, device=device)[:n].to(torch.int32)
    keys = (0.5 * rnd(n, N, C)).to(bf16)
    # per candidate: packed [k|v|q] projection, i2t out-projection, both
    # attentions (logits and AV), and the token side (~8.6 M MACs)
    layer_flops = n * (2 * N * C * 3 * I + 2 * N * I * C + 4 * 2 * N * T * I + 2 * 8.6e6)
    weights = dec.transformer.layers[0]
    w_bytes = sum(p.numel() * p.element_size() for p in weights.parameters())
    out = {}

    cases = (
        ("two_way_layer", "layer 0, int8 store-indexed", dec.transformer.layers[0], store,
         dict(idx=idx, scale=scales), True,
         n * N * C + 8 * n),  # the gathered int8 rows, their idx and scales
        ("two_way_layer", "layer 1, bf16", dec.transformer.layers[1], keys, {}, False,
         nbytes(keys)),
    )
    k1 = {}
    for name, label, lp, rows, kw, skip, rows_bytes in cases:
        args = (lp, tokens, tokens, rows, kpe, qpe, skip)
        got_t, got_k = two_way_layer(*args, **kw)
        want_t, want_k = two_way_layer_plain(*args, **kw)
        torch.cuda.synchronize()
        err = max(rel_err(got_t, want_t), rel_err(got_k, want_k))
        kt = cuda_ms(lambda: two_way_layer(*args, **kw))
        pt = cuda_ms(lambda: two_way_layer_plain(*args, **kw), iters=3)
        b = bound(rows_bytes + nbytes(tokens, kpe, qpe, got_t, got_k) + nbytes(tokens) + w_bytes,
                  layer_flops)
        print(f"  K1 two_way_layer {label} [{n}, {N}, {C}]: max|d|/max|plain| = {err:.3e} "
              f"(tokens {rel_err(got_t, want_t):.3e}, keys {rel_err(got_k, want_k):.3e}); "
              f"kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, "
              f"bound {b[0]:.4f} ms ({b[1]})")
        if not err <= DECODE_REL:
            fail(f"two_way_layer kernel ({label}) disagrees with its plain version: {err}")
        k1[label] = entry(abs_err((got_t, want_t), (got_k, want_k)), kt, pt, b, max_rel_err=err,
                          device_split_ms=k1_by_launch(label, args, kw))
    # the served layer 0 is the row of the table; layer 1 rides along
    out["two_way_layer"] = dict(k1["layer 0, int8 store-indexed"],
                                layer1=k1["layer 1, bf16"])

    fa = dec.transformer.final_attn_t2i
    q_tok = rnd(n, T, I).to(bf16)
    args = (keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe, q_tok, 8)
    got, want = t2i_flash_kv(*args), t2i_flash_kv_plain(*args)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    kt, pt = cuda_ms(lambda: t2i_flash_kv(*args)), cuda_ms(lambda: t2i_flash_kv_plain(*args))
    dev_t = device_times(lambda: t2i_flash_kv(*args))
    b = bound(nbytes(keys, kpe, q_tok, got) + 2 * I * C * 2,
              n * (2 * N * C * 2 * I + 4 * N * T * I))
    print(f"  K2 t2i_flash_kv [{n}, {N}, {C}]: max|d|/max|plain| = {err:.3e}; kernel "
          f"{kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], device (graph replays) "
          f"{dev_t['device_ms']:.4f} ms, plain {pt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
    if not err <= DECODE_REL:
        fail(f"t2i_flash_kv kernel disagrees with its plain version: {err}")
    out["t2i_flash_kv"] = entry(abs_err((got, want)), kt, pt, b, max_rel_err=err, **dev_t)

    up = dec.output_upscaling
    src = keys.reshape(n, GRID, GRID, C)
    hyper = rnd(n, 1, 32).to(bf16)
    args = (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b,
            hyper)
    got, want = decoder_tail(*args), decoder_tail_plain(*args)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    kt, pt = cuda_ms(lambda: decoder_tail(*args)), cuda_ms(lambda: decoder_tail_plain(*args))
    dev_t = device_times(lambda: decoder_tail(*args))
    b, term = k3_bound(src, hyper, got, bf16)
    print(f"  K3 decoder_tail [{n}, {GRID}, {GRID}, {C}] -> {tuple(got.shape)}: max|d|/max|plain| "
          f"= {err:.3e}; kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], device (graph "
          f"replays) {dev_t['device_ms']:.4f} ms, plain {pt[0]:.4f} ms, bound {b[0]:.4f} ms "
          f"({b[1]}: {term})")
    if not err <= DECODE_REL:
        fail(f"decoder_tail kernel disagrees with its plain version: {err}")
    out["decoder_tail"] = entry(abs_err((got, want)), kt, pt, b, max_rel_err=err, bound_term=term,
                                **dev_t)
    del store
    torch.cuda.empty_cache()
    return out


def kernel_wrappers():
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
    from cor_tpu_torch.ops.kernels.layernorm import add_layer_norm, layer_norm
    from cor_tpu_torch.ops.kernels.seq_attention import attention_seq, attention_seq_qkv
    from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash, t2i_flash_kv
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_bwd,
        vit_attention_relpos_windows,
    )

    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer_dma
    from cor_tpu_torch.ops.kernels.two_way_stack import two_way_grid_fused, two_way_stack_fused
    from cor_tpu_torch.ops.kernels.upscale import fused_upscale2_hyper

    return {"layer_norm": layer_norm, "add_layer_norm": add_layer_norm,
            "fused_upscale2_hyper": fused_upscale2_hyper,
            "attention_seq_qkv": attention_seq_qkv,
            "attention_seq": attention_seq,
            "two_way_layer": two_way_layer, "t2i_flash_kv": t2i_flash_kv,
            "decoder_tail": decoder_tail, "vit_attention_relpos": vit_attention_relpos,
            "vit_attention_relpos_bwd": vit_attention_relpos_bwd,
            "vit_attention_relpos_windows": vit_attention_relpos_windows,
            "proj_q_t2i_flash": proj_q_t2i_flash, "i2t_attention_fused": i2t_attention_fused,
            "two_way_layer_dma": two_way_layer_dma, "two_way_stack_fused": two_way_stack_fused,
            "two_way_grid_fused": two_way_grid_fused}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = fn.launches_fp32 = 0


def read_counts():
    """Every wrapper's launches since ``reset_counts``: bf16 under its name,
    fp32 under name@fp32."""
    out = {}
    for name, fn in kernel_wrappers().items():
        out[name], out[f"{name}@fp32"] = fn.launches, fn.launches_fp32
    return out


def save_synthetic_gallery(d) -> np.ndarray:
    """A COR127K-sized index of seeded unit rows in ``d``; its pair ids."""
    from cor_tpu_torch.retrieval.index import save_gallery_index

    rng = np.random.default_rng(SEED)
    gallery = rng.standard_normal((GALLERY_ROWS, DIM), dtype=np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    pair_ids = np.arange(GALLERY_ROWS, dtype=np.int64)
    save_gallery_index(d, gallery, pair_ids)
    return pair_ids


def config_args(cfg_path) -> list:
    return [] if cfg_path is None else ["--config", str(cfg_path)]


def phase_serve(index_dir, pair_ids, cfg_path=None, towers=BASE_TOWERS, phase=4, sfx=""):
    """``cli.serve.main`` --self-test 8 over the index, fp32 and --int8
    scans; every response and the launch counts (``towers``: K4, K5 per
    encoded batch; ``sfx`` "@fp32": the fp32 kernels') checked."""
    from cor_tpu_torch.cli import serve as cli

    ids = set(pair_ids.tolist())
    servers, counts = {}, {}
    for mode, extra in (("fp32", []), ("int8", ["--int8"])):
        argv = [*config_args(cfg_path), "--gallery-index", str(index_dir), "--k", "10",
                "--max-batch", "4", "--self-test", "8", *extra]
        out = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            server = cli.main(argv)
        dt = time.perf_counter() - t0
        c = read_counts()
        resps = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
        if [r.get("id") for r in resps] != list(range(8)):
            fail(f"{mode}: expected responses for ids 0..7, got {out.getvalue()[:500]}")
        for r in resps:
            res = r.get("results")
            if res is None or len(res) != 10:
                fail(f"{mode}: response {r.get('id')} is not 10 results: {r}")
            s = np.array([x["score"] for x in res], np.float64)
            if not (np.isfinite(s).all() and (np.abs(s) <= 1.0 + 1e-6).all()
                    and (np.diff(s) <= 0).all()):
                fail(f"{mode}: response {r['id']} scores not finite, in [-1, 1], non-increasing: {s}")
            if not all(x["pair_id"] in ids for x in res):
                fail(f"{mode}: response {r['id']} names a pair_id outside the index")
        n = server.batches_encoded
        want = {k: 0 for k in c}
        want.update({"attention_seq_qkv" + sfx: towers[0] * n,
                     "layer_norm" + sfx: towers[1] * n})
        print(f"  serve {mode}: {len(resps)} responses, {n} encoded batches (warmup included), "
              f"launches {c} (expected {want}), main() took {dt:.1f} s")
        if c != want or min(c["layer_norm" + sfx], c["attention_seq_qkv" + sfx]) == 0:
            fail(f"{mode}: kernel launch counts {c} != expected {want}")
        servers[mode], counts[mode] = server, c
        print(f"  first response ({mode}): {json.dumps(resps[0])[:300]}")
    print(f"phase {phase} serve: ok", flush=True)
    return servers, counts["fp32"]


def phase_numerics(server, ecfg=None, phase=5, cos_min=COS_MIN):
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import init_support_branch
    from cor_tpu_torch.retrieval.index import make_query_encoder

    ecfg = ecfg or EvalConfig()
    assembled = [server._synthetic_query(i) for i in range(4)]
    imgs, masks, texts = server._batch_tensors(assembled)
    q_gpu = server.encode_query(server.model, imgs, texts, masks).cpu()
    cfg = dataclasses.replace(ecfg.core_config(), compute_dtype="float32")
    t0 = time.perf_counter()
    model_cpu = drawn(init_support_branch)(cfg, ecfg.seed)  # the weights main() served
    print(f"  support branch random init on the CPU: {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in model_cpu.parameters()) / 1e6:.1f} M parameters)")
    t0 = time.perf_counter()
    q_cpu = make_query_encoder(cfg)(model_cpu, imgs.cpu(), texts.cpu(), masks.cpu())
    dt = time.perf_counter() - t0
    cos = torch.nn.functional.cosine_similarity(q_gpu, q_cpu, dim=1)
    print(f"  GPU {server.cfg.compute_dtype} vs CPU fp32 query cosine per query: "
          f"{[round(v, 6) for v in cos.tolist()]} (CPU encode {dt:.1f} s)")
    if not torch.isfinite(q_gpu).all() or q_gpu.shape != (4, DIM):
        fail(f"GPU queries malformed: shape {tuple(q_gpu.shape)}")
    if cos.min().item() < cos_min:
        fail(f"GPU {server.cfg.compute_dtype} and CPU fp32 queries disagree: min cosine "
             f"{cos.min().item()} < {cos_min}")
    print(f"phase {phase} numerics: ok, min cosine {cos.min().item():.6f}", flush=True)
    return cos.min().item()


def phase_timings(server, smi, key="timings", phase=6):
    assembled = [server._synthetic_query(i) for i in range(16)]
    torch.cuda.reset_peak_memory_stats()
    latency = {}
    for b in (1, 4, 16):
        tensors = server._batch_tensors(assembled[:b])
        med, lo, hi = cuda_ms(lambda: server.encode_and_scan(*tensors), windows=7, iters=3)
        latency[str(b)] = {"ms": med, "min_ms": lo, "max_ms": hi}
    # the --self-test loop of cli.serve (8 requests, --max-batch 4), synthetic
    # inputs already memoised by the server
    reqs = [[{"id": i, "synthetic": i} for i in range(s, s + 4)] for s in (0, 4)]
    for batch in reqs:
        server.handle_batch(batch)
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in reqs:
            server.handle_batch(batch)
        walls.append(time.perf_counter() - t0)
    rps = [8 / w for w in walls]
    out = {
        key: {
            "encode_scan_ms_by_bucket": latency,
            "self_test_responses_per_s": {"median": statistics.median(rps),
                                          "min": min(rps), "max": max(rps)},
            "gallery_rows": GALLERY_ROWS, "k": 10, "scan": "fp32",
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "card": smi,
        }
    }
    print(json.dumps(out))
    before = BEFORE_REDESIGN[key]
    print("  encode+scan ms, this run against 820e02d's (before the K4 redesign): " + "; ".join(
        f"bucket {b} {latency[b]['ms']:.3f} [{latency[b]['min_ms']:.3f}, "
        f"{latency[b]['max_ms']:.3f}] vs {before[b][0]:.3f} [{before[b][1]:.3f}, "
        f"{before[b][2]:.3f}]" for b in before))
    print(f"phase {phase} timings: ok", flush=True)


def write_store_index(d: Path):
    """A synthetic 2,048-row gallery index with a [2048, 64, 64, 256] fp16
    store, written through a memory map in chunks so host memory stays
    bounded; the artifact format of save_gallery_index."""
    from cor_tpu_torch.retrieval.index import save_gallery_index

    rng = np.random.default_rng(SEED + 1)
    emb = rng.standard_normal((STORE_ROWS, DIM), dtype=np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    pair_ids = 1_000_000 + np.arange(STORE_ROWS, dtype=np.int64)
    save_gallery_index(d, emb, pair_ids)
    shape = (STORE_ROWS, GRID, GRID, SAM_C)
    store = np.lib.format.open_memmap(d / "store.npy", mode="w+", dtype=np.float16, shape=shape)
    # drawn on the card (numpy's generator took ~40 s of the 4 GiB)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for s in range(0, STORE_ROWS, 128):
        store[s:s + 128] = (0.5 * torch.randn((128, *shape[1:]), generator=gen, device="cuda")
                            ).half().cpu().numpy()
    store.flush()
    del store
    meta = json.loads((d / "meta.json").read_text())
    meta.update(has_store=True, store_shape=list(shape))
    (d / "meta.json").write_text(json.dumps(meta))
    return pair_ids


def read_png_gray(path: Path) -> np.ndarray:
    """Decode an 8-bit grayscale PNG whose scanlines use filter type 0 (the
    port's writer) with the standard library."""
    data = path.read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{path} is not a PNG")
    pos, idat = 8, b""
    w = h = None
    while pos < len(data):
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        if zlib.crc32(body, zlib.crc32(kind)) != int.from_bytes(
                data[pos + 8 + length:pos + 12 + length], "big"):
            fail(f"{path}: bad CRC in chunk {kind}")
        if kind == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(body[4:8], "big")
            if body[8:10] != b"\x08\x00":
                fail(f"{path}: not 8-bit grayscale")
        elif kind == b"IDAT":
            idat += body
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, w + 1)
    if rows[:, 0].any():
        fail(f"{path}: scanline filters other than 0")
    return rows[:, 1:]


def serve_masks(index_dir: Path, ids: set, out_dir: Path, mode: str, extra: list,
                cfg_path=None, towers=BASE_TOWERS, sfx=""):
    """``cli.serve.main`` --decode-masks with --self-test 8, --max-batch 4,
    --k 10 (and ``extra``) on the index: every response and PNG checked, the
    kernels' launches per decoded batch checked (``towers``: K4, K5 per
    encoded batch; ``sfx`` "@fp32": the fp32 kernels' counts). Returns
    (server, launches, {png name: mask})."""
    from cor_tpu_torch.cli import serve as cli
    from cor_tpu_torch.ops.kernels import t2i_flash, two_way_layer

    argv = [*config_args(cfg_path), "--gallery-index", str(index_dir), "--k", "10",
            "--max-batch", "4", "--self-test", "8", "--decode-masks", str(out_dir), *extra]
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        server = cli.main(argv)
    dt = time.perf_counter() - t0
    c = read_counts()
    resps = [json.loads(line) for line in out.getvalue().splitlines() if line.strip()]
    if [r.get("id") for r in resps] != list(range(8)):
        fail(f"decode {mode}: expected responses for ids 0..7, got {out.getvalue()[:500]}")
    masks = {}
    for r in resps:
        res, paths = r.get("results"), r.get("masks")
        if res is None or len(res) != 10 or paths is None or len(paths) != 10:
            fail(f"decode {mode}: response {r.get('id')} is not 10 results and 10 masks: {r}")
        s = np.array([x["score"] for x in res], np.float64)
        if not (np.isfinite(s).all() and (np.diff(s) <= 0).all()):
            fail(f"decode {mode}: response {r['id']} scores not finite and sorted: {s}")
        for x, path in zip(res, paths):
            if x["pair_id"] not in ids or Path(path).name != f"{r['id']}_{x['pair_id']}.png":
                fail(f"decode {mode}: mask {path} does not name pair {x['pair_id']}")
            m = read_png_gray(Path(path))
            if m.shape != (4 * GRID, 4 * GRID) or not np.isin(m, (0, 255)).all():
                fail(f"decode {mode}: {path} is {m.shape}, values {np.unique(m)[:5]}")
            masks[Path(path).name] = m
    d, e = server.decode_calls, server.batches_encoded
    want = {k: 0 for k in c}
    want.update({"layer_norm" + sfx: towers[1] * e, "attention_seq_qkv" + sfx: towers[0] * e,
                 "two_way_layer" + sfx: two_way_layer.LAUNCHES * 2 * d,
                 "t2i_flash_kv" + sfx: t2i_flash.FINAL_LAUNCHES * d,
                 "decoder_tail" + sfx: d})
    fg = np.mean([m.mean() / 255 for m in masks.values()])
    print(f"  decode serve {mode}: {len(resps)} responses, {e} encoded batches, {d} decode "
          f"calls (warmup included), launches {c} (expected {want}), foreground share "
          f"{fg:.4f}, main() took {dt:.1f} s")
    if c != want or min(e, d) == 0:
        fail(f"decode {mode}: kernel launch counts {c} != expected {want}")
    print(f"  first response ({mode}): {json.dumps(resps[0])[:300]}")
    return server, c, masks


def phase_decode_serve(index_dir: Path, pair_ids: np.ndarray, out_root: Path):
    ids = set(pair_ids.tolist())
    servers, counts, masks = {}, {}, {}
    for mode, extra in (("host", []), ("hbm", ["--store-hbm"])):
        servers[mode], counts[mode], masks[mode] = serve_masks(
            index_dir, ids, out_root / mode, mode, extra)
    if masks["host"].keys() != masks["hbm"].keys():
        fail("the two decode configurations retrieved different candidates")
    agree = np.mean([(masks["host"][k] == masks["hbm"][k]).mean() for k in masks["host"]])
    print(f"  host-streamed fp16 vs int8 store masks: {agree:.6f} of pixels agree "
          f"over {len(masks['host'])} masks")
    if agree < MASK_AGREE_MIN:
        fail(f"host-streamed and --store-hbm masks agree on only {agree:.4f} of pixels")
    print("phase 7 decode serve: ok", flush=True)
    return servers, counts["hbm"], agree


@torch.no_grad()
def phase_decode_numerics(server, index_dir: Path, rows=(3, 100, 1000, 2047), phase=8,
                          cos_min=COS_MIN):
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import init_decode_model
    from cor_tpu_torch.retrieval.index import load_gallery_index, make_candidate_mask_decoder

    assembled = [server._synthetic_query(i) for i in range(4)]
    imgs, masks, texts = server._batch_tensors(assembled)
    feats = server.encode_query(server.model, imgs, texts, masks)
    rows = np.asarray(load_gallery_index(index_dir)["store"][list(rows)])
    gpu = make_candidate_mask_decoder(server.cfg)(
        server.decode_model, torch.from_numpy(rows).cuda(), feats).cpu()
    cfg = dataclasses.replace(EvalConfig().core_config(), compute_dtype="float32")
    model_cpu = init_decode_model(cfg, EvalConfig().seed)  # the weights main() served
    t0 = time.perf_counter()
    cpu = make_candidate_mask_decoder(cfg)(model_cpu, torch.from_numpy(rows), feats.cpu())
    dt = time.perf_counter() - t0
    cos = torch.nn.functional.cosine_similarity(gpu.flatten(1), cpu.flatten(1), dim=1)
    agree = ((gpu > 0) == (cpu > 0)).float().mean().item()
    print(f"  GPU {server.cfg.compute_dtype} vs CPU fp32 decode, per-candidate logit cosine: "
          f"{[round(v, 6) for v in cos.tolist()]}; mask pixels agreeing {agree:.6f} "
          f"(CPU decode {dt:.1f} s)")
    if gpu.shape != (4, 1, 4 * GRID, 4 * GRID) or not torch.isfinite(gpu).all():
        fail(f"GPU decode malformed: shape {tuple(gpu.shape)}")
    if cos.min().item() < cos_min:
        fail(f"GPU {server.cfg.compute_dtype} and CPU fp32 decodes disagree: min cosine "
             f"{cos.min().item()} < {cos_min}")
    print(f"phase {phase} decode numerics: ok, min cosine {cos.min().item():.6f}", flush=True)
    return cos.min().item()


def self_test_rps(server, save_masks: bool = True):
    """Responses/s of the --self-test loop (8 requests, --max-batch 4, the
    synthetic inputs already memoised): median, min and max of 7 runs."""
    reqs = [[{"id": i, "synthetic": i} for i in range(s, s + 4)] for s in (0, 4)]
    for batch in reqs:
        server.handle_batch(batch, save_masks=save_masks)
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in reqs:
            server.handle_batch(batch, save_masks=save_masks)
        walls.append(time.perf_counter() - t0)
    rps = [8 / w for w in walls]
    return {"median": statistics.median(rps), "min": min(rps), "max": max(rps)}


def phase_decode_timings(servers, smi):
    server = servers["hbm"]
    assembled = [server._synthetic_query(i) for i in range(4)]
    latency = {}
    for b in (1, 4):
        tensors = server._batch_tensors(assembled[:b])
        med, lo, hi = cuda_ms(lambda: server.encode_scan_decode(*tensors, b), windows=7, iters=3)
        latency[str(b)] = {"ms": med, "min_ms": lo, "max_ms": hi}
    print(json.dumps({"decode_timings": {
        "encode_scan_decode_ms_by_bucket": latency,
        "self_test_responses_per_s": self_test_rps(server),
        # the same loop writing no PNG, and the host-streamed configuration
        "self_test_responses_per_s_no_png": self_test_rps(server, save_masks=False),
        "self_test_responses_per_s_host_streamed": self_test_rps(servers["host"]),
        "store_rows": STORE_ROWS, "k": 10, "store": "int8 on the card", "card": smi,
    }}))
    profile_decode(server, tensors, 4, smi)
    print("phase 9 decode timings: ok", flush=True)


# device kernels by the layer they belong to (substrings of their names; the
# first group that matches takes the kernel). K6b, K7 and K6 come first: the
# rel-pos kernels' template arguments (D, kWin, ...) would match the two-way
# layers' patterns.
KERNEL_GROUPS = (
    ("K6b vit_attention_relpos_bwd", ("vit_attention_bwd",)),
    ("K7 vit_attention_relpos_windows", ("relpos_kernel<64, true", "relpos_kernel<80, true",
                                         "f32_kernel<64, true", "f32_kernel<80, true")),
    ("K6 vit_attention_relpos", ("vit_attention_relpos",)),
    ("K1-stack / K1-grid two_way_fused", ("two_way_fused",)),
    ("K1-dma image passes", ("dma_t2i", "dma_i2t")),
    # K1's four launches and K8b (twl_i2t) on K1's route, K8a and K8b on the
    # K8 route (the route decides)
    ("two-way layers: K1, or K8a + K8b", ("twl_", "t2i_proj_q")),
    ("K2 t2i_flash_kv", ("t2i_final",)),
    ("K3 decoder_tail", ("decoder_tail_kernel",)),
    ("K4 attention_seq_qkv", ("seq_attention",)),
    ("K5 layer_norm", ("layer_norm_kernel",)),
    ("cuDNN convs", ("fprop", "conv", "cudnn", "nchwToNhwc", "nhwcToNchw")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("reductions, top-k, sort", ("reduce", "topk", "sort", "radix", "gather", "scatter")),
)


def profile(fn, calls: int):
    """torch.profiler over ``calls`` calls of ``fn`` (after one unprofiled
    call): device time per call by layer, the top kernels, and the device's
    idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / calls
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels.append((e.key, e.count / calls, us / 1e3 / calls))
    groups = {}
    for key, n, ms in kernels:
        name = next((g for g, subs in KERNEL_GROUPS if any(s in key for s in subs)), "other")
        c, t = groups.get(name, (0.0, 0.0))
        groups[name] = (c + n, t + ms)
    device_ms = sum(ms for _, _, ms in kernels)
    top = sorted(kernels, key=lambda k: -k[2])[:12]
    return {
        "calls": calls, "wall_ms_per_call": wall_ms,
        "device_ms_per_call": device_ms, "device_idle_share": 1 - device_ms / wall_ms,
        "kernels_per_call": sum(n for _, n, _ in kernels),
        "by_layer": {g: {"launches": c, "ms": t} for g, (c, t) in
                     sorted(groups.items(), key=lambda kv: -kv[1][1])},
        "top_kernels": [{"name": k[:90], "launches": n, "ms": t} for k, n, t in top],
    }


def profile_decode(server, tensors, b: int, smi: str, calls: int = 3):
    """The profile of ``calls`` encode+scan+decode calls at bucket b
    (--store-hbm)."""
    prof = profile(lambda: server.encode_scan_decode(*tensors, b), calls)
    print(json.dumps({"decode_profile": {"bucket": b, **prof, "card": smi}}))


@torch.no_grad()
def phase_encoder_kernels(device):
    """K6 at the global and windowed shapes, K5 at the encoder's shapes."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 3)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    bf16 = torch.bfloat16
    k6 = {}
    for label, B, side in (("global", 2, GRID), ("windowed", 50, 14)):
        N = side * side
        qkv = rnd(B, N, 3 * 768).to(bf16)
        rel_h, rel_w = (0.3 * rnd(B, 12, N, side)).to(bf16), (0.3 * rnd(B, 12, N, side)).to(bf16)
        args = (qkv, rel_h, rel_w, 12, (side, side))
        got, want = vit_attention_relpos(*args), vit_attention_relpos_plain(*args)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        kt = cuda_ms(lambda: vit_attention_relpos(*args))
        pt = cuda_ms(lambda: vit_attention_relpos_plain(*args), iters=3)
        # the library call: SDPA with the additive [B, heads, N, N] bias built
        # beforehand (the build is not timed)
        q, k, v = (qkv[..., i * 768:(i + 1) * 768].unflatten(-1, (12, 64)).transpose(1, 2)
                   for i in range(3))
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, 12, N, N)
        lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        b = bound(nbytes(qkv, rel_h, rel_w, got), 4 * B * 12 * N * N * 64)
        print(f"  K6 vit_attention_relpos {label} [{B}, {N}, 2304]: max|d|/max|plain| = "
              f"{err:.3e}; kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, "
              f"SDPA with the bias {lt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        if not err <= DECODE_REL:
            fail(f"vit_attention_relpos kernel ({label}) disagrees with its plain version: {err}")
        k6[label] = entry(abs_err((got, want)), kt, pt, b, lt, max_rel_err=err)
        del bias, q, k, v
    torch.cuda.empty_cache()

    ln = {}
    for C in (768, SAM_C):
        x = (2 * rnd(SAM_BATCH * GRID * GRID, C) + 0.5).to(bf16)
        scale, bias = (1 + 0.1 * rnd(C)).to(bf16), (0.1 * rnd(C)).to(bf16)
        got, want = layer_norm(x, scale, bias), layer_norm_plain(x, scale, bias)
        torch.cuda.synchronize()
        err = abs_err((got, want))
        kt = cuda_ms(lambda: layer_norm(x, scale, bias))
        pt = cuda_ms(lambda: layer_norm_plain(x, scale, bias))
        lt = cuda_ms(lambda: F.layer_norm(x, (C,), scale, bias, 1e-6))
        b = bound(2 * nbytes(x) + nbytes(scale, bias), 8 * x.numel())
        print(f"  K5 layer_norm [{x.shape[0]}, {C}] bf16: max|d|={err:.3e} kernel {kt[0]:.4f} ms, "
              f"plain {pt[0]:.4f} ms, F.layer_norm {lt[0]:.4f} ms, bound {b[0]:.4f} ms")
        if err > KERNEL_TOL:
            fail(f"layer_norm kernel disagrees with its plain version at C={C}: {err}")
        ln[f"[{x.shape[0]},{C}]"] = entry(err, kt, pt, b, lt)
    print("phase 10 encoder kernels: ok", flush=True)
    return dict(k6["global"], windowed=k6["windowed"]), ln


def build_index(index_dir: Path, rows: int, cfg_path=None, per_batch=(12, 26), sfx=""):
    """``cli.index.main`` --synthetic rows --batch-size 8 --with-store,
    checked: the JSON line, unit-norm rows, the finite fp16 store, and K6 /
    K5 launches of exactly ``per_batch`` per encoded batch (``sfx`` "@fp32":
    the fp32 kernels'). Returns (launch counts, seconds, the loaded index)."""
    from cor_tpu_torch.cli import index as cli
    from cor_tpu_torch.retrieval.index import load_gallery_index

    argv = [*config_args(cfg_path), "--out", str(index_dir), "--synthetic", str(rows),
            "--batch-size", str(SAM_BATCH), "--with-store"]
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    dt = time.perf_counter() - t0
    c = read_counts()
    batches = -(-rows // SAM_BATCH)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want_line = {"rows": rows, "dim": SAM_C, "with_store": True, "out": str(index_dir)}
    if line != want_line:
        fail(f"index: the JSON line {line} != {want_line}")
    idx = load_gallery_index(index_dir)
    emb, store = idx["embeddings"], np.asarray(idx["store"])
    norms = np.linalg.norm(emb, axis=1)
    print(f"  index build: {json.dumps(line)} in {dt:.1f} s (model init included); row norms "
          f"[{norms.min():.6f}, {norms.max():.6f}], store {store.shape} {store.dtype}, |store| "
          f"max {np.abs(store.astype(np.float32)).max():.3f}")
    if emb.shape != (rows, SAM_C) or not np.allclose(norms, 1.0, atol=1e-3):
        fail(f"index: embeddings {emb.shape} are not {rows} unit rows")
    if store.shape != (rows, GRID, GRID, SAM_C) or store.dtype != np.float16 or not (
            np.isfinite(store).all()):
        fail(f"index: the store is {store.shape} {store.dtype}, or not finite")
    want = {k: 0 for k in c}
    want.update({"vit_attention_relpos" + sfx: per_batch[0] * batches,
                 "layer_norm" + sfx: per_batch[1] * batches})
    print(f"  index build launches {c} over {batches} encoded batches (expected {want})")
    if c != want:
        fail(f"index: kernel launch counts {c} != expected {want}")
    return c, dt, idx


def phase_build_index(index_dir: Path):
    """cli.index.main at full SAM-base width, checked; then --decode-masks
    --store-hbm serving from the index it wrote."""
    c, dt, idx = build_index(index_dir, BUILD_ROWS)
    _, dec_counts, _ = serve_masks(index_dir, set(idx["pair_ids"].tolist()),
                                   index_dir.parent / "built_masks", "hbm, built index",
                                   ["--store-hbm"])
    print("phase 11 gallery build: ok", flush=True)
    return c, dt


def filled_encoder(cfg, draw: bool = False):
    """The CLI's image encoder (seed + 2) with its rel-pos tables and
    pos_embed filled with seeded normals x 0.3 (zeros at init); ``draw``
    draws the weights even where the inits are memoised (to time it)."""
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import init_image_encoder

    init = drawn(init_image_encoder) if draw else init_image_encoder
    enc = init(cfg, EvalConfig().seed + 2)
    gen = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        for name, prm in enc.named_parameters():
            if "rel_pos" in name or name == "pos_embed":
                prm.copy_(0.3 * torch.randn(prm.shape, generator=gen))
    return enc


def synthetic_batch(n: int, cfg=None):
    """n synthetic samples of the served config, or of ``cfg`` (the build's
    data)."""
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.data.pipeline import collate
    from cor_tpu_torch.data.synthetic import SyntheticDataset

    cfg = cfg or EvalConfig().core_config()
    sig = cfg.support.siglip
    ds = SyntheticDataset(length=n, query_img_size=cfg.encoder.img_size,
                          support_img_size=sig.vision.image_size,
                          context_length=sig.text.context_length,
                          vocab_size=sig.text.vocab_size, seed=SEED)
    return collate([ds[i] for i in range(n)])


def phase_encoder_numerics(ecfg=None, phase=12, cos_min=COS_MIN):
    """One candidate through the encoder (tables and pos_embed filled) on
    the card in bf16 and on the CPU in fp32; one ``core_forward`` at full
    width, batch 2, with that encoder. Returns (the encoder on the card,
    cosines)."""
    import copy

    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import (
        CoreModel,
        _cast,
        core_forward,
        init_mask_decoder,
        init_prompt_encoder,
        init_support_branch,
    )
    from cor_tpu_torch.retrieval.index import make_candidate_encoder

    cfg = (ecfg or EvalConfig()).core_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t0 = time.perf_counter()
    enc = filled_encoder(cfg, draw=True).eval()
    print(f"  image encoder random init on the CPU: {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in enc.parameters()) / 1e6:.1f} M parameters)")
    b = synthetic_batch(2, cfg)
    img, mask = torch.from_numpy(b["query_img"][:1]), torch.from_numpy(b["query_mask"][:1])
    enc_gpu = _cast(copy.deepcopy(enc).cuda(), cfg.dtype)
    pooled_g, emb_g = make_candidate_encoder(cfg)(enc_gpu, img.cuda(), mask.cuda())
    t0 = time.perf_counter()
    pooled_c, emb_c = make_candidate_encoder(cfg32)(enc, img, mask)
    dt = time.perf_counter() - t0
    cos_flat = torch.nn.functional.cosine_similarity(
        emb_g.cpu().flatten()[None], emb_c.flatten()[None]).item()
    cos_pool = torch.nn.functional.cosine_similarity(pooled_g.cpu(), pooled_c).item()
    print(f"  encoder GPU {cfg.compute_dtype} vs CPU fp32: cosine {cos_flat:.6f} flattened, "
          f"{cos_pool:.6f} pooled (CPU encode {dt:.1f} s)")
    if emb_g.shape != (1, GRID, GRID, SAM_C) or not torch.isfinite(emb_g).all():
        fail(f"GPU encoder output malformed: {tuple(emb_g.shape)}")
    if min(cos_flat, cos_pool) < cos_min:
        fail(f"GPU {cfg.compute_dtype} and CPU fp32 encoders disagree: cosines {cos_flat}, "
             f"{cos_pool} < {cos_min}")

    # core_forward at full width, batch 2, the filled encoder in place of
    # init_core_model's (its other parts from the seeds it uses)
    model = CoreModel(enc, init_support_branch(cfg, SEED), init_prompt_encoder(cfg, SEED),
                      init_mask_decoder(cfg, SEED + 1))
    model = _cast(model.cuda(), cfg.dtype).eval()
    t = {k: torch.from_numpy(v).cuda() for k, v in b.items() if k != "pair_id"}
    final, q_emb, feat = core_forward(model, t["query_img"], t["support_img"], t["text"],
                                      t["support_mask"], cfg)
    _, emb_direct = make_candidate_encoder(cfg)(model.image_encoder, t["query_img"],
                                                t["query_mask"])
    torch.cuda.synchronize()
    shapes = [tuple(x.shape) for x in (final, q_emb, feat)]
    d = rel_err(q_emb, emb_direct)
    print(f"  core_forward batch 2: shapes {shapes}, finite "
          f"{all(torch.isfinite(x).all().item() for x in (final, q_emb, feat))}, foreground "
          f"share {(final > 0).float().mean().item():.4f}; query embeddings vs the encoder's: "
          f"max|d|/max = {d:.3e}")
    if shapes != [(2, 1, 4 * GRID, 4 * GRID), (2, GRID, GRID, SAM_C), (2, 1, DIM)] or not all(
            torch.isfinite(x).all() for x in (final, q_emb, feat)):
        fail(f"core_forward malformed: {shapes}")
    if d > 1e-3:
        fail(f"core_forward's query embeddings differ from the encoder's: {d}")
    print(f"phase {phase} encoder numerics: ok", flush=True)
    return enc_gpu, cos_flat, cos_pool


def phase_build_timings(enc_gpu, smi: str):
    from cor_tpu_torch.cli import index as cli
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.data.pipeline import DataLoader
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.ops.attention import window_partition, window_unpartition
    from cor_tpu_torch.ops.common import gelu
    from cor_tpu_torch.retrieval.index import build_gallery, make_candidate_encoder

    cfg = EvalConfig().core_config()
    encode = make_candidate_encoder(cfg)
    b = synthetic_batch(SAM_BATCH)
    imgs, masks = (torch.from_numpy(b[k]).cuda() for k in ("query_img", "query_mask"))
    encode_ms = {}
    for n in (1, SAM_BATCH):
        med, lo, hi = cuda_ms(lambda: encode(enc_gpu, imgs[:n], masks[:n]), windows=7, iters=2)
        encode_ms[str(n)] = {"ms": med, "min_ms": lo, "max_ms": hi,
                             "candidates_per_s": n / med * 1e3}
    # the host's synthetic data alone (the loader of the CLI, 8 threads)
    n_rows = 2 * BUILD_ROWS
    sig = cfg.support.siglip
    ds = SyntheticDataset(length=n_rows, query_img_size=cfg.encoder.img_size,
                          support_img_size=sig.vision.image_size,
                          context_length=sig.text.context_length,
                          vocab_size=sig.text.vocab_size, seed=SEED)
    t0 = time.perf_counter()
    for _ in DataLoader(ds, SAM_BATCH, num_workers=EvalConfig().num_workers):
        pass
    data_s = time.perf_counter() - t0
    # the build loop (data, encode, fetch) on the encoder already built, with
    # the CLI's 8 loader threads and with 4
    loop_s, cli_workers = {}, EvalConfig().num_workers
    for workers in (cli_workers, 4):
        t0 = time.perf_counter()
        build_gallery(cfg, enc_gpu, DataLoader(ds, SAM_BATCH, num_workers=workers))
        loop_s[workers] = time.perf_counter() - t0
    # the encode of a batch of 8 while the loader makes data beside it
    stop = threading.Event()

    def churn():
        while not stop.is_set():
            for _ in DataLoader(ds, SAM_BATCH, num_workers=cli_workers):
                if stop.is_set():
                    break

    churner = threading.Thread(target=churn, daemon=True)
    churner.start()
    time.sleep(1.0)
    contended = cuda_ms(lambda: encode(enc_gpu, imgs, masks), windows=5, iters=2)
    stop.set()
    churner.join(timeout=120)
    if churner.is_alive():
        fail("the loader run beside the encode did not stop")
    encode_ms["8, beside the loader"] = {"ms": contended[0], "min_ms": contended[1],
                                         "max_ms": contended[2]}
    # the CLI build without a store, model init and saving included
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()), \
            drawing_inits():
        t0 = time.perf_counter()
        cli.main(["--out", d, "--synthetic", str(n_rows), "--batch-size", str(SAM_BATCH)])
        cli_s = time.perf_counter() - t0
    rates = {"encode_batch8": encode_ms[str(SAM_BATCH)]["candidates_per_s"],
             "host_data": n_rows / data_s, "build_loop": n_rows / loop_s[cli_workers],
             "build_loop_4_loader_threads": n_rows / loop_s[4], "cli_build": n_rows / cli_s}
    # the encoder's elementwise layers timed alone at its shapes: the bf16
    # GELU of the 12 MLPs and the partition/unpartition of the 8 windowed blocks
    h = torch.randn(SAM_BATCH * GRID * GRID, 3072, device="cuda").to(torch.bfloat16)
    gelu_ms = cuda_ms(lambda: gelu(h), iters=3)[0]
    g = torch.randn(SAM_BATCH, GRID, GRID, 768, device="cuda").to(torch.bfloat16)

    def partition_roundtrip():
        w, pad_hw = window_partition(g, 14)
        return window_unpartition(w, 14, pad_hw, (GRID, GRID))

    part_ms = cuda_ms(partition_roundtrip)[0]
    del h, g
    prof = profile(lambda: encode(enc_gpu, imgs, masks), 1)
    print(json.dumps({"build_timings": {
        "encode_ms_by_batch": encode_ms,
        "candidates_per_s": rates,
        "rows_timed": n_rows,
        "cor127k_minutes_at": {k: GALLERY_ROWS / v / 60 for k, v in rates.items()},
        "gelu_ms_per_encode": 12 * gelu_ms, "partition_ms_per_encode": 8 * part_ms,
        "card": smi,
    }}))
    print(json.dumps({"encode_profile": {"batch": SAM_BATCH, **prof, "card": smi}}))
    print("phase 13 build timings: ok", flush=True)


def phase_k6b(device, heads: int = 12, D: int = 64, phase: int = 14):
    """K6b against its plain backward at the global and windowed shapes
    (``heads`` of ``D``: SAM-base's 12 of 64, sam_huge's 16 of 80), given
    the forward's out and lse as autograd saves them, timed beside the plain
    version and SDPA's autograd backward with the materialised bias
    requiring grad (given its saved forward likewise)."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos_bwd,
        vit_attention_relpos_bwd_plain,
        vit_attention_relpos_with_lse,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 5 if D == 64 else SEED + 8)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    bf16 = torch.bfloat16
    C = heads * D
    out = {}
    for label, B, side in (("global", 2, GRID), ("windowed", 50, 14)):
        N = side * side
        qkv = rnd(B, N, 3 * C).to(bf16)
        rel_h = (0.3 * rnd(B, heads, N, side)).to(bf16)
        rel_w = (0.3 * rnd(B, heads, N, side)).to(bf16)
        do = rnd(B, N, C).to(bf16)
        args = (qkv, rel_h, rel_w, do, heads, (side, side))
        out_fwd, lse = vit_attention_relpos_with_lse(*args[:3], heads, (side, side))
        stats = dict(out=out_fwd, lse=lse)
        got = vit_attention_relpos_bwd(*args, **stats)
        want = vit_attention_relpos_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        err_abs = abs_err(*zip(got, want))
        if not all(torch.isfinite(g.float()).all() for g in got) or max(errs) > DECODE_REL:
            fail(f"vit_attention_relpos_bwd ({label}) disagrees with its plain version: "
                 f"dqkv {errs[0]}, drel_h {errs[1]}, drel_w {errs[2]}")
        kt = cuda_ms(lambda: vit_attention_relpos_bwd(*args, **stats))
        pt = cuda_ms(lambda: vit_attention_relpos_bwd_plain(*args), windows=3, iters=2)
        del want
        # the library call: autograd's backward of SDPA with the additive
        # [B, heads, N, N] bias, both requiring grad (the graph built once)
        q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                   .detach().requires_grad_() for i in range(3))
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, heads, N, N)
        bias = bias.requires_grad_()
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        do4 = do.unflatten(-1, (heads, D)).transpose(1, 2)
        lt = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v, bias), do4, retain_graph=True),
                     windows=5, iters=3)
        del o, bias, q, k, v
        # the bound: the five N x N x D products the gradient needs (the
        # logits' recompute q k^T, do v^T, a^T do, dl k and dl^T q) on the
        # inputs (with the forward's out and lse) and outputs; the kernel runs
        # seven (S, dP and dQ in its dq pass; S^T, dP^T, dV and dK in its dk/dv
        # pass)
        flops = 5 * 2 * N * N * D * B * heads
        b = bound(nbytes(qkv, rel_h, rel_w, do, out_fwd, lse) + nbytes(*got), flops)
        print(f"  K6b vit_attention_relpos_bwd head_dim {D} {label} [{B}, {N}, {3 * C}]: "
              f"max|d|/max|plain| = "
              f"dqkv {errs[0]:.3e}, drel_h {errs[1]:.3e}, drel_w {errs[2]:.3e}; kernel "
              f"{kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}] (7 products), plain {pt[0]:.4f} ms, "
              f"SDPA backward with the bias {lt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}, the 5 "
              f"products the gradient needs)", flush=True)
        out[label] = entry(err_abs, kt, pt, b, lt, max_rel_err=max(errs))
        del got
        torch.cuda.empty_cache()
    print(f"phase {phase} K6b{'' if D == 64 else '@' + str(D)}: ok", flush=True)
    return dict(out["global"], windowed=out["windowed"])


def flat_config(name: str, path: Path, **overrides) -> Path:
    """configs/``name``'s keys, with ``overrides``, as the flat file
    ``path``."""
    from cor_tpu_torch.config import read_flat_yaml

    keys = read_flat_yaml((Path(__file__).resolve().parent / "configs" / name).read_text())
    keys.update(overrides)
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in keys.items()))
    return path


def m3_config(d: Path, **overrides) -> Path:
    """configs/train_config_m3.yaml's keys, with ``overrides``, as a file."""
    return flat_config("train_config_m3.yaml", d / "train.yaml", **overrides)


TOWERS = ("image_encoder.", "support_branch.siglip.", "mask_decoder.iou_prediction_head.",
          "prompt_encoder.pe_layer.")


def phase_train(root: Path, keys=None, blocks: int = 12, phase: int = 15,
                keep_unfrozen: bool = False, modes=(("frozen", True), ("unfrozen", False)),
                sfx: str = ""):
    """cli.train.main --synthetic at full width on m3's keys (with ``keys``:
    CFG's, or other overrides), in ``modes`` (frozen and unfrozen); the
    launch counts of each run (``blocks``: the encoder's, run once per
    microbatch of ``grad_accum``; ``sfx`` "@fp32": the fp32 kernels', and no
    bf16 launch). Returns (counts, results, the unfrozen Trainer if
    ``keep_unfrozen``)."""
    from cor_tpu_torch.cli import train as cli
    from cor_tpu_torch.config import load_train_config
    from cor_tpu_torch.models.core_model import init_core_model

    counts, results, kept, fresh = {}, {}, None, None
    for mode, freeze in modes:
        d = root / mode
        d.mkdir(parents=True)
        cfg_path = m3_config(d, epoch=1, train_model_save_path=str(d / "ck"),
                             freeze_towers=freeze, **(keys or {}))
        log = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(log):
            trainer = cli.main(["--config", str(cfg_path), "--synthetic"])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        c = read_counts()
        text = log.getvalue()
        losses = [float(x.split("]")[0]) for x in text.split("[BLoss: ")[1:]]
        val = [line for line in text.splitlines() if line.startswith("[Val Info]: Epoch: 1,")]
        print(f"  train {mode}: {trainer.state.step} steps, batch losses {losses}, main() took "
              f"{dt:.1f} s; launches {c}")
        print(f"  {val[0] if val else 'no val line'}")
        cfg = load_train_config(cfg_path)
        steps, val_batches = trainer.state.step, 2
        if steps != 4 or not losses or not all(np.isfinite(losses)) or len(val) != 1:
            fail(f"train {mode}: {steps} steps, losses {losses}, val lines {val}")
        for name in ("best_model", "best_model_full"):
            if not (d / "ck" / name / "state.pt").is_file():
                fail(f"train {mode}: {name} was not written")
        if fresh is None:  # the seeded init both runs started from
            fresh = init_core_model(cfg.core_config(), cfg.seed).state_dict()
        got = trainer.state.model.state_dict()
        same = {p: all(torch.equal(got[n].cpu(), fresh[n]) for n in fresh if n.startswith(p))
                for p in TOWERS}
        micro = cfg.grad_accum * steps  # encoder forwards of the train steps
        k6_want = (blocks if freeze else 2 * blocks) * micro + blocks * val_batches
        k6b_want = 0 if freeze else blocks * micro
        k6, k6b = c["vit_attention_relpos" + sfx], c["vit_attention_relpos_bwd" + sfx]
        print(f"  train {mode}: unchanged since init {same}; K6{sfx} {k6} (expected {k6_want}), "
              f"K6b{sfx} {k6b} (expected {k6b_want})")
        if freeze and not all(same.values()):
            fail(f"train frozen: a frozen part moved: {same}")
        if not freeze and (same[TOWERS[0]] or same[TOWERS[1]] or not same[TOWERS[3]]):
            fail(f"train unfrozen: a tower did not move, or the PE matrix did: {same}")
        idle = ("vit_attention_relpos_bwd", "attention_seq", "vit_attention_relpos_windows",
                "proj_q_t2i_flash", "i2t_attention_fused", "two_way_layer_dma",
                "two_way_stack_fused", "two_way_grid_fused", "add_layer_norm",
                "fused_upscale2_hyper")
        if k6 != k6_want or k6b != k6b_want or min(
                c[n + sfx] for n in kernel_wrappers() if n not in idle) == 0 or (
                sfx and any(c[n] for n in kernel_wrappers())):
            fail(f"train {mode}: kernel launch counts {c}")
        counts[mode], results[mode] = c, {"seconds": dt, "losses": losses, "val": val[0]}
        shutil.rmtree(d / "ck")  # the checkpoints (tens of GB at CFG)
        if keep_unfrozen and not freeze:
            kept = trainer
        del trainer, got
        torch.cuda.empty_cache()
    del fresh
    print(f"phase {phase} training: ok", flush=True)
    return counts, results, kept


def deterministic_config(cfg):
    """The config with no dropout draw (proj_dropout 0, "add" fusion)."""
    sup = dataclasses.replace(cfg.support, proj_dropout=0.0, fusion="add")
    return dataclasses.replace(cfg, support_override=sup, freeze_towers=False)


def decoder_bf16_cosines(dec, pe, multimask: bool, seeds=(0, 1, 2)) -> dict:
    """The decoder alone on the card: its training (``fused=False``) path in
    bf16 against fp32, on the same fp32 weights and random inputs and mask
    cotangent per seed; the cosine of each layer's self-attention q_proj
    gradient. It shows how much of phase 16's decoder cosine is the
    decoder's own bf16 rounding."""
    import copy

    from cor_tpu_torch.models.prompt_encoder import get_dense_pe, prompt_encoder_dense
    from cor_tpu_torch.models.sam_decoder import mask_decoder

    names = [f"transformer.layers.{i}.self_attn.q_proj.w" for i in range(len(dec.transformer.layers))]
    out = {n: [] for n in names}
    with torch.no_grad():
        image_pe, dense = get_dense_pe(pe), prompt_encoder_dense(pe, 1)
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        emb = torch.randn(1, GRID, GRID, SAM_C, generator=gen, device="cuda")
        sparse = torch.randn(1, 1, SAM_C, generator=gen, device="cuda")
        cot, grads = None, []
        for dt in (torch.bfloat16, torch.float32):
            d = copy.deepcopy(dec).to(dt)
            params = dict(d.named_parameters())
            masks, _, _ = mask_decoder(d, emb.to(dt), image_pe.to(dt), sparse.to(dt),
                                       dense.to(dt), multimask, fused=False)
            if cot is None:
                cot = torch.randn(masks.shape, generator=gen, device="cuda")
            gs = torch.autograd.grad((masks.float() * cot).sum(), [params[n] for n in names])
            grads.append([g.float().flatten() for g in gs])
        for n, g16, g32 in zip(names, *grads):
            out[n].append(torch.nn.functional.cosine_similarity(g16[None], g32[None]).item())
    return out


def phase_train_numerics(core_cfg=None, global_block: int = 2, phase: int = 16):
    """One unfrozen step at batch 1 on the card in bf16 and in fp32, each
    against the same step on the CPU in fp32 on the same weights and batch
    (``core_cfg``, default m3's model; ``global_block``: a global block of
    its encoder): bf16 loss within 2e-2 and gradient cosines >= 0.99, fp32
    (its launches all fp32, K6b@fp32 once per block) loss within 1e-4 and
    cosines >= 0.9999; at m3's model also the decoder alone."""
    import copy

    from cor_tpu_torch.config import TrainConfig
    from cor_tpu_torch.models.core_model import init_core_model
    from cor_tpu_torch.train.step import train_loss

    cfg = deterministic_config(core_cfg or TrainConfig().core_config())
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = init_core_model(cfg, SEED)
    model.image_encoder = filled_encoder(cfg)
    b = synthetic_batch(1, cfg)
    batch = {k: torch.from_numpy(b[k]) for k in ("query_img", "query_mask", "support_img",
                                                   "support_mask", "text")}
    names = ("image_encoder.blocks.0.attn.qkv.w",
             f"image_encoder.blocks.{global_block}.attn.rel_pos_h",
             f"image_encoder.blocks.{global_block}.attn.qkv.w",
             "image_encoder.patch_embed.w", "support_branch.siglip.visual.blocks.0.attn.qkv.w",
             "mask_decoder.transformer.layers.0.self_attn.q_proj.w")
    gpu_runs, kept = {}, None
    for dt_name, c in (("bf16", cfg), ("fp32", cfg32)):
        gpu = copy.deepcopy(model).cuda()  # remat on, as the trainer runs it
        reset_counts()
        loss_g, _ = train_loss(c, gpu, {k: v.cuda() for k, v in batch.items()}, None)
        loss_g.backward()
        torch.cuda.synchronize()
        counts = read_counts()
        pg = dict(gpu.named_parameters())
        gpu_runs[dt_name] = (loss_g.item(), {n: pg[n].grad.cpu().double() for n in names},
                             counts)
        if dt_name == "bf16" and core_cfg is None:
            kept = gpu
        del gpu, pg, loss_g
        torch.cuda.empty_cache()
    depth = cfg.encoder.depth
    c32 = gpu_runs["fp32"][2]
    if c32["vit_attention_relpos_bwd@fp32"] != depth or any(
            c32[n] for n in kernel_wrappers()):
        fail(f"the fp32 step on the card: launches {c32} (K6b@fp32 {depth}, no bf16 one, "
             f"expected)")
    # the CPU reference keeps every block's activations: no recompute
    model.image_encoder.cfg = dataclasses.replace(model.image_encoder.cfg, remat_blocks=False)
    t0 = time.perf_counter()
    loss_c, _ = train_loss(cfg32, model, batch, None)
    loss_c.backward()
    dt = time.perf_counter() - t0
    pc = dict(model.named_parameters())
    for dt_name, (loss_g, grads, _), loss_tol, cos_min in (
            ("bf16", gpu_runs["bf16"], 2e-2, COS_MIN),
            ("fp32", gpu_runs["fp32"], FP32_STEP_LOSS, COS32_GRAD)):
        cos = {n: torch.nn.functional.cosine_similarity(  # in fp64: millions of terms
            grads[n].flatten()[None], pc[n].grad.double().flatten()[None]).item() for n in names}
        d = abs(loss_g - loss_c.item()) / abs(loss_c.item())
        print(f"  unfrozen step, batch 1: loss GPU {dt_name} {loss_g:.6f}, CPU fp32 "
              f"{loss_c.item():.6f} (relative {d:.3e}); gradient cosines {json.dumps(cos)} "
              f"(CPU forward and backward {dt:.1f} s)")
        if not d <= loss_tol or min(cos.values()) < cos_min:
            fail(f"GPU {dt_name} and CPU fp32 training steps disagree: loss {d} (limit "
                 f"{loss_tol}), cosines {cos} (limit {cos_min})")
    print(f"  the fp32 step's launches on the card: "
          f"{ {k: v for k, v in c32.items() if v} }")
    if kept is not None:
        dec_cos = decoder_bf16_cosines(kept.mask_decoder, kept.prompt_encoder,
                                       cfg.multimask_output)
        print(f"  the decoder alone on the card, bf16 vs fp32, seeds 0-2: q_proj gradient "
              f"cosines {json.dumps(dec_cos)}")
    del kept, model
    torch.cuda.empty_cache()
    print(f"phase {phase} training numerics: ok", flush=True)


def train_batch():
    from cor_tpu_torch.config import TrainConfig
    from cor_tpu_torch.train.step import BATCH_KEYS

    b = synthetic_batch(TrainConfig().batch_size)
    batch = {k: torch.from_numpy(b[k]).cuda() for k in BATCH_KEYS}
    batch["valid"] = torch.ones(TrainConfig().batch_size, device="cuda")
    return batch


def step_timings(cfg, batch, steps: int = 6, with_profile: bool = False) -> dict:
    """Seconds per train step of TrainConfig ``cfg`` at its batch (CUDA
    events, median and spread of ``steps`` steps after a warm-up), samples/s
    and peak memory; with ``with_profile``, a torch.profiler breakdown of one
    step."""
    from cor_tpu_torch.models.core_model import init_core_model
    from cor_tpu_torch.train.optim import make_optimizer
    from cor_tpu_torch.train.step import TrainState, make_train_step

    model = init_core_model(cfg.core_config(), cfg.seed).cuda()
    opt, _ = make_optimizer(model, cfg.optimizer, cfg.lr, freeze_towers=cfg.freeze_towers)
    state = TrainState(model, opt)
    step = make_train_step(cfg.core_config(), cfg.seed)
    step(state, batch, cfg.lr)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, cfg.lr)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    med = statistics.median(times)
    out = {"s_per_step": med, "min_s": min(times), "max_s": max(times),
           "samples_per_s": cfg.batch_size / med,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if with_profile:
        out["profile"] = profile(lambda: step(state, batch, cfg.lr), 1)
    del state, model, opt
    torch.cuda.empty_cache()
    return out


def phase_train_timings(smi: str):
    from cor_tpu_torch.config import TrainConfig
    from cor_tpu_torch.ops.common import gelu

    batch = train_batch()
    out = {}
    for mode, freeze in (("frozen", True), ("unfrozen", False)):
        cfg = dataclasses.replace(TrainConfig(), freeze_towers=freeze)
        out[mode] = step_timings(cfg, batch, with_profile=not freeze)
    # the encoder's bf16 GELU at its training shape: forward and backward of
    # one MLP's [B * 4096, 3072] (12 per step, and 12 recomputed forwards)
    h = torch.randn(TrainConfig().batch_size * GRID * GRID, 3072, device="cuda").to(
        torch.bfloat16).requires_grad_()
    y = gelu(h)
    g = torch.ones_like(y)
    fwd = cuda_ms(lambda: gelu(h), windows=3, iters=2)[0]
    bwd = cuda_ms(lambda: torch.autograd.grad(y, h, g, retain_graph=True), windows=3, iters=2)[0]
    out["unfrozen"]["encoder_gelu_ms_per_step"] = 12 * (2 * fwd + bwd)
    del h, y, g
    torch.cuda.empty_cache()
    print(json.dumps({"train_timings": {**out, "batch": TrainConfig().batch_size, "card": smi}}))
    u, before = out["unfrozen"], BEFORE_REDESIGN["train_unfrozen"]
    print(f"  unfrozen s/step {u['s_per_step']:.4f} [{u['min_s']:.4f}, {u['max_s']:.4f}] against "
          f"820e02d's (before the K6b redesign) {before[0]:.4f} [{before[1]:.4f}, {before[2]:.4f}]")
    print("phase 17 training timings: ok", flush=True)
    return out


def large_config(d: Path) -> Path:
    """CFG: configs/vaild_config.yaml's keys with sam_huge and
    ViT-SO400M-14-SigLIP-384, as a flat file in ``d``."""
    return flat_config("vaild_config.yaml", d / "large.yaml", **LARGE_KEYS)


@torch.no_grad()
def phase_large_kernels(device):
    """K4′ at ViT-SO400M-14-SigLIP-384's qkv (16 heads of 72; N 729 and 64)
    through both entries, K6 at sam_huge's head_dim 80 (global and
    windowed), K5 at widths 1152 and 1280: each against its plain version,
    timed beside it, the library call and the bound."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
    from cor_tpu_torch.ops.kernels.seq_attention import (
        attention_seq,
        attention_seq_plain,
        attention_seq_qkv,
        attention_seq_qkv_plain,
    )
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    bf16 = torch.bfloat16
    heads, D = 16, 72
    C = heads * D
    k4 = {}
    for tower, n in (("vision", 729), ("text", 64)):
        qkv = rnd(BATCH, n, 3 * C).to(bf16)
        q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                   .contiguous() for i in range(3))
        got, want = attention_seq_qkv(qkv, heads), attention_seq_qkv_plain(qkv, heads)
        got4, want4 = attention_seq(q, k, v, heads), attention_seq_plain(q, k, v, heads)
        torch.cuda.synchronize()
        errs = (rel_err(got, want), rel_err(got4, want4))
        kt = cuda_ms(lambda: attention_seq_qkv(qkv, heads))
        kt4 = cuda_ms(lambda: attention_seq(q, k, v, heads))
        pt = cuda_ms(lambda: attention_seq_qkv_plain(qkv, heads), iters=3)
        lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        dev = device_times(lambda: attention_seq_qkv(qkv, heads),
                           lambda: F.scaled_dot_product_attention(q, k, v))
        dev["bhnd_entry_device_ms"] = device_times(
            lambda: attention_seq(q, k, v, heads))["device_ms"]
        b = bound(nbytes(qkv) + nbytes(got), 4 * BATCH * heads * n * n * D)
        print(f"  K4′ head_dim 72 [{BATCH}, {n}, {3 * C}]: max|d|/max|plain| = {errs[0]:.3e} "
              f"fused, {errs[1]:.3e} [B, H, N, D]; kernel {kt[0]:.4f} ms [{kt[1]:.4f}, "
              f"{kt[2]:.4f}] fused, {kt4[0]:.4f} ms [B, H, N, D], plain {pt[0]:.4f} ms, SDPA "
              f"{lt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]}); graph replays: kernel "
              f"{dev['device_ms']:.4f} ms fused, {dev['bhnd_entry_device_ms']:.4f} ms "
              f"[B, H, N, D], SDPA {dev['library_device_ms']:.4f} ms")
        if not max(errs) <= DECODE_REL:
            fail(f"K4′ ({tower}) disagrees with its plain version: {errs}")
        k4[tower] = entry(abs_err((got, want), (got4, want4)), kt, pt, b, lt,
                          max_rel_err=max(errs), bhnd_entry_ms=kt4[0], **dev)
        del q, k, v

    heads, D = 16, 80
    C = heads * D
    k6 = {}
    for label, B, side in (("global", 2, GRID), ("windowed", 50, 14)):
        N = side * side
        qkv = rnd(B, N, 3 * C).to(bf16)
        rel_h = (0.3 * rnd(B, heads, N, side)).to(bf16)
        rel_w = (0.3 * rnd(B, heads, N, side)).to(bf16)
        args = (qkv, rel_h, rel_w, heads, (side, side))
        got, want = vit_attention_relpos(*args), vit_attention_relpos_plain(*args)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        kt = cuda_ms(lambda: vit_attention_relpos(*args))
        pt = cuda_ms(lambda: vit_attention_relpos_plain(*args), windows=3, iters=2)
        q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                   for i in range(3))
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, heads, N, N)
        lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        b = bound(nbytes(qkv, rel_h, rel_w, got), 4 * B * heads * N * N * D)
        print(f"  K6 head_dim 80 {label} [{B}, {N}, {3 * C}]: max|d|/max|plain| = {err:.3e}; "
              f"kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, SDPA with "
              f"the bias {lt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})")
        if not err <= DECODE_REL:
            fail(f"K6 at head_dim 80 ({label}) disagrees with its plain version: {err}")
        k6[label] = entry(abs_err((got, want)), kt, pt, b, lt, max_rel_err=err)
        del bias, q, k, v, want
        torch.cuda.empty_cache()

    ln = {}
    for C, rows in ((1152, BATCH * 729), (1280, SAM_BATCH * GRID * GRID)):
        x = (2 * rnd(rows, C) + 0.5).to(bf16)
        scale, bias = (1 + 0.1 * rnd(C)).to(bf16), (0.1 * rnd(C)).to(bf16)
        got, want = layer_norm(x, scale, bias, 1e-6), layer_norm_plain(x, scale, bias, 1e-6)
        torch.cuda.synchronize()
        err = abs_err((got, want))
        kt = cuda_ms(lambda: layer_norm(x, scale, bias, 1e-6))
        pt = cuda_ms(lambda: layer_norm_plain(x, scale, bias, 1e-6))
        lt = cuda_ms(lambda: F.layer_norm(x, (C,), scale, bias, 1e-6))
        dev = device_times(lambda: layer_norm(x, scale, bias, 1e-6),
                           lambda: F.layer_norm(x, (C,), scale, bias, 1e-6))
        b = bound(2 * nbytes(x) + nbytes(scale, bias), 8 * x.numel())
        print(f"  K5 layer_norm [{rows}, {C}] bf16: max|d|={err:.3e} kernel {kt[0]:.4f} ms, "
              f"plain {pt[0]:.4f} ms, F.layer_norm {lt[0]:.4f} ms, bound {b[0]:.4f} ms; graph "
              f"replays: kernel {dev['device_ms']:.4f} ms, F.layer_norm "
              f"{dev['library_device_ms']:.4f} ms")
        if err > KERNEL_TOL:
            fail(f"layer_norm kernel disagrees with its plain version at C={C}: {err}")
        ln[f"[{rows},{C}]"] = entry(err, kt, pt, b, lt, **dev)
    torch.cuda.empty_cache()
    print("phase 18 large-config kernels: ok", flush=True)
    return dict(k4["vision"], text=k4["text"]), dict(k6["global"], windowed=k6["windowed"]), ln


def phase_large_timings(servers, dec_server, enc_gpu, cfg, smi: str):
    """Encode+scan at buckets 1, 4, 16; encode+scan+decode at bucket 4
    (--store-hbm); the image encode at batch 1 and 8; peak memory; a
    profile of one bucket-16 query encode and one batch-8 image encode."""
    from cor_tpu_torch.retrieval.index import make_candidate_encoder

    phase_timings(servers["fp32"], smi, key="large_timings", phase=22)
    torch.cuda.reset_peak_memory_stats()
    tensors = dec_server._batch_tensors([dec_server._synthetic_query(i) for i in range(4)])
    med, lo, hi = cuda_ms(lambda: dec_server.encode_scan_decode(*tensors, 4), windows=7, iters=3)
    decode = {"ms": med, "min_ms": lo, "max_ms": hi,
              "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    encode = make_candidate_encoder(cfg)
    b = synthetic_batch(SAM_BATCH, cfg)
    imgs, masks = (torch.from_numpy(b[k]).cuda() for k in ("query_img", "query_mask"))
    encode_ms = {}
    for n in (1, SAM_BATCH):
        torch.cuda.reset_peak_memory_stats()
        med, lo, hi = cuda_ms(lambda: encode(enc_gpu, imgs[:n], masks[:n]), windows=5, iters=2)
        encode_ms[str(n)] = {"ms": med, "min_ms": lo, "max_ms": hi,
                             "candidates_per_s": n / med * 1e3,
                             "cor127k_minutes": GALLERY_ROWS / (n / med * 1e3) / 60,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    server = servers["fp32"]
    q16 = server._batch_tensors([server._synthetic_query(i) for i in range(16)])
    query_prof = profile(lambda: server.encode_query(server.model, q16[0], q16[2], q16[1]), 1)
    image_prof = profile(lambda: encode(enc_gpu, imgs, masks), 1)
    print(json.dumps({"large_decode_timings": {
        "encode_scan_decode_ms_bucket4": decode, "store_rows": LARGE_BUILD_ROWS, "k": 10,
        "store": "int8 on the card", "card": smi}}))
    print(json.dumps({"large_build_timings": {"encode_ms_by_batch": encode_ms, "card": smi}}))
    print(json.dumps({"large_query_profile": {"bucket": 16, **query_prof, "card": smi}}))
    print(json.dumps({"large_encode_profile": {"batch": SAM_BATCH, **image_prof, "card": smi}}))
    print("phase 22 large-config timings: ok", flush=True)


def phase_large(smi: str):
    """Phases 19-22 at CFG (sam_huge + ViT-SO400M-14-SigLIP-384). Returns
    the launch counts of its serving and build paths."""
    from cor_tpu_torch.config import load_eval_config

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cfg_path = large_config(d)
        ecfg = load_eval_config(cfg_path)
        print(f"  CFG {cfg_path.name}: {json.dumps(LARGE_KEYS)}", flush=True)
        build_counts, build_s, idx = build_index(d / "index", LARGE_BUILD_ROWS, cfg_path,
                                                 per_batch=(32, 66))
        print("phase 19 large-config gallery build: ok", flush=True)

        pair_ids = save_synthetic_gallery(d / "gallery")
        servers, serve_counts = phase_serve(d / "gallery", pair_ids, cfg_path, LARGE_TOWERS,
                                            phase=20)
        dec_server, _, _ = serve_masks(
            d / "index", set(idx["pair_ids"].tolist()), d / "masks", "hbm, sam_huge index",
            ["--store-hbm"], cfg_path, LARGE_TOWERS)
        print("phase 20 large-config serving: ok", flush=True)

        phase_numerics(servers["fp32"], ecfg, phase=21)
        enc_gpu, _, _ = phase_encoder_numerics(ecfg, phase=21)
        phase_large_timings(servers, dec_server, enc_gpu, ecfg.core_config(), smi)
        del servers, dec_server, enc_gpu
        torch.cuda.empty_cache()
    return serve_counts, build_counts


def phase_k7(device):
    """K7 at SAM-base's and sam_huge's padded grids (two images, 70 x 70 in
    windows of 14, cropped to 64 x 64) against its plain version and against
    K6 on the partitioned windows (the same arithmetic: equal bit for bit),
    timed beside the plain version, K6 with the partition and unpartition
    copies of the unflagged route, SDPA with the bias and the bound."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.attention import window_partition, window_unpartition
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_windows,
        vit_attention_relpos_windows_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    bf16 = torch.bfloat16
    B, ws, Hp = 2, 14, 70
    nW, N = (Hp // ws) ** 2, ws * ws
    out = {}
    for label, heads, D in (("sam_base", 12, 64), ("sam_huge", 16, 80)):
        C = heads * D
        qkv = rnd(B, Hp, Hp, 3 * C).to(bf16)
        rel_h = (0.3 * rnd(B, heads, Hp * Hp, ws)).to(bf16)
        rel_w = (0.3 * rnd(B, heads, Hp * Hp, ws)).to(bf16)
        args = (qkv, rel_h, rel_w, heads, ws, (GRID, GRID))
        got = vit_attention_relpos_windows(*args)
        want = vit_attention_relpos_windows_plain(*args)
        # the unflagged route's operands: the windows partitioned by copies
        qkv_w = window_partition(qkv, ws)[0].reshape(B * nW, N, 3 * C)
        rel_win = [window_partition(r.reshape(B, heads, Hp, Hp, ws).permute(0, 2, 3, 1, 4)
                                    .reshape(B, Hp, Hp, heads * ws), ws)[0]
                   .reshape(B * nW, N, heads, ws).transpose(1, 2).contiguous()
                   for r in (rel_h, rel_w)]
        k6 = vit_attention_relpos(qkv_w, *rel_win, heads, (ws, ws))
        k6 = window_unpartition(k6.reshape(B * nW, ws, ws, C), ws, (Hp, Hp), (GRID, GRID))
        torch.cuda.synchronize()
        err, same = rel_err(got, want), torch.equal(got, k6)
        kt = cuda_ms(lambda: vit_attention_relpos_windows(*args))
        pt = cuda_ms(lambda: vit_attention_relpos_windows_plain(*args), windows=3, iters=2)
        # the attention step of a windowed block either way, from the LN'd
        # grid x [B, 64, 64, C] (the QKV GEMM, the same rows, left out):
        # unflagged, partition x, K6, unpartition; flagged, pad x, K7
        x = rnd(B, GRID, GRID, C).to(bf16)

        def k6_route():
            window_partition(x, ws)
            o = vit_attention_relpos(qkv_w, *rel_win, heads, (ws, ws))
            return window_unpartition(o.reshape(B * nW, ws, ws, C), ws, (Hp, Hp), (GRID, GRID))

        def k7_route():
            F.pad(x, (0, 0, 0, Hp - GRID, 0, Hp - GRID))
            return vit_attention_relpos_windows(*args)

        k6t, k7t = cuda_ms(k6_route), cuda_ms(k7_route)
        q, k, v = (qkv_w[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                   for i in range(3))
        bias = (rel_win[0][..., :, None] + rel_win[1][..., None, :]).reshape(B * nW, heads, N, N)
        lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        b = bound(nbytes(qkv, rel_h, rel_w, got), 4 * B * nW * heads * N * N * D)
        print(f"  K7 vit_attention_relpos_windows {label} [{B}, {Hp}, {Hp}, {3 * C}] -> "
              f"{tuple(got.shape)}: max|d|/max|plain| = {err:.3e}, equal to K6 on the "
              f"partitioned windows: {same}; kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], "
              f"plain {pt[0]:.4f} ms, SDPA with the bias {lt[0]:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]}); pad + K7 {k7t[0]:.4f} ms, partition + K6 + unpartition "
              f"{k6t[0]:.4f} ms", flush=True)
        if not err <= DECODE_REL or not same:
            fail(f"K7 ({label}) disagrees with its plain version ({err}) or with K6 on the "
                 f"partitioned windows (equal: {same})")
        out[label] = entry(abs_err((got, want)), kt, pt, b, lt, max_rel_err=err,
                           equal_to_k6_on_windows=same, pad_k7_ms=k7t[0],
                           partition_k6_unpartition_ms=k6t[0])
        del want, k6, bias, q, k, v, qkv_w, rel_win
        torch.cuda.empty_cache()
    print("phase 24 K7 kernels: ok", flush=True)
    return dict(out["sam_huge"], sam_base=out["sam_base"])


def phase_k7_encoders(smi: str):
    """The full-depth encoder at batch 8, SAM-base and sam_huge (tables and
    pos_embed filled), with and without fused_window_indexing through
    ``make_candidate_encoder``: exact launch counts, the cosine between the
    two, ms per batch (timed in turns: without, with, with, without).
    Returns sam_huge's flagged launch counts."""
    from cor_tpu_torch.config import EvalConfig, load_eval_config
    from cor_tpu_torch.models.core_model import _cast
    from cor_tpu_torch.retrieval.index import make_candidate_encoder

    out, counts = {}, None
    with tempfile.TemporaryDirectory() as d:
        large = load_eval_config(large_config(Path(d))).core_config()
    for label, cfg in (("sam_base", EvalConfig().core_config()), ("sam_huge", large)):
        enc_cfg = cfg.encoder
        windowed = enc_cfg.depth - len(enc_cfg.global_attn_indexes)
        b = synthetic_batch(SAM_BATCH, cfg)
        imgs, masks = (torch.from_numpy(b[k]).cuda() for k in ("query_img", "query_mask"))
        runs = {}
        for flag in (False, True):
            fcfg = dataclasses.replace(cfg, encoder_override=dataclasses.replace(
                enc_cfg, fused_window_indexing=flag))
            enc = _cast(filled_encoder(fcfg).cuda(), cfg.dtype).eval()
            encode = make_candidate_encoder(fcfg)
            reset_counts()
            pooled, emb = encode(enc, imgs, masks)
            torch.cuda.synchronize()
            c = read_counts()
            want = {k: 0 for k in c}
            want.update(layer_norm=2 * enc_cfg.depth + 2,
                        vit_attention_relpos=len(enc_cfg.global_attn_indexes) if flag
                        else enc_cfg.depth,
                        vit_attention_relpos_windows=windowed if flag else 0)
            if c != want or not torch.isfinite(emb).all():
                fail(f"encoder {label} (fused_window_indexing={flag}): launches {c} != {want}, "
                     f"or a value is not finite")
            if flag:
                counts = c
            runs[flag] = (lambda enc=enc, encode=encode: encode(enc, imgs, masks), pooled, emb, c)
        times = {False: [], True: []}
        for flag in (False, True, True, False):
            times[flag].append(cuda_ms(runs[flag][0], windows=3, iters=1))
        ms = {f: (statistics.median(t[0] for t in ts), min(t[1] for t in ts),
                  max(t[2] for t in ts)) for f, ts in times.items()}
        cos_flat = torch.nn.functional.cosine_similarity(
            runs[True][2].flatten()[None].double(), runs[False][2].flatten()[None].double()).item()
        cos_pool = torch.nn.functional.cosine_similarity(runs[True][1], runs[False][1]).min().item()
        print(f"  encoder {label} batch {SAM_BATCH}, fused_window_indexing vs not: cosine "
              f"{cos_flat:.6f} flattened, min {cos_pool:.6f} pooled; launches {runs[True][3]} "
              f"and {runs[False][3]}; {ms[True][0]:.2f} ms [{ms[True][1]:.2f}, "
              f"{ms[True][2]:.2f}] with the flag, {ms[False][0]:.2f} ms [{ms[False][1]:.2f}, "
              f"{ms[False][2]:.2f}] without (turns: without, with, with, without)", flush=True)
        if min(cos_flat, cos_pool) < 0.999:
            fail(f"encoder {label}: the flagged and unflagged encoders disagree: cosines "
                 f"{cos_flat}, {cos_pool}")
        out[label] = {"cosine_flat": cos_flat, "cosine_pooled_min": cos_pool,
                      "ms_flagged": ms[True], "ms_unflagged": ms[False],
                      "ms_turns": {"unflagged": times[False], "flagged": times[True]},
                      "launches_flagged": runs[True][3], "launches_unflagged": runs[False][3]}
        del runs, imgs, masks
        torch.cuda.empty_cache()
    print(json.dumps({"k7_encoders": {**out, "batch": SAM_BATCH, "card": smi}}))
    print("phase 25 K7 encoders: ok", flush=True)
    return counts


def phase_large_train_timings(trainer, smi: str, sfx: str = "", phase: int = 27,
                              grad_accum: int = 1, steps: int = 3, with_profile: bool = True):
    """On an unfrozen CFG trainer (phase 26's; phase 32's in fp32, ``sfx``
    "@fp32"), its step at batch 10 taken as ``grad_accum`` microbatches: one
    step's launches (K6b 32 and K6 64 per microbatch, exactly; with ``sfx``
    no bf16 launch), seconds per step (CUDA events, median and spread of
    ``steps`` steps), samples/s, peak memory and (with ``with_profile``) a
    torch.profiler breakdown of one step."""
    from cor_tpu_torch.train.step import BATCH_KEYS, make_train_step

    cfg = trainer.cfg
    n = cfg.batch_size
    b = synthetic_batch(n, trainer.core_cfg)
    batch = {k: torch.from_numpy(b[k]).cuda() for k in BATCH_KEYS}
    batch["valid"] = torch.ones(n, device="cuda")
    train_step = (trainer.train_step if grad_accum == cfg.grad_accum else
                  make_train_step(trainer.core_cfg, cfg.seed, grad_accum=grad_accum))
    step = lambda: train_step(trainer.state, batch, cfg.lr)  # noqa: E731
    blocks = trainer.core_cfg.encoder.depth * grad_accum
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    loss = step()["total_loss"].item()
    c = read_counts()
    if c["vit_attention_relpos_bwd" + sfx] != blocks or \
            c["vit_attention_relpos" + sfx] != 2 * blocks or not np.isfinite(loss) or (
            sfx and any(c[n] for n in kernel_wrappers())):
        fail(f"CFG train step{sfx}: launches {c} (K6b{sfx} {blocks} and K6{sfx} {2 * blocks} "
             f"expected), loss {loss}")
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    med = statistics.median(times)
    out = {"s_per_step": med, "min_s": min(times), "max_s": max(times),
           "samples_per_s": n / med, "batch": n, "grad_accum": grad_accum, "loss": loss,
           "launches_per_step": {k: v for k, v in c.items() if v},
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           **({"profile": profile(step, 1)} if with_profile else {}), "card": smi}
    print(json.dumps({f"large_train_timings{sfx}": out}))
    if not sfx and grad_accum == 1:
        before = BEFORE_REDESIGN["large_train"]
        print(f"  s/step {med:.4f} [{min(times):.4f}, {max(times):.4f}] against 820e02d's (before "
              f"the K6b redesign) {before[0]:.4f} [{before[1]:.4f}, {before[2]:.4f}]")
    print(f"phase {phase} training timings at CFG{sfx}, grad_accum {grad_accum}: ok", flush=True)
    return out


LARGE_TRAIN_BLOCKS = 4  # phases 26-27's sam_huge depth: blocks 0-2 windowed, 3 global


@contextlib.contextmanager
def train_encoder_depth(blocks: int):
    """cli.train's models with the image encoder cut to its first ``blocks``
    blocks (the last of them global) at full width: TrainConfig.core_config
    patched while the block runs."""
    from cor_tpu_torch.config import TrainConfig

    full = TrainConfig.core_config

    def cut(self):
        cfg = full(self)
        return dataclasses.replace(cfg, encoder_override=dataclasses.replace(
            cfg.encoder, depth=blocks, global_attn_indexes=(blocks - 1,)))

    TrainConfig.core_config = cut
    try:
        yield
    finally:
        TrainConfig.core_config = full


def phase_large_train(smi: str):
    """Phases 26-28: cli.train at CFG frozen and unfrozen with sam_huge cut
    to LARGE_TRAIN_BLOCKS blocks at full width (the towers at full depth),
    the unfrozen step's timings, and its numerics at batch 1 with sam_huge
    cut to 4 blocks (one global) at full width."""
    from cor_tpu_torch.config import TrainConfig

    with tempfile.TemporaryDirectory() as d, train_encoder_depth(LARGE_TRAIN_BLOCKS):
        print(f"  training at CFG: sam_huge cut to {LARGE_TRAIN_BLOCKS} blocks (block "
              f"{LARGE_TRAIN_BLOCKS - 1} global) at full width, the towers at full depth",
              flush=True)
        counts, _, trainer = phase_train(Path(d), LARGE_KEYS, blocks=LARGE_TRAIN_BLOCKS,
                                         phase=26, keep_unfrozen=True)
    phase_large_train_timings(trainer, smi)
    del trainer
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(TrainConfig(), **LARGE_KEYS).core_config()
    cut = dataclasses.replace(cfg.encoder, depth=4, global_attn_indexes=(3,))
    print("  numerics at CFG: sam_huge cut to 4 blocks (block 3 global) at full width, "
          "the towers at full depth", flush=True)
    phase_train_numerics(dataclasses.replace(cfg, encoder_override=cut), global_block=3,
                         phase=28)
    return counts["unfrozen"]


def phase_large_fp32(smi: str):
    """Phase 32: the fp32 paths at CFG (sam_huge + ViT-SO400M-14-SigLIP-384,
    full depth and width, compute_dtype float32) through the entry points:
    cli.index (16 candidates: K6@fp32 32 and K5@fp32 66 per encoded batch),
    cli.serve over the 127,166-row gallery with the fp32 and --int8 scans
    (K4′@fp32 54 and K5@fp32 110 per encoded batch), --decode-masks
    --store-hbm on the index, then unfrozen cli.train on m3's keys at batch
    10 with sam_huge cut to LARGE_TRAIN_BLOCKS blocks as in phases 26-27
    (K6b@fp32 4 per step), and that step's timings in one pass and split in
    two microbatches by grad_accum (K6b@fp32 8 per step); no bf16 launch
    anywhere. Returns the launch counts of the serving, build and training
    paths."""
    keys = {**LARGE_KEYS, "compute_dtype": "float32"}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        cfg_path = flat_config("vaild_config.yaml", d / "large32.yaml", **keys)
        print(f"  CFG fp32 {cfg_path.name}: {json.dumps(keys)}", flush=True)
        build_counts, build_s, idx = build_index(d / "index", LARGE_BUILD_ROWS, cfg_path,
                                                 per_batch=(32, 66), sfx="@fp32")
        pair_ids = save_synthetic_gallery(d / "gallery")
        servers, serve_counts = phase_serve(d / "gallery", pair_ids, cfg_path, LARGE_TOWERS,
                                            phase=32, sfx="@fp32")
        del servers
        dec_server, dec_counts, _ = serve_masks(
            d / "index", set(idx["pair_ids"].tolist()), d / "masks",
            "fp32 compute, hbm, sam_huge index", ["--store-hbm"], cfg_path, LARGE_TOWERS,
            sfx="@fp32")
        del dec_server
        torch.cuda.empty_cache()
        with train_encoder_depth(LARGE_TRAIN_BLOCKS):
            print(f"  fp32 training at CFG: sam_huge cut to {LARGE_TRAIN_BLOCKS} blocks (block "
                  f"{LARGE_TRAIN_BLOCKS - 1} global) at full width, the towers at full depth",
                  flush=True)
            counts, results, trainer = phase_train(
                d / "train", keys, blocks=LARGE_TRAIN_BLOCKS, phase=32, keep_unfrozen=True,
                modes=(("unfrozen", False),), sfx="@fp32")
    for ga in (1, 2):
        phase_large_train_timings(trainer, smi, sfx="@fp32", phase=32, grad_accum=ga, steps=2,
                                  with_profile=False)
    del trainer
    torch.cuda.empty_cache()
    print(json.dumps({"large_fp32_paths": {
        "build": {"rows": LARGE_BUILD_ROWS, "seconds": build_s,
                  "launches": {k: v for k, v in build_counts.items() if v}},
        "serve_launches": {k: v for k, v in serve_counts.items() if v},
        "decode_serve_launches": {k: v for k, v in dec_counts.items() if v},
        "train_unfrozen": {**results["unfrozen"],
                           "launches": {k: v for k, v in counts["unfrozen"].items() if v}},
        "card": smi}}))
    print("phase 32 fp32 paths at CFG: ok", flush=True)
    return {"serve": serve_counts, "build": build_counts, "train": counts["unfrozen"]}



# ---------------------------------------------------------------------------
# fp32 (compute_dtype float32): phases 29-31
# ---------------------------------------------------------------------------

# cor_tpu's own fp32 kernel tests against their oracles (atol = rtol, or
# (atol, rtol)): K5 tests/test_pallas_kernels.py:19, K4/K4′
# test_kernel_vjp.py:96-98, K6/K7 test_vit_attention_kernel.py:22, K6b (the
# gradient: global, multitile, windowed) test_kernel_vjp.py:167,187,210, K1
# test_two_way_layer_kernel.py:43-44, K1 + K2 through the two-way
# transformer :59-60 (K2's only fp32 test), K3 test_decoder_tail_kernel.py:31
FP32_TOL = {"layer_norm": 1e-5, "attention_seq_qkv": 1e-5, "vit_attention_relpos": 2e-4,
            "vit_attention_relpos_windows": 2e-4, "vit_attention_relpos_bwd": (1e-5, 1e-4),
            "two_way_layer": 2e-4, "t2i_flash_kv": 5e-4, "transformer": 5e-4,
            "decoder_tail": 2e-4}
# fp32-accurate products on the tensor cores: 3xTF32, three TF32 products
# (494.7 TFLOP/s dense, NVIDIA data sheet) per fp32 product; above the 67
# TFLOP/s of fp32 on the CUDA cores, so the least time the card could take
PEAK_FP32_FLOP_S = 494.7e12 / 3


def bound32(n_bytes: float, flops: float):
    """The fp32 bound: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def tol_err(tol, *pairs):
    """(max |got - want|, max |got - want| / (atol + rtol |want|)) with
    ``tol`` atol = rtol, or (atol, rtol): the second is <= 1 where
    allclose(atol, rtol) holds."""
    atol, rtol = tol if isinstance(tol, tuple) else (tol, tol)
    d = max((g.float() - w.float()).abs().max().item() for g, w in pairs)
    r = max(((g.float() - w.float()).abs() / (atol + rtol * w.float().abs())).max().item()
            for g, w in pairs)
    return d, r


def check32(name: str, label: str, tol, pairs, kt, pt, b, lt=None, **extra):
    err, ratio = tol_err(tol, *pairs)
    lib = "" if lt is None else f", library {lt[0]:.4f} ms"
    dev = "" if "device_ms" not in extra else (
        f"; graph replays: kernel {extra['device_ms']:.4f} ms" + (
            f", library {extra['library_device_ms']:.4f} ms" if "library_device_ms" in extra
            else ""))
    print(f"  {name} fp32 {label}: max|d| = {err:.3e}, max|d|/(atol + rtol|plain|) = "
          f"{ratio:.3f} (tol {tol}); kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain "
          f"{pt[0]:.4f} ms{lib}, bound {b[0]:.4f} ms ({b[1]}){dev}", flush=True)
    if not ratio <= 1.0:
        fail(f"{name} fp32 ({label}) disagrees with its plain fp32 version: max|d| {err}, "
             f"{ratio} x its tolerance {tol}")
    return entry(err, kt, pt, b, lt, tol=tol, tol_ratio=ratio, **extra)


@torch.no_grad()
def phase_fp32_kernels(device):
    """Phase 29: every fp32 kernel against its plain fp32 version (TF32 off)
    on the same inputs, at the shapes of phases 3, 10, 18 and 24, with
    cor_tpu's fp32 tolerances; timed beside the plain version, the library
    call and the fp32 bound (K4/K4′, K5, K6 with and without the lse and K7
    also as CUDA-graph replays beside their library calls')."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.layernorm import layer_norm, layer_norm_plain
    from cor_tpu_torch.ops.kernels.seq_attention import (
        attention_seq,
        attention_seq_plain,
        attention_seq_qkv,
        attention_seq_qkv_plain,
    )
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_plain,
        vit_attention_relpos_windows,
        vit_attention_relpos_windows_plain,
        vit_attention_relpos_with_lse,
    )

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("phase 29 holds the fp32 kernels to plain versions with TF32 off")
    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    out = {}

    # K5 at the towers' [16 * 576, 768], the encoder's [8 * 4096, 768], the
    # neck's [8 * 4096, 256], and the largest configuration's SO400M towers
    # [16 * 729, 1152] and sam_huge encoder [8 * 4096, 1280]
    tol = FP32_TOL["layer_norm"]
    ln = {}
    for rows, C in ((BATCH * 576, 768), (SAM_BATCH * GRID * GRID, 768),
                    (SAM_BATCH * GRID * GRID, SAM_C), (BATCH * 729, 1152),
                    (SAM_BATCH * GRID * GRID, 1280)):
        x = 2 * rnd(rows, C) + 0.5
        scale, bias = 1 + 0.1 * rnd(C), 0.1 * rnd(C)
        got, want = layer_norm(x, scale, bias, 1e-6), layer_norm_plain(x, scale, bias, 1e-6)
        kt = cuda_ms(lambda: layer_norm(x, scale, bias, 1e-6))
        pt = cuda_ms(lambda: layer_norm_plain(x, scale, bias, 1e-6))
        lt = cuda_ms(lambda: F.layer_norm(x, (C,), scale, bias, 1e-6))
        dev = device_times(lambda: layer_norm(x, scale, bias, 1e-6),
                           lambda: F.layer_norm(x, (C,), scale, bias, 1e-6))
        b = bound32(2 * nbytes(x) + nbytes(scale, bias), 8 * x.numel())
        ln[f"[{rows},{C}]"] = check32("K5 layer_norm", f"[{rows}, {C}]", tol, [(got, want)], kt,
                                      pt, b, lt, **dev)
    first = f"[{BATCH * 576},768]"
    out["layer_norm@fp32"] = dict(ln.pop(first), other_shapes=ln)

    # K4 at [16, 576, 2304] and [16, 64, 2304]; K4′ at 72 (SO400M, vision and
    # text, both entries) and 80 (ragged N)
    tol = FP32_TOL["attention_seq_qkv"]
    k4 = {}
    for label, heads, D, n in (("vision", 12, 64, 576), ("text", 12, 64, 64),
                               ("d72-vision", 16, 72, 729), ("d72-text", 16, 72, 64),
                               ("d80-ragged", 16, 80, 100)):
        C = heads * D
        qkv = rnd(BATCH, n, 3 * C)
        q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                   .contiguous() for i in range(3))
        got, want = attention_seq_qkv(qkv, heads), attention_seq_qkv_plain(qkv, heads)
        got4, want4 = attention_seq(q, k, v, heads), attention_seq_plain(q, k, v, heads)
        pairs = [(got, want), (got4, want4)]
        kt = cuda_ms(lambda: attention_seq_qkv(qkv, heads))
        pt = cuda_ms(lambda: attention_seq_qkv_plain(qkv, heads), iters=3)
        lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v))
        dev = device_times(lambda: attention_seq_qkv(qkv, heads),
                           lambda: F.scaled_dot_product_attention(q, k, v))
        dev["bhnd_entry_device_ms"] = device_times(
            lambda: attention_seq(q, k, v, heads))["device_ms"]
        b = bound32(nbytes(qkv) + nbytes(got), 4 * BATCH * heads * n * n * D)
        k4[label] = check32("K4 attention_seq_qkv", f"{label} [{BATCH}, {n}, {3 * C}]", tol,
                            pairs, kt, pt, b, lt, **dev)
        del q, k, v
    out["attention_seq_qkv@72@fp32"] = dict(k4.pop("d72-vision"), text=k4.pop("d72-text"))
    out["attention_seq_qkv@fp32"] = dict(k4.pop("vision"), other_shapes=k4)

    # K6 at 64 and 80, global [2, 4096, 3C] and windowed [50, 196, 3C]; with
    # the rows' lse (autograd's forward: the same bits of out) too
    tol = FP32_TOL["vit_attention_relpos"]
    k6 = {}
    for heads, D in ((12, 64), (16, 80)):
        C = heads * D
        for label, B, side in (("global", 2, GRID), ("windowed", 50, 14)):
            N = side * side
            qkv = rnd(B, N, 3 * C)
            rel_h, rel_w = 0.3 * rnd(B, heads, N, side), 0.3 * rnd(B, heads, N, side)
            args = (qkv, rel_h, rel_w, heads, (side, side))
            got, want = vit_attention_relpos(*args), vit_attention_relpos_plain(*args)
            got_l, lse = vit_attention_relpos_with_lse(*args)
            if not torch.equal(got_l, got):
                fail(f"K6 fp32 d{D} {label}: out differs with the lse written")
            kt = cuda_ms(lambda: vit_attention_relpos(*args))
            pt = cuda_ms(lambda: vit_attention_relpos_plain(*args), windows=3, iters=2)
            q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                       for i in range(3))
            bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, heads, N, N)
            lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
            dev = device_times(lambda: vit_attention_relpos(*args),
                               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
            dev["with_lse_device_ms"] = device_times(
                lambda: vit_attention_relpos_with_lse(*args))["device_ms"]
            b = bound32(nbytes(qkv, rel_h, rel_w, got), 4 * B * heads * N * N * D)
            k6[f"d{D}-{label}"] = check32("K6 vit_attention_relpos",
                                         f"d{D} {label} [{B}, {N}, {3 * C}]", tol,
                                         [(got, want)], kt, pt, b, lt, **dev)
            print(f"    writing the lse: device {dev['with_lse_device_ms']:.4f} ms; share of "
                  f"the bound {b[0] / dev['device_ms']:.3f}", flush=True)
            del bias, q, k, v, want, got_l, lse
            torch.cuda.empty_cache()
    out["vit_attention_relpos@80@fp32"] = dict(k6.pop("d80-global"),
                                               windowed=k6.pop("d80-windowed"))
    out["vit_attention_relpos@fp32"] = dict(k6.pop("d64-global"),
                                            windowed=k6.pop("d64-windowed"))

    # K7 at [2, 70, 70, 3C], windows of 14 cropped to 64 x 64, C 768 and 1280
    tol = FP32_TOL["vit_attention_relpos_windows"]
    k7 = {}
    B, ws, Hp = 2, 14, 70
    nW, N = (Hp // ws) ** 2, ws * ws
    for label, heads, D in (("sam_base", 12, 64), ("sam_huge", 16, 80)):
        C = heads * D
        qkv = rnd(B, Hp, Hp, 3 * C)
        rel_h, rel_w = 0.3 * rnd(B, heads, Hp * Hp, ws), 0.3 * rnd(B, heads, Hp * Hp, ws)
        args = (qkv, rel_h, rel_w, heads, ws, (GRID, GRID))
        got = vit_attention_relpos_windows(*args)
        want = vit_attention_relpos_windows_plain(*args)
        kt = cuda_ms(lambda: vit_attention_relpos_windows(*args))
        pt = cuda_ms(lambda: vit_attention_relpos_windows_plain(*args), windows=3, iters=2)
        # SDPA with the bias on the partitioned windows (the partition is not timed)
        qw = qkv.reshape(B, Hp // ws, ws, Hp // ws, ws, 3 * C).permute(0, 1, 3, 2, 4, 5)
        qw = qw.reshape(B * nW, N, 3 * C)
        rw = [r.reshape(B, heads, Hp // ws, ws, Hp // ws, ws, ws).permute(0, 2, 4, 1, 3, 5, 6)
              .reshape(B * nW, heads, N, ws) for r in (rel_h, rel_w)]
        q, k, v = (qw[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                   for i in range(3))
        bias = (rw[0][..., :, None] + rw[1][..., None, :]).reshape(B * nW, heads, N, N)
        lt = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        dev = device_times(lambda: vit_attention_relpos_windows(*args),
                           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias))
        b = bound32(nbytes(qkv, rel_h, rel_w, got), 4 * B * nW * heads * N * N * D)
        k7[label] = check32("K7 vit_attention_relpos_windows", f"{label} [{B}, {Hp}, {Hp}, "
                            f"{3 * C}]", tol, [(got, want)], kt, pt, b, lt, **dev)
        print(f"    share of the bound {b[0] / dev['device_ms']:.3f}", flush=True)
        del bias, q, k, v, qw, rw, want
        torch.cuda.empty_cache()
    out["vit_attention_relpos_windows@fp32"] = dict(k7.pop("sam_base"), other_shapes=k7)

    k6b = k6b_fp32(device, gen)
    out["vit_attention_relpos_bwd@fp32"] = dict(k6b["d64-global"], windowed=k6b["d64-windowed"])
    out["vit_attention_relpos_bwd@80@fp32"] = dict(k6b["d80-global"],
                                                   windowed=k6b["d80-windowed"])
    out.update(decoder_kernels_fp32(device, gen))
    print(f"phase 29 fp32 kernels: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def k6b_fp32(device, gen):
    """K6b@fp32 at SAM-base's 12 heads of 64 and sam_huge's 16 of 80, global
    [2, 4096, 3C] and windowed [50, 196, 3C] ({"d64-global": entry, ...}),
    against its plain fp32 backward
    with TF32 off at cor_tpu's fp32 gradient tolerance; both errors against a
    float64 run printed; timed beside the plain version and SDPA's fp32
    backward with the materialised bias requiring grad."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos_bwd,
        vit_attention_relpos_bwd_plain,
        vit_attention_relpos_with_lse,
    )
    from cor_tpu_torch.tools.k6b_accuracy import k6b_float64

    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    tol = FP32_TOL["vit_attention_relpos_bwd"]
    res = {}
    for heads, D in ((12, 64), (16, 80)):
        C = heads * D
        for label, B, side in (("global", 2, GRID), ("windowed", 50, 14)):
            N = side * side
            qkv = rnd(B, N, 3 * C)
            rel_h, rel_w = 0.3 * rnd(B, heads, N, side), 0.3 * rnd(B, heads, N, side)
            do = rnd(B, N, C)
            args = (qkv, rel_h, rel_w, do, heads, (side, side))
            # the forward's out and lse, as autograd saves them
            out_fwd, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, (side, side))
            stats = dict(out=out_fwd, lse=lse)
            got = vit_attention_relpos_bwd(*args, **stats)
            want = vit_attention_relpos_bwd_plain(*args)
            exact = k6b_float64(qkv, rel_h, rel_w, do, heads, (side, side))
            vs64 = {"kernel": [(g.double() - e).abs().max().item() for g, e in zip(got, exact)],
                    "plain": [(w.double() - e).abs().max().item() for w, e in zip(want, exact)]}
            del exact
            print(f"  K6b fp32 d{D} {label}: max|d| against float64 (dqkv, drel_h, drel_w): "
                  f"kernel {vs64['kernel']}, plain {vs64['plain']}", flush=True)
            kt = cuda_ms(lambda: vit_attention_relpos_bwd(*args, **stats))
            pt = cuda_ms(lambda: vit_attention_relpos_bwd_plain(*args), windows=3, iters=2)
            with torch.enable_grad():  # SDPA's backward: autograd, the graph built once
                q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                           .detach().requires_grad_() for i in range(3))
                bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, heads, N, N)
                bias = bias.requires_grad_()
                o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
                do4 = do.unflatten(-1, (heads, D)).transpose(1, 2)
                lt = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v, bias), do4,
                                                         retain_graph=True), windows=5, iters=3)
                del o, bias, q, k, v
            # the five N x N x D products the gradient needs (the kernel runs
            # seven: the logits and do v^T again in the dk/dv pass), on the
            # inputs, the forward's out and lse, and the gradients
            flops = 5 * 2 * N * N * D * B * heads
            n_bytes = nbytes(qkv, rel_h, rel_w, do, out_fwd, lse) + nbytes(*got)
            b = bound32(n_bytes, flops)
            res[f"d{D}-{label}"] = check32(
                "K6b vit_attention_relpos_bwd", f"d{D} {label} [{B}, {N}, {3 * C}]", tol,
                list(zip(got, want)), kt, pt, b, lt, max_abs_err_vs_float64=vs64,
                bound_seven_products_ms=bound32(n_bytes, flops * 7 / 5)[0])
            del out_fwd, lse, stats
            del got, want
            torch.cuda.empty_cache()
    return res


@torch.no_grad()
def decoder_kernels_fp32(device, gen):
    """K1 (layer 0 out of a 2,048-row int8 store, layer 1 on fp32 rows), K2,
    K1 + K2 through the two-way transformer, and K3 in fp32 at 40 candidates
    of the SAM-base decoder."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail, decoder_tail_plain
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv, t2i_flash_kv_plain
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain

    n, N, C, I, T = CANDIDATES, GRID * GRID, SAM_C, 128, 6
    dec = init_mask_decoder(CoreConfig(), 1).to(device).eval()
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    tokens, kpe, qpe = rnd(n, T, C), 0.5 * rnd(N, I), 0.5 * rnd(N, I)
    store = torch.randint(-127, 128, (STORE_ROWS, N, C), generator=gen, device=device,
                          dtype=torch.int8)
    scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(STORE_ROWS, generator=gen, device=device))
    idx = torch.randperm(STORE_ROWS, generator=gen, device=device)[:n].to(torch.int32)
    keys = 0.5 * rnd(n, N, C)
    layer_flops = n * (2 * N * C * 3 * I + 2 * N * I * C + 4 * 2 * N * T * I + 2 * 8.6e6)
    w_bytes = sum(p.numel() * p.element_size() for p in dec.transformer.layers[0].parameters())
    out = {}

    tol = FP32_TOL["two_way_layer"]
    k1 = {}
    for label, lp, rows, kw, skip, rows_bytes in (
            ("layer 0, int8 store-indexed", dec.transformer.layers[0], store,
             dict(idx=idx, scale=scales), True, n * N * C + 8 * n),
            ("layer 1, fp32", dec.transformer.layers[1], keys, {}, False, nbytes(keys))):
        args = (lp, tokens, tokens, rows, kpe, qpe, skip)
        got_t, got_k = two_way_layer(*args, **kw)
        want_t, want_k = two_way_layer_plain(*args, **kw)
        kt = cuda_ms(lambda: two_way_layer(*args, **kw))
        pt = cuda_ms(lambda: two_way_layer_plain(*args, **kw), iters=3)
        b = bound32(rows_bytes + nbytes(tokens, kpe, qpe, got_t, got_k) + nbytes(tokens) + w_bytes,
                    layer_flops)
        k1[label] = check32("K1 two_way_layer", f"{label} [{n}, {N}, {C}]", tol,
                            [(got_t, want_t), (got_k, want_k)], kt, pt, b,
                            device_split_ms=k1_by_launch(f"{label} fp32", args, kw))
    out["two_way_layer@fp32"] = dict(k1["layer 0, int8 store-indexed"],
                                     layer1=k1["layer 1, fp32"])

    fa = dec.transformer.final_attn_t2i
    q_tok = rnd(n, T, I)
    args = (keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe, q_tok, 8)
    got, want = t2i_flash_kv(*args), t2i_flash_kv_plain(*args)
    kt, pt = cuda_ms(lambda: t2i_flash_kv(*args)), cuda_ms(lambda: t2i_flash_kv_plain(*args))
    dev_t = device_times(lambda: t2i_flash_kv(*args))
    b = bound32(nbytes(keys, kpe, q_tok, got) + 2 * I * C * 4,
                n * (2 * N * C * 2 * I + 4 * N * T * I))
    out["t2i_flash_kv@fp32"] = check32("K2 t2i_flash_kv", f"[{n}, {N}, {C}]",
                                       FP32_TOL["t2i_flash_kv"], [(got, want)], kt, pt, b,
                                       **dev_t)

    # K1 + K2 through the two-way transformer: layer 0 from the int8 store,
    # layer 1, the final attention's core, kernels against plain versions
    def chain(layer, t2i):
        lp0, lp1 = dec.transformer.layers
        t, k = layer(lp0, tokens, tokens, store, kpe, qpe, True, idx=idx, scale=scales)
        t, k = layer(lp1, t, tokens, k, kpe, qpe, False)
        a = t2i(k, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe,
                fa.q_proj(t + tokens), 8)
        return a, k

    got_a, got_k = chain(two_way_layer, t2i_flash_kv)
    want_a, want_k = chain(two_way_layer_plain, t2i_flash_kv_plain)
    tol = FP32_TOL["transformer"]
    err, ratio = tol_err(tol, (got_a, want_a), (got_k, want_k))
    print(f"  K1 + K2 through the two-way transformer fp32: max|d| = {err:.3e}, "
          f"max|d|/(tol + tol|plain|) = {ratio:.3f} (tol {tol:g})", flush=True)
    if not ratio <= 1.0:
        fail(f"K1 + K2 through the two-way transformer in fp32: {ratio} x its tolerance {tol}")
    out["two_way_layer@fp32"]["through_transformer"] = {"max_abs_err": err, "tol": tol,
                                                        "tol_ratio": ratio}

    up = dec.output_upscaling
    src = keys.reshape(n, GRID, GRID, C)
    hyper = rnd(n, 1, 32)
    args = (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b,
            hyper)
    got, want = decoder_tail(*args), decoder_tail_plain(*args)
    kt, pt = cuda_ms(lambda: decoder_tail(*args)), cuda_ms(lambda: decoder_tail_plain(*args))
    dev_t = device_times(lambda: decoder_tail(*args))
    b, term = k3_bound(src, hyper, got, torch.float32)
    out["decoder_tail@fp32"] = check32("K3 decoder_tail", f"[{n}, {GRID}, {GRID}, {C}] -> "
                                       f"{tuple(got.shape)}", FP32_TOL["decoder_tail"],
                                       [(got, want)], kt, pt, b, bound_term=term, **dev_t)
    del store
    torch.cuda.empty_cache()
    return out



FP32_BUILD_ROWS = 32  # candidates of the phase-30 build (4 encoded batches)
COS32_EMB, COS32_MASK = 0.9999, 0.999  # GPU fp32 against CPU fp32, same weights
FP32_STEP_LOSS, COS32_GRAD = 1e-4, 0.9999  # an fp32 train step, GPU against CPU


def phase_fp32_paths(root: Path):
    """Phase 30: the fp32 paths at full SAM-base + ViT-B-16-SigLIP-384 width
    through the entry points, with configs/vaild_config.yaml's and
    configs/train_config_m3.yaml's keys and compute_dtype: float32: the
    build, serving with masks, and cli.train frozen and unfrozen."""
    from cor_tpu_torch.config import load_eval_config

    cfg_path = flat_config("vaild_config.yaml", root / "fp32.yaml", compute_dtype="float32")
    ecfg = load_eval_config(cfg_path)
    if ecfg.core_config().compute_dtype != "float32":
        fail(f"the fp32 config reads as {ecfg.core_config().compute_dtype}")
    index_dir = root / "index"
    build_counts, build_s, idx = build_index(index_dir, FP32_BUILD_ROWS, cfg_path, sfx="@fp32")
    ids = set(idx["pair_ids"].tolist())
    servers, serve_counts = {}, {}
    for scan, extra in (("fp32", []), ("int8", ["--int8"])):
        servers[scan], serve_counts[scan], _ = serve_masks(
            index_dir, ids, root / f"masks_{scan}", f"fp32 compute, {scan} scan, --store-hbm",
            ["--store-hbm", *extra], cfg_path, sfx="@fp32")
    q_cos = phase_numerics(servers["fp32"], ecfg, phase=30, cos_min=COS32_EMB)
    enc32, cos_flat, cos_pool = phase_encoder_numerics(ecfg, phase=30, cos_min=COS32_EMB)
    m_cos = phase_decode_numerics(servers["fp32"], index_dir, rows=(0, 9, 17, 31), phase=30,
                                  cos_min=COS32_MASK)
    train_counts, train_res, _ = phase_train(root / "train", keys={"compute_dtype": "float32"},
                                             phase=30, sfx="@fp32")
    print(json.dumps({"fp32_paths": {
        "build": {"rows": FP32_BUILD_ROWS, "seconds": build_s,
                  "launches": {k: v for k, v in build_counts.items() if v}},
        "serve_launches": {k: {n: v for n, v in c.items() if v} for k, c in serve_counts.items()},
        "min_cosine_vs_cpu_fp32": {"queries": q_cos, "image_embeddings_flat": cos_flat,
                                   "image_embeddings_pooled": cos_pool, "mask_logits": m_cos},
        **{f"train_{mode}": {**train_res[mode],
                             "launches": {k: v for k, v in train_counts[mode].items() if v}}
           for mode in ("frozen", "unfrozen")},
    }}))
    print("phase 30 fp32 paths: ok", flush=True)
    return servers["fp32"], enc32, index_dir, ids, {
        "build": build_counts, "serve": serve_counts["fp32"], "train": train_counts["unfrozen"]}


def phase_fp32_timings(server32, enc32, index_dir: Path, ids: set, root: Path, smi: str):
    """Phase 31: fp32 beside bf16 in one run, on one index and the same
    weights: encode+scan at buckets 1, 4, 16, encode+scan+decode at 1 and 4
    (--store-hbm; the scan over phase 30's 32 rows), a batch-8 SAM-base
    encode (and with fused_window_indexing: K7's fp32 launches), a frozen
    and an unfrozen train step at batch 10 with their peak memory;
    CUDA-event medians of 7 windows (7 steps) with their spread; a
    torch.profiler breakdown of one served call at bucket 4 in each dtype
    and of one unfrozen fp32 step. Returns K7's fp32 launches."""
    import copy

    from cor_tpu_torch.config import TrainConfig, load_eval_config
    from cor_tpu_torch.models.core_model import _cast
    from cor_tpu_torch.retrieval.index import make_candidate_encoder

    server16, _, _ = serve_masks(index_dir, ids, root / "masks_bf16",
                                 "bf16 compute beside fp32, fp32 scan, --store-hbm",
                                 ["--store-hbm"])
    servers = {"bf16": server16, "fp32": server32}
    assembled = [server32._synthetic_query(i) for i in range(16)]
    span = lambda t: {"ms": t[0], "min_ms": t[1], "max_ms": t[2]}  # noqa: E731
    out = {"encode_scan_ms_by_bucket": {}, "encode_scan_decode_ms_by_bucket": {}}
    for b in (1, 4, 16):
        for dt, srv in servers.items():
            tensors = srv._batch_tensors(assembled[:b])
            out["encode_scan_ms_by_bucket"].setdefault(str(b), {})[dt] = span(
                cuda_ms(lambda: srv.encode_and_scan(*tensors), windows=7, iters=3))
            if b <= 4:
                out["encode_scan_decode_ms_by_bucket"].setdefault(str(b), {})[dt] = span(
                    cuda_ms(lambda: srv.encode_scan_decode(*tensors, b), windows=7, iters=3))
    profiles = {}
    for dt, srv in servers.items():
        tensors = srv._batch_tensors(assembled[:4])
        profiles[dt] = profile(lambda: srv.encode_scan_decode(*tensors, 4), 3)
    del server16, servers

    # the batch-8 SAM-base encode, the filled encoder of phase 30 in both
    # dtypes, timed in turns; then fp32 with fused_window_indexing (K7)
    cfg32 = load_eval_config(flat_config("vaild_config.yaml", root / "fp32.yaml",
                                         compute_dtype="float32")).core_config()
    cfg16 = dataclasses.replace(cfg32, compute_dtype="bfloat16")
    enc16 = _cast(copy.deepcopy(enc32), torch.bfloat16)
    b = synthetic_batch(SAM_BATCH, cfg32)
    imgs, masks = (torch.from_numpy(b[k]).cuda() for k in ("query_img", "query_mask"))
    runs = {"bf16": lambda: make_candidate_encoder(cfg16)(enc16, imgs, masks),
            "fp32": lambda: make_candidate_encoder(cfg32)(enc32, imgs, masks)}
    # in turns (bf16, fp32, fp32, bf16), 7 windows each: the median of the
    # two turns' medians and the spread of all 14 windows
    times = {"bf16": [], "fp32": []}
    for dt in ("bf16", "fp32", "fp32", "bf16"):
        times[dt].append(cuda_ms(runs[dt], windows=7, iters=1))
    encode = {dt: {"ms": statistics.median(t[0] for t in ts), "min_ms": min(t[1] for t in ts),
                   "max_ms": max(t[2] for t in ts)} for dt, ts in times.items()}
    del enc16
    enc_cfg = cfg32.encoder
    fcfg = dataclasses.replace(cfg32, encoder_override=dataclasses.replace(
        enc_cfg, fused_window_indexing=True))
    enc_flag = filled_encoder(fcfg).cuda().eval()
    reset_counts()
    _, emb_flag = make_candidate_encoder(fcfg)(enc_flag, imgs, masks)
    torch.cuda.synchronize()
    k7 = read_counts()
    windowed = enc_cfg.depth - len(enc_cfg.global_attn_indexes)
    want = {k: 0 for k in k7}
    want.update({"layer_norm@fp32": 2 * enc_cfg.depth + 2,
                 "vit_attention_relpos@fp32": len(enc_cfg.global_attn_indexes),
                 "vit_attention_relpos_windows@fp32": windowed})
    _, emb_plain = make_candidate_encoder(cfg32)(enc32, imgs, masks)
    cos = torch.nn.functional.cosine_similarity(emb_flag.flatten()[None].double(),
                                                emb_plain.flatten()[None].double()).item()
    print(f"  fp32 encoder with fused_window_indexing: launches {k7} (expected {want}), "
          f"cosine {cos:.6f} to the unflagged one")
    if k7 != want or not cos >= COS32_EMB:
        fail(f"fp32 flagged encoder: launches {k7} != {want}, or cosine {cos} < {COS32_EMB}")
    encode["fp32, fused_window_indexing"] = span(cuda_ms(
        lambda: make_candidate_encoder(fcfg)(enc_flag, imgs, masks), windows=4, iters=1))
    del enc_flag, emb_flag, emb_plain
    torch.cuda.empty_cache()

    batch = train_batch()
    steps = {"frozen": {}, "unfrozen": {}}
    for mode, freeze in (("frozen", True), ("unfrozen", False)):
        for dt in ("bfloat16", "float32"):
            steps[mode][dt] = step_timings(
                dataclasses.replace(TrainConfig(), freeze_towers=freeze, compute_dtype=dt),
                batch, steps=7, with_profile=not freeze and dt == "float32")
    step_prof = steps["unfrozen"]["float32"].pop("profile")
    print(json.dumps({"fp32_timings": {
        **out, "encode_batch8_ms": encode, "frozen_train_step": steps["frozen"],
        "unfrozen_train_step": steps["unfrozen"], "batch": TrainConfig().batch_size,
        "index_rows": FP32_BUILD_ROWS, "k": 10, "card": smi}}))
    for dt, prof in profiles.items():
        print(json.dumps({"served_call_profile": {"dtype": dt, "bucket": 4, **prof,
                                                  "card": smi}}))
    print(json.dumps({"unfrozen_fp32_step_profile": {"batch": TrainConfig().batch_size,
                                                     **step_prof, "card": smi}}))
    print("phase 31 fp32 timings: ok", flush=True)
    return k7


# ---------------------------------------------------------------------------
# SAM's stock prompts: phases 33-34
# ---------------------------------------------------------------------------

K1_TOKENS = (5, 7, 8)  # K1 beside phase 3's 6: a mask or no prompt, 1 or 2 points, a box
K2_TOKENS = (5, 7, 8, 9, 16, 32)
K8_TOKENS = (9, 11, 16, 32)  # 3 points; a box and 4 points; 10 points; 26 points
K8_ROW_TOKENS = 16  # the kernels line's K8a/K8b row (phase 34's profile)
# the tolerances of phase 33 in fp32 (cor_tpu's: K8b tests/test_pallas_kernels.py:119)
FP32_TOL.update({"proj_q_t2i_flash": 5e-4, "i2t_attention_fused": 2e-4})
TOKEN_MACS = 8.6e6 / 6  # the token side of a two-way layer, per token and candidate


def token_check(name, label, dt, pairs, kt, pt, b, tol, **extra):
    """bf16: max |kernel - plain| / max |plain| <= DECODE_REL; fp32: check32
    at ``tol``. Returns the entry (with ``extra``, e.g. ``device_ms``)."""
    if dt == torch.float32:
        return check32(name, label, tol, pairs, kt, pt, b, **extra)
    err = max(rel_err(g, w) for g, w in pairs)
    dev = "" if "device_ms" not in extra else f"; graph replays {extra['device_ms']:.4f} ms"
    print(f"  {name} {label}: max|d|/max|plain| = {err:.3e}; kernel {kt[0]:.4f} ms "
          f"[{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})"
          f"{dev}", flush=True)
    if not err <= DECODE_REL:
        fail(f"{name} ({label}) disagrees with its plain version: {err}")
    return entry(abs_err(*pairs), kt, pt, b, max_rel_err=err, **extra)


@torch.no_grad()
def phase_token_kernels(device):
    """Phase 33: K1 at 5, 7 and 8 tokens (layer 0 from the 2,048-row int8
    store, layer 1 on rows), K2 at 5 to 32, K8a and K8b at 9, 11, 16 and 32,
    each against its plain version at 40 candidates on the 64 x 64 grid, in
    bf16 and in fp32 (TF32 off), timed beside the plain version and the
    bound; K8a and K8b also as CUDA-graph replays (``device_ms``: the
    device's time, the host's launches left out). Returns the kernels line's
    entries."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.i2t_attention import (
        i2t_attention_fused,
        i2t_attention_fused_plain,
    )
    from cor_tpu_torch.ops.kernels.t2i_flash import (
        proj_q_t2i_flash,
        proj_q_t2i_flash_plain,
        t2i_flash_kv,
        t2i_flash_kv_plain,
    )
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_plain

    t0 = time.perf_counter()
    n, N, C, I = CANDIDATES, GRID * GRID, SAM_C, 128
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    store = torch.randint(-127, 128, (STORE_ROWS, N, C), generator=gen, device=device,
                          dtype=torch.int8)
    scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(STORE_ROWS, generator=gen, device=device))
    idx = torch.randperm(STORE_ROWS, generator=gen, device=device)[:n].to(torch.int32)
    out = {}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32")):
        bnd = bound if dt == torch.bfloat16 else bound32
        el = torch.finfo(dt).bits // 8
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device).to(dt)  # noqa: E731
        keys, kpe, qpe = 0.5 * rnd(n, N, C), 0.5 * rnd(N, I), 0.5 * rnd(N, I)
        lp0, lp1 = dec.transformer.layers
        w_bytes = sum(p.numel() * p.element_size() for p in lp0.parameters())
        k1, k2, k8a, k8b = {}, {}, {}, {}
        for T in K1_TOKENS:
            tokens = rnd(n, T, C)
            flops = n * (2 * N * C * 3 * I + 2 * N * I * C + 4 * 2 * N * T * I +
                         2 * TOKEN_MACS * T)
            for label, lp, rows, kw, skip, rows_bytes in (
                    ("layer 0, int8 store-indexed", lp0, store, dict(idx=idx, scale=scales),
                     True, n * N * C + 8 * n),
                    ("layer 1, rows", lp1, keys, {}, False, nbytes(keys))):
                args = (lp, tokens, tokens, rows, kpe, qpe, skip)
                got, want = two_way_layer(*args, **kw), two_way_layer_plain(*args, **kw)
                kt = cuda_ms(lambda: two_way_layer(*args, **kw))
                pt = cuda_ms(lambda: two_way_layer_plain(*args, **kw), iters=3)
                b = bnd(rows_bytes + nbytes(tokens, kpe, qpe, *got) + nbytes(tokens) + w_bytes,
                        flops)
                k1[f"T{T} {label}"] = token_check(
                    "K1 two_way_layer", f"T {T} {label} [{n}, {N}, {C}]", dt,
                    list(zip(got, want)), kt, pt, b, FP32_TOL["two_way_layer"])
        fa = dec.transformer.final_attn_t2i
        for T in K2_TOKENS:
            q_tok = rnd(n, T, I)
            args = (keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe, q_tok, 8)
            got, want = t2i_flash_kv(*args), t2i_flash_kv_plain(*args)
            kt, pt = cuda_ms(lambda: t2i_flash_kv(*args)), cuda_ms(lambda: t2i_flash_kv_plain(*args))
            b = bnd(nbytes(keys, kpe, q_tok, got) + 2 * I * C * el,
                    n * (2 * N * C * 2 * I + 4 * N * T * I))
            k2[f"T{T}"] = token_check("K2 t2i_flash_kv", f"T {T} [{n}, {N}, {C}]", dt,
                                      [(got, want)], kt, pt, b, FP32_TOL["t2i_flash_kv"])
        t2i, i2t = lp1.cross_attn_t2i, lp1.cross_attn_i2t
        for T in K8_TOKENS:
            q_tok = rnd(n, T, I)
            args = (keys, t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b, i2t.q_proj.w,
                    i2t.q_proj.b, kpe, qpe, q_tok, 8)
            got, want = proj_q_t2i_flash(*args), proj_q_t2i_flash_plain(*args)
            kt = cuda_ms(lambda: proj_q_t2i_flash(*args))
            pt = cuda_ms(lambda: proj_q_t2i_flash_plain(*args), iters=3)
            b = bnd(nbytes(keys, kpe, qpe, q_tok, *got) + 3 * I * C * el,
                    n * (2 * N * C * 3 * I + 4 * N * T * I))
            k8a[f"T{T}"] = token_check("K8a proj_q_t2i_flash", f"T {T} [{n}, {N}, {C}]", dt,
                                       list(zip(got, want)), kt, pt, b,
                                       FP32_TOL["proj_q_t2i_flash"],
                                       **device_times(lambda: proj_q_t2i_flash(*args)))
            q_img, k_tok, v_tok = 0.5 * rnd(n, N, I), rnd(n, T, I), rnd(n, T, I)
            args = (q_img, keys, k_tok, v_tok, i2t.out_proj.w, i2t.out_proj.b, lp1.norm4.scale,
                    lp1.norm4.bias, 8)
            got, want = i2t_attention_fused(*args), i2t_attention_fused_plain(*args)
            kt = cuda_ms(lambda: i2t_attention_fused(*args))
            pt = cuda_ms(lambda: i2t_attention_fused_plain(*args), iters=3)
            b = bnd(nbytes(q_img, keys, k_tok, v_tok, got) + I * C * el,
                    n * (4 * N * T * I + 2 * N * I * C))
            k8b[f"T{T}"] = token_check("K8b i2t_attention_fused", f"T {T} [{n}, {N}, {C}]",
                                       dt, [(got, want)], kt, pt, b,
                                       FP32_TOL["i2t_attention_fused"],
                                       **device_times(lambda: i2t_attention_fused(*args)))
        row = f"T{K8_ROW_TOKENS}"
        out[f"proj_q_t2i_flash{sfx}"] = dict(k8a[row], at_tokens=k8a)
        out[f"i2t_attention_fused{sfx}"] = dict(k8b[row], at_tokens=k8b)
        out[f"two_way_layer{sfx} at_tokens"], out[f"t2i_flash_kv{sfx} at_tokens"] = k1, k2
        del dec, keys
    del store
    torch.cuda.empty_cache()
    print(f"phase 33 kernels at 5 to 32 tokens: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out


# phase 34's prompt sets per image: (label, points, box, mask prompt); points
# alone get a pad point, so T = 5 + points + 1, with a box 5 + points + 2
PROMPT_SETS = (("a mask", 0, False, True), ("1 point", 1, False, False),
               ("a box", 0, True, False), ("2 points", 2, False, False),
               ("3 points", 3, False, False), ("a box and 4 points", 4, True, False),
               ("10 points", 10, False, False), ("26 points", 26, False, False),
               ("1 point + mask", 1, False, True), ("a box + mask", 0, True, True),
               ("2 points + mask", 2, False, True), ("3 points + mask", 3, False, True),
               ("a box and 4 points + mask", 4, True, True))
COS32_PROMPT = 0.999999  # GPU fp32 against CPU fp32 mask logits, the same weights and inputs
DECODE_TOL32 = 1e-4  # cor_tpu's fused-decoder tolerance (tests/test_pallas_kernels.py:72)
IOU_TOL = 2e-2  # predicted IoU, GPU bf16 against CPU fp32, relative to max(1, |IoU|)
DECODE_TIMING_TOKENS = (6, 8, 9, 16, 32)


def prompt_tokens(points: int, box: bool) -> int:
    return 5 + points + (2 if box else (1 if points else 0))


def route_launches(T: int) -> dict:
    """Each decoder wrapper's launches in one fused decode of T tokens."""
    from cor_tpu_torch.ops.kernels.t2i_flash import FINAL_LAUNCHES as k2
    from cor_tpu_torch.ops.kernels.t2i_flash import LAUNCHES as k8a

    if T <= 8:
        return {"two_way_layer": 8, "t2i_flash_kv": k2, "decoder_tail": 1,
                "proj_q_t2i_flash": 0, "i2t_attention_fused": 0}
    return {"two_way_layer": 0, "t2i_flash_kv": k2, "decoder_tail": 1,
            "proj_q_t2i_flash": 2 * k8a, "i2t_attention_fused": 2}


@torch.no_grad()
def phase_prompts(smi: str):
    """Phase 34: SAM's stock prompts at full width. The SAM-base encoder
    (full depth, tables and pos_embed filled) embeds 2 query images; the full
    prompt encoder (random weights from a seed) encodes PROMPT_SETS for each;
    mask_decoder(fused=True, multimask) decodes them on the card in bf16 and
    in fp32 and on the CPU in fp32 with the same weights; one store-indexed
    decode at 9 tokens from an int8 store; launch counts per call; decode
    timings at batch 8 and a profile at 16 tokens. Returns the launches of
    the prompt path, by wrapper."""
    import copy

    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import _cast, init_mask_decoder
    from cor_tpu_torch.models.prompt_encoder import (
        PromptEncoderConfig,
        dense_positional_encoding,
        full_prompt_encoder,
        init_full_prompt_encoder,
    )
    from cor_tpu_torch.models.sam_decoder import mask_decoder
    from cor_tpu_torch.retrieval.engine import quantize_candidate_store_host
    from cor_tpu_torch.retrieval.index import make_candidate_encoder

    cfg = EvalConfig().core_config()
    enc = _cast(filled_encoder(cfg).eval().cuda(), cfg.dtype)
    b = synthetic_batch(2, cfg)
    _, emb = make_candidate_encoder(cfg)(enc, torch.from_numpy(b["query_img"]).cuda(),
                                         torch.from_numpy(b["query_mask"]).cuda())
    emb = emb.float()
    del enc
    if emb.shape != (2, GRID, GRID, SAM_C) or not torch.isfinite(emb).all():
        fail(f"the query images' embeddings are malformed: {tuple(emb.shape)}")
    pcfg = PromptEncoderConfig()
    penc = init_full_prompt_encoder(pcfg, SEED + 5)
    dec32 = init_mask_decoder(cfg, SEED + 1).eval()
    decs = {"cpu": dec32, "fp32": copy.deepcopy(dec32).cuda(),
            "bf16": copy.deepcopy(dec32).to("cuda", torch.bfloat16)}
    pe = dense_positional_encoding(penc.pe_layer.gaussian_matrix, pcfg.image_embedding_size)
    rng = np.random.default_rng(SEED + 6)
    size = pcfg.input_image_size[0]

    def prompt_args(points: int, box: bool, mask: bool) -> dict:
        kw = {}
        if points:
            coords = rng.uniform(0, size, (2, points, 2)).astype(np.float32)
            labels = (rng.random((2, points)) < 0.7).astype(np.int64)  # mostly positive
            kw["points"] = (torch.from_numpy(coords), torch.from_numpy(labels))
        if box:
            lo = rng.uniform(0, size / 2, (2, 2))
            kw["boxes"] = torch.from_numpy(np.concatenate(
                [lo, lo + rng.uniform(64, size / 2, (2, 2))], 1).astype(np.float32))
        if mask:
            kw["masks"] = torch.from_numpy(rng.standard_normal(
                (2, 4 * GRID, 4 * GRID, 1)).astype(np.float32))
        return kw

    def decode(where: str, sparse, dense, img, **store):
        dt = torch.bfloat16 if where == "bf16" else torch.float32
        dev = "cpu" if where == "cpu" else "cuda"
        cast = lambda x: None if x is None else x.to(dev, dt)  # noqa: E731
        masks, iou, _ = mask_decoder(decs[where], img.to(dev) if store else cast(img),
                                     cast(pe), cast(sparse), cast(dense), True, **store)
        return masks.float().cpu(), iou.float().cpu()

    penc_gpu = copy.deepcopy(penc).cuda()
    totals = {k: 0 for k in read_counts()}
    results = []
    for label, points, box, mask in PROMPT_SETS:
        T = prompt_tokens(points, box)
        kw = prompt_args(points, box, mask)
        sparse, dense = full_prompt_encoder(penc, pcfg, batch=2, **kw)
        sparse_g, dense_g = full_prompt_encoder(
            penc_gpu, pcfg, batch=2, **{k: tuple(x.cuda() for x in v) if k == "points"
                                        else v.cuda() for k, v in kw.items()})
        pe_err = max(rel_err(sparse_g.cpu(), sparse) if points or box else 0.0,
                     rel_err(dense_g.cpu(), dense))
        if sparse.shape != (2, T - 5, SAM_C) or pe_err > 1e-5:
            fail(f"prompt {label}: sparse {tuple(sparse.shape)} for {T} tokens, the card's "
                 f"prompt encoder off the CPU's by {pe_err}")
        want_m, want_iou = decode("cpu", sparse, dense, emb.cpu())
        got = {}
        for where in ("bf16", "fp32"):
            reset_counts()
            got[where] = decode(where, sparse_g, dense_g, emb)
            torch.cuda.synchronize()
            c = read_counts()
            want_c = {k + ("@fp32" if where == "fp32" else ""): v
                      for k, v in route_launches(T).items()}
            if {k: c[k] for k in want_c} != want_c or sum(c.values()) != sum(want_c.values()):
                fail(f"prompt {label} ({T} tokens, {where}): launches {c}, expected {want_c}")
            for k, v in c.items():
                totals[k] += v
        cos = {w: torch.nn.functional.cosine_similarity(
            got[w][0].flatten(1), want_m.flatten(1)).min().item() for w in got}
        scale = want_m.abs().max().item()
        err32 = (got["fp32"][0] - want_m).abs().max().item() / scale
        iou_err = (got["bf16"][1] - want_iou).abs().max().item() / max(
            1.0, want_iou.abs().max().item())
        fg = {w: ((got[w][0] > 0) & (want_m > 0)).sum().item() /
              max(1, ((got[w][0] > 0) | (want_m > 0)).sum().item()) for w in got}
        results.append({"prompt": label, "tokens": T, "route": "K1" if T <= 8 else "K8a/K8b",
                        "cos_bf16": cos["bf16"], "cos_fp32": cos["fp32"],
                        "max_err_fp32_over_scale": err32, "iou_err_bf16": iou_err,
                        "mask_iou_bf16": fg["bf16"], "mask_iou_fp32": fg["fp32"]})
        print(f"  prompt {label} ({T} tokens, {results[-1]['route']}): mask-logit cosine to "
              f"the CPU's fp32 bf16 {cos['bf16']:.6f}, fp32 {cos['fp32']:.8f}; fp32 max|d| / "
              f"max|logit| {err32:.3e} (cor_tpu's decoder tolerance {DECODE_TOL32:g}); "
              f"predicted IoU bf16 |d| {iou_err:.3e}; binarised-mask IoU bf16 {fg['bf16']:.4f}, "
              f"fp32 {fg['fp32']:.6f}", flush=True)
        if not all(torch.isfinite(g[0]).all() and g[0].shape == (2, 3, 4 * GRID, 4 * GRID)
                   for g in got.values()):
            fail(f"prompt {label}: masks malformed")
        if cos["bf16"] < COS_MIN or cos["fp32"] < COS32_PROMPT or iou_err > IOU_TOL:
            fail(f"prompt {label}: the card's decode disagrees with the CPU's: {results[-1]}")

    # a store-indexed decode at 9 tokens: the int8 store's rows gathered and
    # dequantised in torch, then K8a/K8b
    no_mask = penc.no_mask_embed[0].numpy()
    rows = np.concatenate([emb.cpu().numpy(), rng.standard_normal((2, GRID, GRID, SAM_C))
                           .astype(np.float32)]).astype(np.float16)
    q, s = (torch.from_numpy(a) for a in quantize_candidate_store_host(rows, no_mask))
    sidx = torch.tensor([1, 0, 3], dtype=torch.int32)
    kw = prompt_args(3, False, False)
    kw["points"] = tuple(torch.cat([x, x[:1]]) for x in kw["points"])
    sparse, _ = full_prompt_encoder(penc, pcfg, **kw)
    want_m, _ = decode("cpu", sparse, None, q, store_idx=sidx, store_scale=s)
    reset_counts()
    got_m, _ = decode("bf16", sparse, None, q.cuda(), store_idx=sidx.cuda(),
                      store_scale=s.cuda())
    torch.cuda.synchronize()
    c = read_counts()
    for k, v in c.items():
        totals[k] += v
    cos_store = torch.nn.functional.cosine_similarity(got_m.flatten(1),
                                                      want_m.flatten(1)).min().item()
    print(f"  store-indexed decode, 9 tokens, int8 store (3 of 4 rows): cosine to the CPU's "
          f"fp32 {cos_store:.6f}; launches {({k: v for k, v in c.items() if v})}", flush=True)
    if {k: c[k] for k in route_launches(9)} != route_launches(9) or cos_store < COS_MIN:
        fail(f"store-indexed decode at 9 tokens: launches {c}, cosine {cos_store}")

    # timings: one fused decode of a batch of 8 (candidates of one image
    # embedding each) at T tokens, bf16 and fp32; a profile at 16 tokens
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    timings = {}
    for where, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        img8 = (0.5 * torch.randn(8, GRID, GRID, SAM_C, generator=gen, device="cuda")).to(dt)
        dense8 = (0.1 * torch.randn(8, GRID, GRID, SAM_C, generator=gen, device="cuda")).to(dt)
        pe8 = pe.to("cuda", dt)
        for T in DECODE_TIMING_TOKENS:
            sp = torch.randn(8, T - 5, SAM_C, generator=gen, device="cuda").to(dt)
            call = lambda sp=sp: mask_decoder(decs[where], img8, pe8, sp, dense8, True)  # noqa: E731
            timings[f"{where} T{T}"] = dict(zip(("ms", "min_ms", "max_ms"), cuda_ms(call, iters=5)))
            if where == "bf16" and T == K8_ROW_TOKENS:
                prof = profile(call, 3)
    print(json.dumps({"prompt_decode_timings": {"batch": 8, "ms": timings, "card": smi}}))
    print(json.dumps({"prompt_decode_profile": {"batch": 8, "tokens": K8_ROW_TOKENS, **prof,
                                                "card": smi}}))
    print(json.dumps({"prompt_numerics": results + [{"prompt": "3 points, int8 store",
                                                     "tokens": 9, "cos_bf16": cos_store}]}))
    print("phase 34 SAM's stock prompts: ok", flush=True)
    return totals


# ---------------------------------------------------------------------------
# the opt-in decode schedules: phases 35-36
# ---------------------------------------------------------------------------

SCHEDULE_TOKENS = (5, 6, 8)  # a mask or no prompt; the served decode; a box or 2 points
SCHEDULE_STORE = 256  # phase 35's store rows (40 of them read through idx)
SCHEDULE_ROW_TOKENS = 6  # the kernels line's rows: the served decode's token count


def schedule_launches(variant: str, int8: bool = False) -> dict:
    """The decoder wrappers' launches in one fused decode at 5 to 8 tokens
    under ``variant``'s flag (an int8 store sends grid and stack to K1)."""
    if variant in ("stack", "grid") and not int8:
        return {f"two_way_{variant}_fused": 1, "decoder_tail": 1}
    from cor_tpu_torch.ops.kernels.t2i_flash import FINAL_LAUNCHES

    layer = "two_way_layer_dma" if variant == "dma" else "two_way_layer"
    return {layer: 8, "t2i_flash_kv": FINAL_LAUNCHES, "decoder_tail": 1}


@torch.no_grad()
def phase_decode_schedules(device, smi: str):
    """Phase 35: K1-dma, K1-stack and K1-grid at 40 candidates on the 64 x 64
    grid, 5, 6 and 8 tokens, bf16 and fp32 (TF32 off): K1-dma against K1
    bit for bit (rows, a store through idx, an int8 store); K1-stack and
    K1-grid against their plain version (bf16 max relative error <= 2e-2,
    fp32 cor_tpu's transformer tolerance 5e-4), with and without a store
    index, and K1-grid's keys against two K1 launches bit for bit; each timed
    beside its plain version and the bound. Then the launches of one fused
    decode per schedule (an int8 store with GRID_FUSED goes to K1) and the
    decode's ms at batch 8, in bf16 and fp32. Returns the kernels line's
    entries and the decodes' launches by wrapper (the fp32 kernels' path)."""
    from cor_tpu_torch.models import sam_decoder as sd
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.two_way_layer import (
        two_way_layer,
        two_way_layer_dma,
        two_way_layer_plain,
    )
    from cor_tpu_torch.ops.kernels.two_way_stack import (
        launch_team,
        two_way_grid_fused,
        two_way_stack_fused,
        two_way_stack_plain,
    )
    from cor_tpu_torch.tools.decode_bench import VARIANTS

    t0 = time.perf_counter()
    n, N, C, I = CANDIDATES, GRID * GRID, SAM_C, 128
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    out = {}
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32")):
        bnd = bound if dt == torch.bfloat16 else bound32
        el = torch.finfo(dt).bits // 8
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        p = dec.transformer
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device).to(dt)  # noqa: E731
        keys = 0.5 * rnd(n, N, C)
        store = 0.5 * rnd(SCHEDULE_STORE, N, C)
        f = store.float()
        scales = (f.abs().amax(dim=(1, 2)) / 127.0).clamp_min(1e-12)
        store8 = torch.clamp(torch.round(f / scales[:, None, None]), -127, 127).to(torch.int8)
        del f
        idx = torch.randperm(SCHEDULE_STORE, generator=gen, device=device)[:n].to(torch.int32)
        kpe, qpe = [0.5 * rnd(N, I) for _ in range(2)], [0.5 * rnd(N, I) for _ in range(2)]
        kpe_f = 0.5 * rnd(N, I)
        w_layer = sum(nbytes(*lp.parameters()) for lp in p.layers[:1])
        w_all = nbytes(*p.parameters())
        dma, stack, grid = {}, {}, {}
        for T in SCHEDULE_TOKENS:
            tokens = rnd(n, T, C)
            layer_flops = n * (2 * N * C * 3 * I + 2 * N * I * C + 4 * 2 * N * T * I +
                               2 * TOKEN_MACS * T)
            for label, rows, kw, rows_bytes in (
                    ("int8 store-indexed", store8, dict(idx=idx, scale=scales), n * N * C + 8 * n),
                    ("store-indexed", store, dict(idx=idx), n * N * C * el + 4 * n),
                    ("rows", keys, {}, nbytes(keys))):
                args = (p.layers[0], tokens, tokens, rows, kpe[0], qpe[0], True)
                got, want = two_way_layer_dma(*args, **kw), two_way_layer(*args, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    fail(f"K1-dma ({label}, {T} tokens, {dt}) differs from K1")
                plain = two_way_layer_plain(*args, **kw)
                kt = cuda_ms(lambda: two_way_layer_dma(*args, **kw))
                k1t = cuda_ms(lambda: two_way_layer(*args, **kw))
                pt = cuda_ms(lambda: two_way_layer_plain(*args, **kw), windows=3, iters=3)
                b = bnd(rows_bytes + nbytes(tokens, kpe[0], qpe[0], *got) + nbytes(tokens) +
                        w_layer, layer_flops)
                e = token_check("K1-dma two_way_layer_dma", f"T {T} {label} [{n}, {N}, {C}]", dt,
                                list(zip(got, plain)), kt, pt, b, FP32_TOL["two_way_layer"])
                e.update(bits_equal_to_k1=True, k1_ms=k1t[0], k1_ms_min=k1t[1], k1_ms_max=k1t[2])
                print(f"    K1-dma == K1 bit for bit; K1 {k1t[0]:.4f} ms [{k1t[1]:.4f}, "
                      f"{k1t[2]:.4f}] in the same call", flush=True)
                dma[f"T{T} {label}"] = e
            fused_flops = 2 * layer_flops + n * (2 * N * C * 2 * I + 4 * N * T * I +
                                                 2 * (I * C + C * I) * T)
            for label, rows, kw, rows_bytes in (
                    ("store-indexed", store, dict(idx=idx), n * N * C * el + 4 * n),
                    ("rows", keys, {}, nbytes(keys))):
                args = (p, tokens, tokens, rows, kpe, qpe, kpe_f)
                b = bnd(rows_bytes + nbytes(tokens, *kpe, *qpe, kpe_f) + n * N * C * el +
                        nbytes(tokens) + w_all, fused_flops)
                for name, fn, res in (("stack", two_way_stack_fused, stack),
                                      ("grid", two_way_grid_fused, grid)):
                    got = fn(*args, **kw)
                    want = two_way_stack_plain(*args, **kw, round_between_layers=name == "grid")
                    torch.cuda.synchronize()
                    kt = cuda_ms(lambda: fn(*args, **kw))
                    pt = cuda_ms(lambda: two_way_stack_plain(
                        *args, **kw, round_between_layers=name == "grid"), windows=3, iters=3)
                    e = token_check(f"K1-{name} two_way_{name}_fused",
                                    f"T {T} {label} [{n}, {N}, {C}]", dt, list(zip(got, want)),
                                    kt, pt, b, FP32_TOL["transformer"])
                    # the CTAs of a candidate's token stages, and of the grid
                    e["team_ctas"], e["grid_ctas"] = launch_team(fn, n, T, N, dt)
                    if name == "grid":
                        t1, k1 = two_way_layer(p.layers[0], tokens, tokens, rows, kpe[0], qpe[0],
                                               True, idx=kw.get("idx"))
                        _, k2 = two_way_layer(p.layers[1], t1, tokens, k1, kpe[1], qpe[1], False)
                        torch.cuda.synchronize()
                        if not torch.equal(got[1], k2):
                            fail(f"K1-grid's keys ({label}, {T} tokens, {dt}) differ from two "
                                 f"K1 launches'")
                        e["keys_bits_equal_to_two_k1"] = True
                        print("    K1-grid's keys == two K1 launches' bit for bit", flush=True)
                    res[f"T{T} {label}"] = e
        row = f"T{SCHEDULE_ROW_TOKENS}"
        out[f"two_way_layer_dma{sfx}"] = dict(dma[f"{row} int8 store-indexed"], at_tokens=dma)
        out[f"two_way_stack_fused{sfx}"] = dict(stack[f"{row} store-indexed"], at_tokens=stack)
        out[f"two_way_grid_fused{sfx}"] = dict(grid[f"{row} store-indexed"], at_tokens=grid)
        del keys, store, store8
        torch.cuda.empty_cache()

    # one fused decode of 8 per schedule, bf16 and fp32: its launches (the
    # fp32 instantiations' path) and ms; a profile of K1-grid's in bf16
    flags = {f: getattr(sd, f) for f in ("GRID_FUSED", "STACK_FUSED", "DMA_FUSED")}
    totals = {k: 0 for k in read_counts()}
    decodes = {}
    try:
        for dt, where in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            sfx = "@fp32" if dt == torch.float32 else ""
            dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
            rnd = lambda *s: torch.randn(*s, generator=gen, device=device).to(dt)  # noqa: E731
            img8, dense8 = 0.5 * rnd(8, GRID, GRID, C), 0.1 * rnd(8, GRID, GRID, C)
            pe8, sparse = rnd(1, GRID, GRID, C), rnd(8, 1, C)
            q8 = torch.randint(-127, 128, (16, GRID, GRID, C), generator=gen, device=device,
                               dtype=torch.int8)
            sc8 = torch.full((16,), 0.02, device=device)
            idx8 = torch.arange(8, dtype=torch.int32, device=device) * 2
            decodes[where] = {}
            for variant, names in VARIANTS.items():
                for f in flags:
                    setattr(sd, f, f in names)
                call = lambda: sd.mask_decoder(dec, img8, pe8, sparse, dense8, False)  # noqa: E731
                for int8 in (False, True):
                    reset_counts()
                    if int8:
                        m, _, _ = sd.mask_decoder(dec, q8, pe8, sparse, None, False,
                                                  store_idx=idx8, store_scale=sc8)
                    else:
                        m, _, _ = call()
                    torch.cuda.synchronize()
                    c = read_counts()
                    for k, v in c.items():
                        totals[k] += v
                    c = {k: v for k, v in c.items() if v}
                    want = {k + sfx: v for k, v in schedule_launches(variant, int8).items()}
                    if c != want or not torch.isfinite(m.float()).all():
                        fail(f"a {where} {variant} decode"
                             f"{' from an int8 store' if int8 else ''}: launches {c}, "
                             f"expected {want}")
                ms = cuda_ms(call, iters=5)
                want = schedule_launches(variant)
                decodes[where][variant] = {"launches": sum(want.values()), "ms": ms[0],
                                           "min_ms": ms[1], "max_ms": ms[2]}
                print(f"  {where} decode of 8 at 6 tokens, {variant}: {sum(want.values())} "
                      f"decoder launches ({want}); {ms[0]:.4f} ms [{ms[1]:.4f}, {ms[2]:.4f}]",
                      flush=True)
                if variant == "grid" and where == "bf16":
                    prof = profile(call, 3)
            del dec
    finally:
        for f, v in flags.items():
            setattr(sd, f, v)
    print(json.dumps({"schedule_decode_timings": {"batch": 8, "tokens": 6, "ms": decodes,
                                                  "card": smi}}))
    print(json.dumps({"schedule_decode_profile": {"batch": 8, "tokens": 6, "variant": "grid",
                                                  **prof, "card": smi}}))
    print(f"phase 35 the decode schedules' kernels: ok in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return out, totals


def phase_decode_bench(smi: str):
    """Phase 36: ``cor_tpu_torch.tools.decode_bench`` at its defaults (the
    SAM-base decoder in bf16, a 128-row store, 8 chunks of 128 candidates,
    20 windows) for each variant, and with --int8 for layer and dma; each
    JSON line printed. The decode schedules' main path: returns each
    wrapper's launches over the runs."""
    from cor_tpu_torch.tools import decode_bench

    t0 = time.perf_counter()
    totals = {k: 0 for k in read_counts()}
    for variant, int8 in (("layer", False), ("layer", True), ("dma", False), ("dma", True),
                          ("stack", False), ("grid", False)):
        reset_counts()
        res = decode_bench.run(variant, int8)
        torch.cuda.synchronize()
        c = read_counts()
        for k, v in c.items():
            totals[k] += v
        # one decode per chunk, in the warm-up pass and in every window
        want = schedule_launches(variant, int8)
        runs = res["chunks"] * (1 + res["windows"])
        if (res["launches_per_chunk"] != want
                or {k: v for k, v in c.items() if v} != {k: v * runs for k, v in want.items()}):
            fail(f"decode_bench {variant}{' --int8' if int8 else ''}: launches {c}, per chunk "
                 f"{res['launches_per_chunk']}, expected {want} per chunk")
        print(json.dumps(res), flush=True)
    print(f"phase 36 decode_bench: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return totals


# ---------------------------------------------------------------------------
# the last two TPU kernels: phase 37
# ---------------------------------------------------------------------------

# K5′ at K5's shapes: the towers' (ViT-B-16 vision rows, batch 16), the SAM
# encoder's and the decoder's, SO400M's, sam_huge's
ADD_LN_SHAPES = ((9216, 768), (32768, 768), (32768, 256), (11664, 1152), (32768, 1280))
ADD_LN_ROW = (32768, 256)  # the kernels line's K5′ row
# K9: cor_tpu's own test's shape (tests/test_pallas_kernels.py:43), and the
# SAM decoder's last upscale at 40 candidates (x [40, 128, 128, 64], O 32)
# with the N 1 of select_mask and the N 4 of its mask tokens
K9_SHAPES = ((2, 8, 8, 64, 32, 3), (40, 128, 128, 64, 32, 1), (40, 128, 128, 64, 32, 4))
K9_ROW = K9_SHAPES[-1]
# cor_tpu's fp32 tolerances (K5′ tests/test_pallas_kernels.py:39, K9 :58);
# K9 in bf16 at its fp32 tolerance: both versions take the same rounded
# operands into fp32 arithmetic
FP32_TOL.update({"add_layer_norm": 1e-5, "fused_upscale2_hyper": 1e-4})
K9_BF16_TOL = 1e-4
# fp32 outside the tensor cores (NVIDIA data sheet, H100 SXM): K9's bias,
# GELU (erf by Abramowitz-Stegun: 17 flops counted in csrc/upscale.cu) and
# hypernetwork product per output channel value
PEAK_FP32_SIMT_FLOP_S = 67e12
K9_GELU_FLOPS = 17


def tf32_flags() -> str:
    return (f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn={torch.backends.cudnn.allow_tf32}")


@contextlib.contextmanager
def phase_flags(phases: str, tf32_off: bool):
    """Print the TF32 flags that ``phases`` find on entry. A kernel-check
    phase (``tf32_off``) holds kernels against plain versions whose fp32
    products must be full fp32: it turns TF32 off for its own time and
    restores the flags after. Every other phase runs the entry points under
    the flags as torch sets them, so that what a user's run computes is what
    gets checked."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    print(f"  {phases}: on entry {tf32_flags()}"
          f"{'; TF32 off for the kernel checks' if tf32_off else ''}", flush=True)
    if tf32_off:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def k9_bound(x, hyper, out, O: int, dt):
    """K9's least time: the bytes (x, the packed w and b, hyper, the
    output), the first product on the tensor cores, or the bias, GELU and
    hypernetwork product on the CUDA cores, whichever is the largest."""
    B, H, W, C = x.shape
    vals = B * H * W * 4 * O  # output channel values of the transposed conv
    t_bytes = (nbytes(x, hyper, out) + 4 * C * O * x.element_size() + 4 * O) / PEAK_BYTES_S
    t_tc = 2 * vals * C / (PEAK_BF16_FLOP_S if dt == torch.bfloat16 else PEAK_FP32_FLOP_S)
    t_simt = vals * (K9_GELU_FLOPS + 2 * hyper.shape[1]) / PEAK_FP32_SIMT_FLOP_S
    return (1e3 * max(t_bytes, t_tc, t_simt),
            "bytes" if t_bytes >= max(t_tc, t_simt) else "operations")


def phase_last_kernels(device):
    """Phase 37: K5′ (add_layer_norm) and K9 (fused_upscale2_hyper), whose
    only callers in either package are tests: first their entry points
    once per dtype (the path the kernels line counts: K5′ forward, and
    forward and backward through autograd; K9 at the decoder's shape), then
    each against its plain version at K5's shapes and at K9's (bf16 and
    fp32, TF32 off), timed beside the plain version, the library call or
    composition and the bound; K5′ beside x + y followed by K5, K9 beside
    K3 on the [40, 64, 64, 256] input whose maps are as large."""
    import torch.nn.functional as F

    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.layernorm import (
        add_layer_norm,
        add_layer_norm_plain,
        layer_norm,
    )
    from cor_tpu_torch.ops.kernels.upscale import fused_upscale2_hyper, fused_upscale2_hyper_plain

    t0 = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(SEED + 37)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    dtypes = ((torch.bfloat16, ""), (torch.float32, "@fp32"))

    def k9_inputs(B, H, W, C, O, N, dt):
        return (rnd(B, H, W, C).to(dt), 0.1 * rnd(C, 2, 2, O), 0.1 * rnd(O),
                rnd(B, N, O).to(dt))

    # the path: each entry point as a user calls it
    reset_counts()
    rows, C = ADD_LN_ROW
    for dt, _ in dtypes:
        x, y = rnd(rows, C).to(dt), rnd(rows, C).to(dt)
        s, b = 1 + 0.1 * rnd(C), 0.1 * rnd(C)
        with torch.no_grad():
            add_layer_norm(x, y, s, b)
            fused_upscale2_hyper(*k9_inputs(*K9_ROW, dt))
        xs = [t.clone().requires_grad_(True) for t in (x, y, s, b)]
        torch.autograd.grad(add_layer_norm(*xs).float().square().sum(), xs)
    torch.cuda.synchronize()
    path = read_counts()
    want = {k: 2 if k.startswith("add_layer_norm") else 1
            for k in ("add_layer_norm", "add_layer_norm@fp32", "fused_upscale2_hyper",
                      "fused_upscale2_hyper@fp32")}
    got = {k: path[k] for k in want}
    others = {k: v for k, v in path.items() if v and k not in want}
    print(f"  phase 37 path: launches {got} (want {want}; others {others})", flush=True)
    if got != want or others:
        fail(f"phase 37's entry points launched {got} and {others}, not {want}")

    out = {}
    for dt, sfx in dtypes:
        bnd = bound if dt == torch.bfloat16 else bound32
        # K5′
        rows_out = {}
        for rows, C in ADD_LN_SHAPES:
            x, y = (2 * rnd(rows, C) + 0.5).to(dt), rnd(rows, C).to(dt)
            s, b = (1 + 0.1 * rnd(C)).to(dt), (0.1 * rnd(C)).to(dt)
            before = (add_layer_norm.launches, add_layer_norm.launches_fp32)
            with torch.no_grad():
                got, want = add_layer_norm(x, y, s, b), add_layer_norm_plain(x, y, s, b)
            torch.cuda.synchronize()
            calls = (add_layer_norm.launches - before[0], add_layer_norm.launches_fp32 - before[1])
            if calls != ((1, 0) if dt == torch.bfloat16 else (0, 1)):
                fail(f"add_layer_norm launched {calls} for one call")
            kt = cuda_ms(lambda: add_layer_norm(x, y, s, b))
            pt = cuda_ms(lambda: add_layer_norm_plain(x, y, s, b), iters=3)
            lt = cuda_ms(lambda: F.layer_norm(x + y, (C,), s, b, 1e-6))
            k5t = cuda_ms(lambda: layer_norm(x + y, s, b))
            bd = bnd(nbytes(x, y, got, s, b), 9 * x.numel())
            label = f"[{rows}, {C}]"
            extra = dict(library_calls="F.layer_norm(x + y): two calls (the add, the norm)",
                         add_then_k5_ms=k5t[0],
                         **device_times(lambda: add_layer_norm(x, y, s, b),
                                        lambda: F.layer_norm(x + y, (C,), s, b, 1e-6)))
            if dt == torch.float32:
                res = check32("K5′ add_layer_norm", label, FP32_TOL["add_layer_norm"],
                              [(got, want)], kt, pt, bd, lt, **extra)
            else:
                err = rel_err(got, want)
                print(f"  K5′ add_layer_norm {label} bf16: max|d|/max|plain| = {err:.3e}; "
                      f"kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, "
                      f"F.layer_norm(x + y) {lt[0]:.4f} ms, x + y then K5 {k5t[0]:.4f} ms, "
                      f"bound {bd[0]:.4f} ms ({bd[1]}); graph replays: kernel "
                      f"{extra['device_ms']:.4f} ms, F.layer_norm(x + y) "
                      f"{extra['library_device_ms']:.4f} ms", flush=True)
                if not err <= KERNEL_TOL:
                    fail(f"add_layer_norm {label} bf16 disagrees with its plain version: {err}")
                res = entry(abs_err((got, want)), kt, pt, bd, lt, max_rel_err=err, **extra)
            rows_out[label] = res
        if dt == torch.float32:
            # one fp32 backward through the plain VJP against the plain autograd
            x, y = rnd(*ADD_LN_ROW), rnd(*ADD_LN_ROW)
            s, b = 1 + 0.1 * rnd(ADD_LN_ROW[1]), 0.1 * rnd(ADD_LN_ROW[1])
            dout = rnd(*ADD_LN_ROW)
            grads = []
            for fn in (add_layer_norm, add_layer_norm_plain):
                ts = [t.clone().requires_grad_(True) for t in (x, y, s, b)]
                grads.append(torch.autograd.grad(fn(*ts), ts, dout))
            err, ratio = tol_err(FP32_TOL["add_layer_norm"], *zip(*grads))
            print(f"  K5′ add_layer_norm fp32 backward {list(ADD_LN_ROW)}: max|d| = {err:.3e}, "
                  f"{ratio:.3f} of the tolerance", flush=True)
            if not ratio <= 1.0:
                fail(f"add_layer_norm's backward disagrees with the plain autograd: {err}")
        out[f"add_layer_norm{sfx}"] = dict(rows_out[f"[{ADD_LN_ROW[0]}, {ADD_LN_ROW[1]}]"],
                                           at_shapes=rows_out)

        # K9, and K3 on the input whose maps are as large
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        up = dec.output_upscaling
        src, hyper3 = rnd(CANDIDATES, GRID, GRID, SAM_C).to(dt), rnd(CANDIDATES, 4, 32).to(dt)
        k3_args = (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w,
                   up.convt2.b, hyper3)
        with torch.no_grad():
            k3t = cuda_ms(lambda: decoder_tail(*k3_args))
        del dec, src
        k9_out = {}
        for shape in K9_SHAPES:
            B, H, W, C, O, N = shape
            x, w, b, h = k9_inputs(*shape, dt)
            before = (fused_upscale2_hyper.launches, fused_upscale2_hyper.launches_fp32)
            with torch.no_grad():
                got, want = fused_upscale2_hyper(x, w, b, h), fused_upscale2_hyper_plain(x, w, b, h)
            torch.cuda.synchronize()
            calls = (fused_upscale2_hyper.launches - before[0],
                     fused_upscale2_hyper.launches_fp32 - before[1])
            if calls != ((1, 0) if dt == torch.bfloat16 else (0, 1)):
                fail(f"fused_upscale2_hyper launched {calls} for one call")
            with torch.no_grad():
                kt = cuda_ms(lambda: fused_upscale2_hyper(x, w, b, h))
                pt = cuda_ms(lambda: fused_upscale2_hyper_plain(x, w, b, h), iters=3)
                xn, wn, hb = x.permute(0, 3, 1, 2), w.to(dt).permute(0, 3, 1, 2), h
                ct = cuda_ms(lambda: torch.einsum(
                    "bnc,bchw->bnhw", hb, F.gelu(F.conv_transpose2d(xn, wn, b.to(dt), stride=2))),
                    iters=3)
            bd = k9_bound(x, h, got, O, dt)
            label = f"x {list(x.shape)}, O {O}, N {N}"
            tol = FP32_TOL["fused_upscale2_hyper"] if dt == torch.float32 else K9_BF16_TOL
            err, ratio = tol_err(tol, (got, want))
            same_maps = (B, H, W) == (CANDIDATES, 2 * GRID, 2 * GRID)
            print(f"  K9 fused_upscale2_hyper {label} {str(dt)[6:]}: max|d| = {err:.3e}, "
                  f"{ratio:.3f} of the tolerance {tol}; kernel {kt[0]:.4f} ms [{kt[1]:.4f}, "
                  f"{kt[2]:.4f}], plain {pt[0]:.4f} ms, conv_transpose2d + gelu + einsum "
                  f"{ct[0]:.4f} ms{f', K3 (N 4) {k3t[0]:.4f} ms' if same_maps else ''}, "
                  f"bound {bd[0]:.4f} ms ({bd[1]})", flush=True)
            if not ratio <= 1.0:
                fail(f"fused_upscale2_hyper {label} disagrees with its plain version: {err}")
            k9_out[label] = entry(err, kt, pt, bd, None, tol=tol, tol_ratio=ratio,
                                  composition_ms=ct[0],
                                  **({"k3_same_maps_ms": k3t[0]} if same_maps else {}))
        B, H, W, C, O, N = K9_ROW
        out[f"fused_upscale2_hyper{sfx}"] = dict(
            k9_out[f"x {[B, H, W, C]}, O {O}, N {N}"], at_shapes=k9_out,
            composition="F.conv_transpose2d + F.gelu + torch.einsum (no single call)")
    for k in out:
        out[k]["path"] = "phase 37's calls of the entry points: no caller in either package"
    torch.cuda.empty_cache()
    print(f"phase 37 K5′ and K9: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    return out, path


def phase_p6(device):
    """Phase 38: P6, the fp32 convolutions under torch's default flags (cuDNN
    TF32 allowed). The SAM-base neck (1x1 768 -> 256, then 3x3 256 -> 256, on
    [2, 64, 64, 768]) and the decoder's first upscale (2x2 stride 2, 256 ->
    64, on [10, 64, 64, 256], the training path's), each run on the card as
    the port ran them before the repair (F.conv2d / F.conv_transpose2d under
    the flags as found) and through the port's helpers (ops.common.conv2d,
    sam_decoder._conv_transpose_2x: TF32 off for the call, forward and
    backward), against the same inputs on the CPU in fp32: max |d| / max
    |cpu| of the outputs and of the input gradients, and each one's ms."""
    import torch.nn.functional as F

    from cor_tpu_torch.models.sam_decoder import ConvTranspose2x, _conv_transpose_2x
    from cor_tpu_torch.ops.common import conv2d

    if not torch.backends.cudnn.allow_tf32:
        fail("phase 38 measures P6 under torch's default flags: cuDNN TF32 allowed")
    gen = torch.Generator().manual_seed(SEED + 38)
    x = torch.randn(2, 64, 64, 768, generator=gen)
    w1 = torch.randn(256, 768, 1, 1, generator=gen) / 768 ** 0.5
    w2 = torch.randn(256, 256, 3, 3, generator=gen) / 48
    y = torch.randn(10, 64, 64, 256, generator=gen)
    up = ConvTranspose2x(256, 64)
    with torch.no_grad():
        up.w.copy_(torch.randn(256, 2, 2, 64, generator=gen) / 32)
        up.b.zero_()

    def neck_raw(x, w1, w2):
        h = F.conv2d(x.permute(0, 3, 1, 2), w1)
        return F.conv2d(h, w2, padding=1).permute(0, 2, 3, 1)

    def neck_port(x, w1, w2):
        return conv2d(conv2d(x, w1), w2, padding=1)

    def up_raw(y, mod):
        return F.conv_transpose2d(y.permute(0, 3, 1, 2), mod.w.permute(0, 3, 1, 2),
                                  stride=2).permute(0, 2, 3, 1) + mod.b

    def run(fn, dev, *args):
        """(output, the gradient of sum(out^2) by the first input)"""
        a = [t.to(dev) for t in args]
        a[0].requires_grad_(True)
        out = fn(*a)
        return out.detach().cpu(), torch.autograd.grad(out.square().sum(), a[0])[0].cpu()

    res = {}
    up_gpu = ConvTranspose2x(256, 64).to(device)
    up_gpu.load_state_dict(up.state_dict())
    for name, raw, port, cpu_fn, args in (
            ("neck", neck_raw, neck_port, neck_port, (x, w1, w2)),
            ("upscale", lambda y: up_raw(y, up_gpu), lambda y: _conv_transpose_2x(up_gpu, y),
             lambda y: _conv_transpose_2x(up, y), (y,))):
        want = run(cpu_fn, torch.device("cpu"), *args)
        row = {}
        for label, fn in (("before (raw cuDNN calls)", raw), ("after (port helpers)", port)):
            got = run(fn, device, *args)
            errs = [((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want)]
            dev_args = [t.to(device) for t in args]
            with torch.no_grad():
                t = cuda_ms(lambda: fn(*dev_args), windows=5, iters=5)
            row[label] = {"out_rel_err": errs[0], "grad_rel_err": errs[1], "ms": t[0]}
            print(f"  P6 {name} fp32 {label}: max|d|/max|cpu| out {errs[0]:.3e}, input grad "
                  f"{errs[1]:.3e}; forward {t[0]:.4f} ms [{t[1]:.4f}, {t[2]:.4f}]", flush=True)
        res[name] = row
        if not max(row["after (port helpers)"][k] for k in ("out_rel_err", "grad_rel_err")) <= 1e-5:
            fail(f"P6: the port's fp32 {name} is off the CPU's fp32 by more than 1e-5")
    if not torch.backends.cudnn.allow_tf32:
        fail("the port's fp32 convolutions left cuDNN's TF32 flag changed")
    print(json.dumps({"p6_fp32_convolutions": res}))
    print("phase 38 P6: ok", flush=True)


GPU_TEST_FILES = tuple(f"tests/test_torch_{name}.py" for name in (
    "kernels", "upscale_add_ln", "attention_redesign", "vit_attention_redesign",
    "redesign_fp32_seq_ln", "redesign_fp32_vit", "k1_redesign", "k2_k3_redesign",
    "k8_redesign", "stack_grid_redesign", "dma_k9_redesign", "retrieve"))


def phase_gpu_tests():
    """Phase 2's second part: the test files marked `gpu`, in a pytest
    process of their own on the library just built; their count, and
    test_two_way_layer_dma_kernel_equals_k1's cases by name."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *GPU_TEST_FILES, "-m", "gpu", "--noconftest", "-q",
         "-rA", "-p", "no:cacheprovider"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=900,
    )
    lines = proc.stdout.splitlines()
    summary = next((line.strip("= ") for line in reversed(lines)
                    if " passed" in line or " failed" in line or " error" in line), "no summary")
    dma = [line.split("::", 1)[1] for line in lines
           if line.startswith("PASSED ") and "::test_two_way_layer_dma_kernel_equals_k1[" in line]
    print(f"phase 2 gpu tests ({len(GPU_TEST_FILES)} files): {summary}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    print(f"  test_two_way_layer_dma_kernel_equals_k1: {len(dma)} passed ({', '.join(dma)})",
          flush=True)
    if proc.returncode != 0 or not dma:
        print("\n".join(lines[-60:]), proc.stderr[-3000:], sep="\n", file=sys.stderr)
        fail(f"the gpu test files: {summary}")


def memoize_seeded_inits() -> None:
    """From here on in this process, core_model's seeded CPU inits (the
    image encoder, the support branch, the decode model) draw once per
    configuration part and seed: every entry point and phase that asks again
    gets a copy of the same weights instead of drawing them again (~7 s for
    SO400M's towers, ~6 s for sam_huge). Each keeps the first draw as
    ``.drawn`` for the phases that time it."""
    import copy

    from cor_tpu_torch.models import core_model as cm

    parts = {"init_image_encoder": lambda c: c.encoder, "init_support_branch": lambda c: c.support,
             "init_decode_model": lambda c: (c.prompt, c.decoder)}
    cache = {}

    def memo(name, draw):
        def init(cfg, seed):
            key = (name, repr(parts[name](cfg)), seed)
            if key not in cache:
                cache[key] = draw(cfg, seed)
            return copy.deepcopy(cache[key])
        init.drawn = draw
        return init

    for name in parts:
        setattr(cm, name, memo(name, getattr(cm, name)))


def drawn(init):
    """``init`` as it draws its weights, memoised or not."""
    return getattr(init, "drawn", init)


@contextlib.contextmanager
def drawing_inits():
    """core_model's inits drawing their weights inside (for a timing that
    includes the model's init)."""
    from cor_tpu_torch.models import core_model as cm

    names = ("init_image_encoder", "init_support_branch", "init_decode_model")
    saved = {name: getattr(cm, name) for name in names}
    for name in names:
        setattr(cm, name, drawn(saved[name]))
    try:
        yield
    finally:
        for name in names:
            setattr(cm, name, saved[name])


@contextlib.contextmanager
def plain_decoder():
    """The fused decoder with K1, K2 and K3 swapped for their plain versions
    (as a CPU tensor would route), TF32 off."""
    from cor_tpu_torch.models import sam_decoder as sd
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail_plain
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv_plain
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer_plain

    saved = sd.two_way_layer, sd.t2i_flash_kv, sd.decoder_tail
    sd.two_way_layer, sd.t2i_flash_kv, sd.decoder_tail = (two_way_layer_plain,
                                                          t2i_flash_kv_plain, decoder_tail_plain)
    try:
        with phase_flags("  plain decode", tf32_off=True):
            yield
    finally:
        sd.two_way_layer, sd.t2i_flash_kv, sd.decoder_tail = saved


PROTOCOL_K = 10
# label, config keys over vaild_config.yaml's, triplets, whether the path
# drives cli.retrieve --rerank (once: the entry point) and the index route
# (cli.index + cli.retrieve --gallery-index: at SAM-base, cut at CFG for time)
PROTOCOL_PATHS = (
    ("SAM-base bf16", {}, 128, True, True),
    ("SAM-base fp32", {"compute_dtype": "float32"}, 128, False, True),
    ("CFG bf16", LARGE_KEYS, 32, False, False),
    ("CFG fp32", {**LARGE_KEYS, "compute_dtype": "float32"}, 32, False, False),
)


def rounded(recalls: dict) -> dict:
    """A recall dict as cli.retrieve prints it."""
    return {k: round(v, 4) if isinstance(v, float) else v for k, v in recalls.items()}


def ids_agree_across_gaps(ids, ref_ids, ref_vals, tol) -> bool:
    """The ranked ids agree wherever the reference's adjacent values (IoUs or
    scores) differ by more than tol * max(1, |value|)."""
    for got, want, v in zip(ids, ref_ids, ref_vals):
        gap = tol * max(1.0, float(np.abs(v).max()))
        for i in range(len(want)):
            if ((i == 0 or v[i - 1] - v[i] > gap)
                    and (i == len(want) - 1 or v[i] - v[i + 1] > gap) and got[i] != want[i]):
                return False
    return True


def protocol_path(label: str, keys: dict, n: int, drive_cli: bool, index_route: bool,
                  d: Path, smi: str) -> dict:
    """One path of phase 39 (see its docstring); the index directory is
    ``d / "index"``."""
    from cor_tpu_torch.cli import index as index_cli
    from cor_tpu_torch.cli import retrieve as retrieve_cli
    from cor_tpu_torch.config import load_eval_config
    from cor_tpu_torch.data.pipeline import DataLoader
    from cor_tpu_torch.data.synthetic import SyntheticDataset
    from cor_tpu_torch.models import core_model as cm
    from cor_tpu_torch.models.prompt_encoder import get_dense_pe
    from cor_tpu_torch.models.sam_decoder import mask_decoder
    from cor_tpu_torch.retrieval import protocol as prot
    from cor_tpu_torch.retrieval.engine import DECODE_CHUNK, RetrievalEngine

    t_path = time.perf_counter()
    d.mkdir(parents=True)
    cfg_path = flat_config("vaild_config.yaml", d / "cfg.yaml", **keys)
    cfg = load_eval_config(cfg_path)
    core = cfg.core_config()
    bf16 = core.compute_dtype == "bfloat16"
    common = ["--config", str(cfg_path), "--synthetic", str(n), "--k", str(PROTOCOL_K),
              "--batch-size", str(SAM_BATCH)]
    out = {"card": smi, "triplets": n, "k": PROTOCOL_K}

    def cli(main, *argv):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            res = main([*argv])
        return res, time.perf_counter() - t0

    # the entry point itself, one pass with the rerank
    if drive_cli:
        cli_rerank, out["cli_rerank_s"] = cli(retrieve_cli.main, *common, "--rerank")

    # one encode of the same triplets with the CLI's seeded weights, then the
    # recalls with and without the rerank and with the int8 scan
    models = prot.prepare_models(core, cm.init_image_encoder(core, cfg.seed + 2),
                                 cm.init_support_branch(core, cfg.seed),
                                 cm.init_decode_model(core, cfg.seed), device="cuda")
    sig = core.support.siglip
    ds = SyntheticDataset(length=n, query_img_size=core.encoder.img_size,
                          support_img_size=sig.vision.image_size,
                          context_length=sig.text.context_length,
                          vocab_size=sig.text.vocab_size, seed=cfg.seed)
    t0 = time.perf_counter()
    gallery, queries, _, store = prot.encode_manifest(
        core, models, DataLoader(ds, SAM_BATCH, num_workers=cfg.num_workers), keep_store=True)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t0
    targets, ks = np.arange(n), (1, 5, PROTOCOL_K)
    recalls = {
        "scan": prot.scan_recall(gallery, queries, targets, ks),
        "int8_scan": prot.scan_recall(gallery, queries, targets, ks, quantize=True),
        "rerank": prot.scan_recall(gallery, queries, targets, ks,
                                   make_retrieve=prot.make_decode_retriever(core, models, store)),
    }
    if drive_cli:
        recalls["cli_rerank"] = cli_rerank
        out["cli_equals_in_process"] = cli_rerank == rounded(recalls["rerank"])
    if recalls["rerank"][f"recall@{PROTOCOL_K}"] != recalls["scan"][f"recall@{PROTOCOL_K}"]:
        fail(f"phase 39 {label}: recall@{PROTOCOL_K} with the rerank differs from the scan's: "
             f"{recalls}")

    # stage times, the launches per chunk, and the decode against its plain versions
    engine = RetrievalEngine(k=PROTOCOL_K, device="cuda")
    engine.set_gallery(gallery)
    engine.enable_store_decode(store)
    q = torch.from_numpy(queries / np.linalg.norm(queries, axis=1, keepdims=True)).cuda()
    dec = models.decode_model
    pe = get_dense_pe(dec.prompt_encoder).to(core.dtype)
    engine.retrieve(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, scan_idx = engine.retrieve(q)
    torch.cuda.synchronize()
    out["scan_s"] = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    _, iou, idx = engine.retrieve_decode(q, dec.mask_decoder, pe)
    torch.cuda.synchronize()
    scan_decode_s = time.perf_counter() - t0
    counts = read_counts()
    B = n * PROTOCOL_K
    chunk = DECODE_CHUNK if B > DECODE_CHUNK and B % DECODE_CHUNK == 0 else B
    chunks = B // chunk
    out["decode_s"] = scan_decode_s - out["scan_s"]
    out["candidates_decoded_per_s"] = B / out["decode_s"]
    out["chunks"] = f"{chunks} x {chunk}"
    sfx = "" if bf16 else "@fp32"
    want = {k: v * chunks for k, v in route_launches(6).items()}
    got = {k: counts[k + sfx] for k in want}
    out["launches"] = got
    if got != want:
        fail(f"phase 39 {label}: decoder launches {got}, expected {want} ({chunks} chunks)")
    tol = IOU_TOL if bf16 else DECODE_TOL32
    flat = scan_idx.reshape(-1)[:chunk].to(torch.int32)
    prompts = q.to(core.dtype).repeat_interleave(PROTOCOL_K, dim=0)[:chunk, None, :]
    with torch.inference_mode():
        with phase_flags("  kernel decode of one chunk", tf32_off=True):
            k_iou = mask_decoder(dec.mask_decoder, engine.store_q, pe, prompts, None, False,
                                 store_idx=flat, store_scale=engine.store_scales)[1]
        with plain_decoder():
            p_iou = mask_decoder(dec.mask_decoder, engine.store_q, pe, prompts, None, False,
                                 store_idx=flat, store_scale=engine.store_scales)[1]
            _, piou, pidx = engine.retrieve_decode(q, dec.mask_decoder, pe)
    err = ((k_iou.float() - p_iou.float()).abs() / p_iou.float().abs().clamp(min=1)).max().item()
    ranked_err = ((iou - piou).abs() / piou.abs().clamp(min=1)).max().item()
    out["iou_vs_plain"] = {"chunk_max_rel_err": err, "ranked_max_rel_err": ranked_err,
                           "tol": tol, "max_abs_iou": piou.abs().max().item()}
    agree = ids_agree_across_gaps(idx.cpu().numpy(), pidx.cpu().numpy(), piou.cpu().numpy(), tol)
    out["ids_agree_across_gaps"] = agree
    if not (err <= tol and ranked_err <= tol and agree and torch.isfinite(iou).all()):
        fail(f"phase 39 {label}: the decode's IoU against its plain versions: {out}")
    del engine, models, store, q
    torch.cuda.empty_cache()

    # the index route: cli.index --with-store, then cli.retrieve --gallery-index
    if index_route:
        _, out["cli_index_s"] = cli(index_cli.main, "--config", str(cfg_path), "--out",
                                    str(d / "index"), "--synthetic", str(n), "--batch-size",
                                    str(SAM_BATCH), "--with-store")
        recalls["index"], out["cli_index_retrieve_s"] = cli(retrieve_cli.main, *common,
                                                            "--gallery-index", str(d / "index"))
        recalls["index_rerank"], out["cli_index_rerank_s"] = cli(
            retrieve_cli.main, *common, "--gallery-index", str(d / "index"), "--rerank")
        if recalls["index"] != rounded(recalls["scan"]):
            fail(f"phase 39 {label}: the index route's recalls differ from the one pass's: "
                 f"{recalls}")
        if (recalls["index_rerank"][f"recall@{PROTOCOL_K}"]
                != recalls["index"][f"recall@{PROTOCOL_K}"]):
            fail(f"phase 39 {label}: the index route's rerank changed recall@{PROTOCOL_K}: "
                 f"{recalls}")
    out["recalls"] = recalls
    out["recall_note"] = (f"random weights from seeds: chance is K / {n} at Recall@K")
    out["seconds"] = time.perf_counter() - t_path
    return out


def phase_protocol(root: Path, smi: str) -> Path:
    """Phase 39: the Recall@K protocol (see the module's docstring); returns
    the SAM-base bf16 index for phase 40."""
    results = {}
    for label, keys, n, drive_cli, index_route in PROTOCOL_PATHS:
        results[label] = protocol_path(label, keys, n, drive_cli, index_route,
                                       root / label.replace(" ", "_"), smi)
        r = results[label]
        print(f"  {label}: {r['seconds']:.1f} s; recalls scan {r['recalls']['scan']}, rerank "
              f"{r['recalls']['rerank']}, int8 {r['recalls']['int8_scan']}; encode "
              f"{r['encode_s']:.2f} s, scan {r['scan_s'] * 1e3:.2f} ms, decode "
              f"{r['decode_s'] * 1e3:.1f} ms ({r['chunks']}, "
              f"{r['candidates_decoded_per_s']:.0f} candidates/s); {smi}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"protocol": results}))
    print("phase 39 protocol: ok", flush=True)
    return root / "SAM-base_bf16" / "index"


SCORE_TOL_RESCORE = 1e-5  # cor_tpu's rescore test: true cosines (tests/test_retrieval.py:268)
TCP_SEEDS = 16  # synthetic request seeds (their queries are memoised by the server)
TCP_PER_CLIENT = 16


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_tcp_server(index_dir: Path, out_dir: Path, max_batch: int, *flags) -> int:
    """cli.serve.main --tcp on loopback in a daemon thread (SAM-base bf16,
    --decode-masks --store-hbm, k 10); its port once it listens."""
    from cor_tpu_torch.cli import serve as serve_cli

    ev, port = threading.Event(), free_port()
    argv = ["--gallery-index", str(index_dir), "--k", str(PROTOCOL_K), "--max-batch",
            str(max_batch), "--decode-masks", str(out_dir), "--store-hbm", "--tcp", str(port),
            *flags]
    threading.Thread(target=serve_cli.main, args=(argv,), kwargs={"ready_event": ev},
                     daemon=True).start()
    if not ev.wait(timeout=300):
        fail(f"phase 40: cli.serve {' '.join(argv)} did not start listening")
    return port


# the TCP clients: a process of their own (no torch), so that their threads
# do not share the server's interpreter; argv[1] is {"port", "clients",
# "per", "seeds", "k"}; prints {"lat", "wall", "answers", "errors"}
TCP_CLIENTS = """
import json, socket, sys, threading, time
a = json.loads(sys.argv[1])
lat, errors, answers = [], [], {ci: [] for ci in range(a["clients"])}
lock = threading.Lock()
def client(ci):
    try:
        with socket.create_connection(("127.0.0.1", a["port"])) as s:
            f = s.makefile("r")
            for r in range(a["per"]):
                rid = f"{ci}:{r}"
                req = {"id": rid, "synthetic": (ci * a["per"] + r) % a["seeds"]}
                t0 = time.perf_counter()
                s.sendall((json.dumps(req) + "\\n").encode())
                resp = json.loads(f.readline())
                with lock:
                    lat.append(time.perf_counter() - t0)
                answers[ci].append(resp)
                if (resp.get("id") != rid or len(resp.get("results", [])) != a["k"]
                        or len(resp.get("masks", [])) != a["k"]):
                    errors.append([rid, resp])
    except Exception as e:
        errors.append([ci, repr(e)])
threads = [threading.Thread(target=client, args=(ci,)) for ci in range(a["clients"])]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=300)
print(json.dumps({"lat": lat, "wall": time.perf_counter() - t0,
                  "answers": [answers[ci] for ci in range(a["clients"])], "errors": errors}))
"""


def tcp_clients(port: int, clients: int, per: int):
    """Closed-loop clients in a process of their own, each sending ``per``
    requests one after another: (latencies in s, wall s, responses by
    client, errors)."""
    args = {"port": port, "clients": clients, "per": per, "seeds": TCP_SEEDS, "k": PROTOCOL_K}
    proc = subprocess.run([sys.executable, "-c", TCP_CLIENTS, json.dumps(args)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"phase 40: the TCP clients failed: {proc.stderr[-2000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    return r["lat"], r["wall"], r["answers"], r["errors"]


def phase_tcp(index_dir: Path, root: Path, smi: str) -> dict:
    """Phase 40: TCP serving (see the module's docstring)."""
    sweep = {}
    ports = {}
    for mb in (4, 8):
        ports[mb] = start_tcp_server(index_dir, root / f"tcp_masks_{mb}", mb)
        tcp_clients(ports[mb], 1, TCP_SEEDS)  # the servers memoise the seeds' queries
        for clients in (4, 8):
            reset_counts()  # one decode (one K3 launch) per served batch
            lat, wall, answers, errors = tcp_clients(ports[mb], clients, TCP_PER_CLIENT)
            if errors or len(lat) != clients * TCP_PER_CLIENT:
                fail(f"phase 40: {clients} clients at --max-batch {mb}: {errors[:3]}")
            ms = np.array(lat) * 1e3
            batches = read_counts()["decoder_tail"]
            sweep[f"{clients} clients, --max-batch {mb}"] = {
                "responses_per_s": len(lat) / wall, "p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99)), "responses": len(lat),
                "batches": batches, "mean_batch": len(lat) / max(batches, 1)}
    # one client at a time: every request alone in its batch, so every scan
    # sees the same query bits; --rescore --int8 and --approx against fp32
    exact = tcp_clients(ports[4], 1, TCP_SEEDS)[2][0]
    checks = {}
    for flags in (("--rescore", "--int8"), ("--approx",)):
        port = start_tcp_server(index_dir, root / f"tcp_masks{'_'.join(flags)}", 4, *flags)
        got = tcp_clients(port, 1, TCP_SEEDS)[2][0]
        score_err, same = 0.0, True
        for g, w in zip(got, exact):
            gs = np.array([r["score"] for r in g["results"]])
            ws = np.array([r["score"] for r in w["results"]])
            score_err = max(score_err, float(np.abs(gs - ws).max()))
            same &= ids_agree_across_gaps([[r["pair_id"] for r in g["results"]]],
                                  [[r["pair_id"] for r in w["results"]]], [ws], SCORE_TOL_RESCORE)
        checks[" ".join(flags)] = {"max_abs_score_err": score_err, "ids_agree_across_gaps": same,
                                   "tol": SCORE_TOL_RESCORE}
        if score_err > SCORE_TOL_RESCORE or not same:
            fail(f"phase 40: {' '.join(flags)} against the exact fp32 scan: {checks}")
    out = {"sweep": sweep, "against_fp32_scan": checks, "card": smi,
           "requests": "synthetic, 16 seeds; every response's id back to its own client, with "
                       f"{PROTOCOL_K} results and {PROTOCOL_K} masks"}
    for key, r in sweep.items():
        print(f"  {key}: {r['responses_per_s']:.1f} responses/s, p50 {r['p50_ms']:.1f} ms, "
              f"p99 {r['p99_ms']:.1f} ms, {r['mean_batch']:.2f} requests a batch; {smi}",
              flush=True)
    print(json.dumps({"tcp_serving": out}))
    print("phase 40 TCP serving: ok", flush=True)
    return out


# phases 41-42: evaluation from files at full width
EVAL_NATIVE_HW = ((480, 640), (768, 1024), (900, 1200), (1024, 1024))  # query images' (h, w)
EVAL_ROWS = 12  # a split's manifest rows kept; a 13th, Compose = 1, is dropped
EVAL_CPU_ROWS = 1  # of the first batch, run again on the CPU in fp32 (~7 s a row)
EVAL_PER_BATCH = {"attention_seq_qkv": 24, "layer_norm": 50 + 26, "vit_attention_relpos": 12,
                  "two_way_layer": 8, "t2i_flash_kv": 1, "decoder_tail": 1}  # K4 K5 K6 K1 K2 K3


def differing_leaves(a, b) -> list:
    """The names of the leaves where two modules differ in any bit."""
    sa, sb = a.state_dict(), b.state_dict()
    if sorted(sa) != sorted(sb):
        return sorted(set(sa) ^ set(sb))
    return [k for k in sa if not torch.equal(sa[k], sb[k])]


def phase_checkpoints(d: Path, smi: str) -> Path:
    """Phase 41 (see the module's docstring); returns the reference .pth."""
    import logging

    from cor_tpu_torch.cli import export as export_cli
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models import core_model as cm
    from cor_tpu_torch.models.build import build_model_with_query_support_feat
    from cor_tpu_torch.train.checkpoint import save_checkpoint
    from cor_tpu_torch.utils import convert, export

    logger = logging.getLogger("chip_smoke.checkpoints")
    core = EvalConfig().core_config()
    secs = {}

    def timed(key, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        secs[key] = time.perf_counter() - t0
        return out

    model = cm.init_core_model(core, SEED)
    n_params = sum(p.numel() for p in model.parameters())
    timed("write_port_checkpoint", save_checkpoint, d, "best_model",
          {"params": model.state_dict(), "epoch": 3, "loss": 0.25})
    pth = d / "core.pth"
    with contextlib.redirect_stdout(io.StringIO()):
        summary = timed("cli_export", export_cli.main, ["--checkpoint", str(d / "best_model"),
                                                        "--out", str(pth)])
    sam = export.export_sam_state_dict(model)
    sam["prompt_encoder.no_mask_embed.weight"] = sam["prompt_encoder.no_mask_embed.weight"] + 1
    timed("write_sam_pth", export.save_state_dict, d / "sam.pth", sam)
    timed("write_siglip_bin", export.save_state_dict, d / "siglip.bin",
          export.export_siglip_state_dict(model.support_branch.siglip))
    sizes = {f.name: round(f.stat().st_size / 2**20, 1) for f in (pth, d / "sam.pth",
                                                                  d / "siglip.bin")}
    other = cm.init_core_model(core, SEED + 1)
    if not differing_leaves(model, other):
        fail("phase 41: the two seeds drew the same weights")
    timed("load_reference_pth", convert.load_trained_params, pth, core, other, logger)
    if differing_leaves(model, other):
        fail(f"phase 41: load_trained_params of the .pth differs in "
             f"{differing_leaves(model, other)[:5]}")
    third = cm.init_core_model(core, SEED + 1)
    timed("load_port_checkpoint", convert.load_trained_params, d / "best_model", core, third,
          logger)
    if differing_leaves(model, third):
        fail(f"phase 41: the port checkpoint's load differs in "
             f"{differing_leaves(model, third)[:5]}")
    del other, third
    built, _ = timed("build_model", build_model_with_query_support_feat,
                     sam_model=core.sam_model, siglip_model=core.siglip_model,
                     sam_checkpoint_path=str(d / "sam.pth"),
                     siglip_checkpoint_path=str(d / "siglip.bin"),
                     mask_pooling=core.mask_pooling, compute_dtype=core.compute_dtype,
                     seed=SEED + 1)
    for part in ("image_encoder", "mask_decoder"):
        if differing_leaves(getattr(model, part), getattr(built, part)):
            fail(f"phase 41: build_model_with_query_support_feat's {part} is not the .pth's")
    if differing_leaves(model.support_branch.siglip, built.support_branch.siglip):
        fail("phase 41: build_model_with_query_support_feat's towers are not the .bin's")
    fresh = cm.init_prompt_encoder(core, SEED + 1).no_mask_embed
    nme = built.prompt_encoder.no_mask_embed
    in_file = torch.from_numpy(sam["prompt_encoder.no_mask_embed.weight"])
    if not torch.equal(nme, fresh) or torch.equal(nme, in_file):
        fail("phase 41: no_mask_embed was loaded from the SAM .pth (it stays at its init)")
    del built, model
    out = {"card": smi, "model": f"{core.sam_model} + {core.siglip_model}, {core.mask_pooling}",
           "parameters": n_params, "reference_keys": summary["n_keys"], "file_mib": sizes,
           "seconds": secs, "bit_for_bit": True, "no_mask_embed_at_init": True}
    print(f"  {n_params / 1e6:.1f} M parameters; write: port checkpoint "
          f"{secs['write_port_checkpoint']:.2f} s, cli.export {secs['cli_export']:.2f} s "
          f"({summary['n_keys']} keys), SAM .pth {secs['write_sam_pth']:.2f} s, SigLIP .bin "
          f"{secs['write_siglip_bin']:.2f} s; load: the .pth {secs['load_reference_pth']:.2f} s, "
          f"the port checkpoint {secs['load_port_checkpoint']:.2f} s, "
          f"build_model_with_query_support_feat {secs['build_model']:.2f} s; files {sizes} MiB; "
          f"{smi}", flush=True)
    print(json.dumps({"checkpoints": out}))
    print("phase 41 checkpoints: ok", flush=True)
    return pth


def blob(h: int, w: int, rng) -> np.ndarray:
    """A uint8 0/255 ellipse at a seeded place."""
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0.3, 0.7, 2) * (h, w)
    ry, rx = rng.uniform(0.15, 0.35, 2) * (h, w)
    return ((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) < 1).astype(np.uint8) * 255


def write_triplet(root: Path, ds: str, target: str, names, hw, i: int, rng,
                  mask_kind=None) -> None:
    """One triplet's four PNGs (``names``: query image, query mask, support
    image, support mask) under ``root/ds``: the query image [h, w] of 16 px
    blocks with noise, its scanlines in filter type i % 5; the query mask a
    blob (gray, or ``mask_kind`` "RGB" or "P"); the support image and mask at
    (300 + 7 i) x (400 - 5 i)."""
    from cor_tpu_torch.utils.png import png_encode

    h, w = hw
    img_dir, mask_dir = root / ds / "image", root / ds / "mask"
    for sub in (img_dir, mask_dir / str(int(target)), mask_dir / "sup"):
        sub.mkdir(parents=True, exist_ok=True)
    coarse = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(coarse, 16, 0), 16, 1)[:h, :w]
    img = (img + rng.integers(0, 16, img.shape, dtype=np.uint8)).astype(np.uint8)
    (img_dir / names[0]).write_bytes(png_encode(img, filter_type=i % 5))
    mask = blob(h, w, rng)
    if mask_kind == "RGB":
        data = png_encode(np.repeat(mask[..., None], 3, axis=2))
    elif mask_kind == "P":
        data = png_encode((mask > 0).astype(np.uint8),
                          palette=np.array([[0, 0, 0], [255, 255, 255]], np.uint8))
    else:
        data = png_encode(mask)
    (mask_dir / str(int(target)) / names[1]).write_bytes(data)
    (img_dir / names[2]).write_bytes(png_encode(
        rng.integers(0, 256, (300 + 7 * i, 400 - 5 * i, 3), dtype=np.uint8)))
    (mask_dir / "sup" / names[3]).write_bytes(png_encode(blob(300 + 7 * i, 400 - 5 * i, rng)))


def write_eval_dataset(root: Path) -> dict:
    """Phase 42's two splits of EVAL_ROWS triplets over two Dataset folders,
    PNG files by the port's writer: RGB images (the query images at
    EVAL_NATIVE_HW's sizes, their scanlines in filter types 0-4), gray masks
    and, in Test_1, one RGB and one palette query mask; Targets 007 (the
    folder 7) and 12; a Compose = 1 row at each manifest's end. Returns
    {split: (csv path, [(Id, Query_mask, (h, w))])}."""
    rng = np.random.default_rng(SEED)
    splits = {}
    for s, split in enumerate(("Test_1", "Test_2")):
        rows, kept = [], []
        for i in range(EVAL_ROWS + 1):
            pid, ds, target = 100 * (s + 1) + i, ("coco", "lvis")[i % 2], ("007", "12")[i // 2 % 2]
            h, w = EVAL_NATIVE_HW[i % len(EVAL_NATIVE_HW)]
            names = [f"{split}_{n}{i}.png" for n in ("q", "qm", "s", "sm")]
            text = "" if i == 3 else f"the {('red', 'small', 'left')[i % 3]} object {i}"
            rows.append(f"{pid},{int(i == EVAL_ROWS)},{ds},{target},{','.join(names)},{text}")
            if i == EVAL_ROWS:
                continue  # dropped by Compose: its files are never read
            write_triplet(root, ds, target, names, (h, w), i, rng,
                          {(0, 1): "RGB", (0, 2): "P"}.get((s, i)))
            kept.append((pid, names[1], (h, w)))
        csv_path = root / f"{split}.csv"
        csv_path.write_text("Id,Compose,Dataset,Target,Query_img,Query_mask,Support_img,"
                            "Support_mask,Text\n" + "\n".join(rows) + "\n")
        splits[split] = (csv_path, kept)
    return splits


def phase_eval(d: Path, pth: Path, smi: str) -> dict:
    """Phase 42 (see the module's docstring)."""
    import logging

    from cor_tpu_torch.cli import eval as eval_cli
    from cor_tpu_torch.config import load_eval_config
    from cor_tpu_torch.eval import validator
    from cor_tpu_torch.models import core_model as cm
    from cor_tpu_torch.train.step import make_predict_step
    from cor_tpu_torch.utils.convert import load_trained_params
    from cor_tpu_torch.utils.png import read_image

    t0 = time.perf_counter()
    splits = write_eval_dataset(d / "dataset")
    write_s = time.perf_counter() - t0
    out_dir = d / "eval_out"
    cfg_path = flat_config("vaild_config.yaml", d / "eval.yaml", dataset_path=str(d / "dataset"),
                           val_csv_A=str(splits["Test_1"][0]), val_csv_B=str(splits["Test_2"][0]),
                           vaild_model_save_path=str(out_dir), load_checkpoint_path=str(pth))
    argv = ["--config", str(cfg_path), "--soft"]

    # the main path once, counted, the first batch's predictions kept
    first = {}
    stream = validator.predict_stream

    def recording(*args, **kw):
        for batch, probs in stream(*args, **kw):
            first.setdefault("batch", batch)
            first.setdefault("probs", probs)
            yield batch, probs

    validator.predict_stream = recording
    reset_counts()
    t0 = time.perf_counter()
    try:
        results = eval_cli.main(argv)
    finally:
        validator.predict_stream = stream
    first_s = time.perf_counter() - t0
    counts = read_counts()
    batches = sum(r["timing"]["batches"] for r in results.values())
    per_batch = {k: counts[k] / batches for k in EVAL_PER_BATCH}
    if per_batch != EVAL_PER_BATCH:
        fail(f"phase 42: launches per batch {per_batch}, expected {EVAL_PER_BATCH}")
    for split, (csv_path, kept) in splits.items():
        r = results[split]
        if r["skipped"] or len(r["hard"]) != EVAL_ROWS or len(r["soft"]) != EVAL_ROWS:
            fail(f"phase 42 {split}: {len(r['hard'])} hard, {len(r['soft'])} soft masks, "
                 f"{r['skipped']} skipped; {EVAL_ROWS} rows")
        for pid, name, hw in kept:
            for sub in ("pred_masks", "soft_pred_masks"):
                m = read_image(out_dir / split / sub / f"{pid}_{name}", "L")
                if m.shape != hw or (sub == "pred_masks" and not np.isin(m, (0, 255)).all()):
                    fail(f"phase 42 {split}: {sub}/{pid}_{name} is {m.shape}, not {hw} (or not "
                         "0/255)")
        with open(out_dir / split / "val_metric.csv", newline="") as f:
            rows = list(csv.DictReader(f))
        vals = np.array([[float(row[k]) for k in validator.METRIC_KEYS] for row in rows])
        if ([int(row["Id"]) for row in rows] != [k[0] for k in kept]
                or not (np.isfinite(vals).all() and (vals >= 0).all() and (vals <= 1).all())):
            fail(f"phase 42 {split}: the metric CSV's rows: {rows}")

    # the first batch's predictions against the port's CPU path in fp32
    cfg = load_eval_config(cfg_path)
    core32 = dataclasses.replace(cfg.core_config(), compute_dtype="float32")
    cpu = cm.init_core_model(core32, cfg.seed)
    load_trained_params(pth, core32, cpu, logging.getLogger("chip_smoke.eval"))
    batch = {k: torch.from_numpy(np.asarray(first["batch"][k][:EVAL_CPU_ROWS]))
             for k in ("query_img", "support_img", "support_mask", "text")}
    t0 = time.perf_counter()
    want = make_predict_step(core32)(cpu.eval(), batch)[..., 0].numpy()
    cpu_s = time.perf_counter() - t0
    got = first["probs"][:EVAL_CPU_ROWS]
    cos = [float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))
           for a, b in zip(got, want)]
    del cpu
    if min(cos) < COS_MIN:
        fail(f"phase 42: the card's bf16 predictions against the CPU's fp32: cosines {cos} < "
             f"{COS_MIN}")

    # the sweep again, warm: images/s, the loader's host wait, the forward's device time
    t0 = time.perf_counter()
    timed = eval_cli.main(argv)
    main_s = time.perf_counter() - t0
    tm = [r["timing"] for r in timed.values()]
    images = sum(t["samples"] for t in tm)
    wall = sum(t["wall_s"] for t in tm)
    out = {
        "card": smi, "splits": {s: len(k) for s, (_, k) in splits.items()},
        "native_hw": EVAL_NATIVE_HW, "batch_size": cfg.batch_size, "batches": batches,
        "launches_per_batch": per_batch, "skipped": 0,
        "summary": {s: r["summary"] for s, r in results.items()},
        "first_batch_cosines_vs_cpu_fp32": cos, "cos_min": COS_MIN, "cpu_rows_s": cpu_s,
        "dataset_write_s": write_s, "first_main_s": first_s, "warm_main_s": main_s,
        "warm_images": images, "warm_sweep_s": wall, "images_per_s": images / wall,
        "loader_wait_s": sum(t["load_s"] for t in tm),
        "forward_device_s": sum(sum(t["forward_ms"]) for t in tm) / 1e3,
        "forward_ms_by_batch": [round(x, 3) for t in tm for x in t["forward_ms"]],
        "masks_and_metrics_s": sum(t["post_s"] for t in tm),
    }
    print(f"  cli.eval --soft, {images} images in {batches} batches of <= {cfg.batch_size} "
          f"(native {EVAL_NATIVE_HW}): warm sweep {wall:.2f} s = {out['images_per_s']:.2f} "
          f"images/s; loader wait {out['loader_wait_s']:.2f} s (host), forward "
          f"{out['forward_device_s']:.3f} s (device, CUDA events; by batch "
          f"{out['forward_ms_by_batch']} ms), masks and metrics {out['masks_and_metrics_s']:.2f} "
          f"s (host); launches per batch {per_batch}; first run {first_s:.1f} s, warm "
          f"main() {main_s:.1f} s (model init and .pth load included); cosines to the CPU "
          f"{[round(c, 6) for c in cos]}; {smi}", flush=True)
    print(json.dumps({"eval_from_files": out}))
    print("phase 42 eval: ok", flush=True)
    return out


# phase 43: training from files at full width
TRAIN_FILES_STEPS = 2  # the training split: this many batches of m3's batch_size
TRAIN_PER_STEP = {"attention_seq_qkv": 24, "layer_norm": 76, "vit_attention_relpos": 12}  # K4 K5 K6
TRAIN_WARM_STEPS = 3  # steps timed again after the run, warm
PANELS = 3
MANIFEST_HEADER = ("Id,Compose,Dataset,Target,Query_img,Query_mask,Support_img,Support_mask,"
                   "Text\n")


def write_train_dataset(root: Path, batch: int) -> dict:
    """Phase 43's manifests: Train.csv (TRAIN_FILES_STEPS x ``batch``
    triplets) and Val.csv (one batch) over two Dataset folders, the query
    images at EVAL_NATIVE_HW's sizes, one RGB and one palette query mask a
    split (``write_triplet``). Returns {split: csv path}."""
    rng = np.random.default_rng(SEED + 43)
    out = {}
    for split, n, base in (("Train", TRAIN_FILES_STEPS * batch, 1000), ("Val", batch, 2000)):
        rows = []
        for i in range(n):
            ds, target = ("coco", "lvis")[i % 2], ("007", "12")[i // 2 % 2]
            names = [f"{split}_{k}{i}.png" for k in ("q", "qm", "s", "sm")]
            write_triplet(root, ds, target, names, EVAL_NATIVE_HW[i % len(EVAL_NATIVE_HW)], i,
                          rng, {1: "RGB", 2: "P"}.get(i))
            rows.append(f"{base + i},0,{ds},{target},{','.join(names)},the object {i}")
        out[split] = root / f"{split}.csv"
        out[split].write_text(MANIFEST_HEADER + "\n".join(rows) + "\n")
    return out


def loader_rate(loader) -> float:
    """Samples a second of one pass of ``loader`` on the host, the batches
    dropped as they come."""
    t0, n = time.perf_counter(), 0
    for b in loader:
        n += len(b["pair_id"])
    return n / (time.perf_counter() - t0)


def phase_train_from_files(d: Path, smi: str) -> dict:
    """Phase 43 (see the module's docstring)."""
    from cor_tpu_torch.cli import eval as eval_cli
    from cor_tpu_torch.cli import train as train_cli
    from cor_tpu_torch.config import load_train_config
    from cor_tpu_torch.data.pipeline import DataLoader, get_train_loader, valid_dataset
    from cor_tpu_torch.train import trainer as trainer_mod
    from cor_tpu_torch.train.checkpoint import CheckpointWriter, restore_checkpoint
    from cor_tpu_torch.utils.png import read_image

    t0 = time.perf_counter()
    batch = load_train_config(m3_config(d)).batch_size
    data = write_train_dataset(d / "dataset", batch)
    write_s = time.perf_counter() - t0
    ck = d / "ck"
    cfg_path = m3_config(d, epoch=1, train_model_save_epoch=1, async_checkpoint=True,
                         dataset_path=str(d / "dataset"), train_csv=str(data["Train"]),
                         val_csv=str(data["Val"]), train_model_save_path=str(ck))
    cfg = load_train_config(cfg_path)
    core = cfg.core_config()

    # the train loader alone on the host: with its augmentation, and the same
    # rows without it (train=False)
    aug_rate = loader_rate(get_train_loader(cfg, core_cfg=core))
    plain_rate = loader_rate(DataLoader(valid_dataset(cfg, str(data["Train"]), core_cfg=core),
                                        cfg.batch_size, num_workers=cfg.num_workers))

    # the main path once, counted: each step's device time by CUDA events
    steps = []
    make = trainer_mod.make_train_step

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(*sa, **skw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t_call = time.perf_counter()
            start.record()
            out = step(*sa, **skw)
            end.record()
            steps.append((t_call, start, end))
            return out
        return timed

    trainer_mod.make_train_step = timed_make
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            trainer = train_cli.main(["--config", str(cfg_path)])
    finally:
        trainer_mod.make_train_step = make
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    want = {k: TRAIN_FILES_STEPS * TRAIN_PER_STEP.get(k, 0) + EVAL_PER_BATCH[k]
            for k in EVAL_PER_BATCH}
    if counts != want or trainer.state.step != TRAIN_FILES_STEPS:
        fail(f"phase 43: {trainer.state.step} steps, launches {counts}, expected {want} "
             f"({TRAIN_FILES_STEPS} steps and one val batch)")
    per_step = {k: (counts[k] - EVAL_PER_BATCH[k]) / TRAIN_FILES_STEPS for k in counts}
    step_ms = [s.elapsed_time(e) for _, s, e in steps]
    loop_s = [b[0] - a[0] for a, b in zip(steps, steps[1:])]
    log = "\n".join(f.read_text() for f in sorted((ck / "logs").glob("*.log")))
    losses = [float(x.split("]")[0]) for x in log.split("[BLoss: ")[1:]]
    if not losses or not np.all(np.isfinite(losses)) or "[Val Info]: Epoch: 1," not in log:
        fail(f"phase 43: losses {losses}; the val line is {'' if '[Val Info]' in log else 'not '}"
             "there")
    params = {k: v.detach().cpu() for k, v in trainer.state.model.state_dict().items()}
    blocked = dict(trainer.save_seconds)
    for name in ("checkpoint_epoch_1", "best_model", "best_model_full"):
        saved = restore_checkpoint(ck, name)
        if sorted(saved["params"]) != sorted(params) or not all(
                torch.equal(saved["params"][k], v) for k, v in params.items()):
            fail(f"phase 43: {name}'s params are not the trained model's")
        if name != "best_model" and (saved["step"] != TRAIN_FILES_STEPS or "opt_state" not in saved):
            fail(f"phase 43: {name} is not a full training state: {sorted(saved)}")
        del saved

    # the seconds a save holds the loop, without and with the async writer,
    # on the same full training state
    trainer.ckpt = CheckpointWriter(async_save=False)
    trainer._save("probe_sync", 1)
    trainer.ckpt = CheckpointWriter(async_save=True)
    trainer._save("probe_async", 1)
    t0 = time.perf_counter()
    trainer.ckpt.wait()
    async_write_s = time.perf_counter() - t0
    probe = {"sync_blocks_s": trainer.save_seconds["probe_sync"],
             "async_blocks_s": trainer.save_seconds["probe_async"],
             "async_write_after_s": async_write_s,
             "state_gib": sum(f.stat().st_size for f in (ck / "probe_sync").iterdir()) / 2**30}
    for name in ("probe_sync", "probe_async"):
        shutil.rmtree(ck / name)

    # warm steps on one batch of the loader: s/step by CUDA events, peak memory
    one = trainer._device_batch(next(iter(get_train_loader(cfg, core_cfg=core))))
    torch.cuda.reset_peak_memory_stats()
    warm = []
    for _ in range(TRAIN_WARM_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_step(trainer.state, one, cfg.lr)
        end.record()
        torch.cuda.synchronize()
        warm.append(start.elapsed_time(end))
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del trainer, one
    torch.cuda.empty_cache()

    # the same path again: it resumes from checkpoint_epoch_1 (epoch 1 done)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        again = train_cli.main(["--config", str(cfg_path)])
    resume_s = time.perf_counter() - t0
    log = "\n".join(f.read_text() for f in sorted((ck / "logs").glob("*.log")))
    if "Resumed from checkpoint_epoch_1 at epoch 2" not in log or again.state.step != 2:
        fail(f"phase 43: the second run did not resume (step {again.state.step})")
    if not all(torch.equal(v.cpu(), params[k]) for k, v in again.state.model.state_dict().items()):
        fail("phase 43: the resumed model is not the saved one")
    del again, params
    torch.cuda.empty_cache()

    # cli.eval --visualize on best_model
    out_dir = d / "eval_out"
    eval_cfg = flat_config("vaild_config.yaml", d / "eval.yaml", dataset_path=str(d / "dataset"),
                           val_csv_A=str(data["Val"]), val_csv_B="",
                           vaild_model_save_path=str(out_dir),
                           load_checkpoint_path=str(ck / "best_model"))
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        res = eval_cli.main(["--config", str(eval_cfg), "--visualize", str(PANELS)])["Test_1"]
    eval_s = time.perf_counter() - t0
    eval_counts = {k: v for k, v in read_counts().items() if v}
    if eval_counts != EVAL_PER_BATCH or res["skipped"] or len(res["hard"]) != batch:
        fail(f"phase 43: cli.eval launches {eval_counts}, {len(res['hard'])} masks, "
             f"{res['skipped']} skipped")
    shape = (256 + 2 * 10 + 5 * 12 + 2 * 10, 5 * 256 + 6 * 10, 3)  # 5 caption lines
    panels = sorted((out_dir / "Test_1" / "visualizations").glob("*.png"))
    if [p.name for p in panels] != sorted(p.name for p in res["panels"]) or len(panels) != PANELS:
        fail(f"phase 43: panels {panels}")
    for path in panels:
        img = read_image(path, "RGB")
        # the query, its GT, the support image and its mask are never uniform
        # (the prediction of random weights may be)
        if img.shape != shape or not all(img[10:266, x:x + 256].std() > 0
                                         for x in (10, 276, 808, 1074)) or img[276:].min() != 0:
            fail(f"phase 43: the panel {path.name} is {img.shape} (expected {shape}), or a "
                 f"panel is blank or the caption missing")

    out = {
        "card": smi, "model": f"{core.sam_model} + {core.siglip_model}, {core.compute_dtype}, "
                              f"freeze_towers {cfg.freeze_towers}",
        "batch_size": cfg.batch_size, "train_rows": TRAIN_FILES_STEPS * batch, "val_rows": batch,
        "native_hw": EVAL_NATIVE_HW, "dataset_write_s": write_s,
        "loader_samples_per_s": {"augmented": aug_rate, "without_augmentation": plain_rate},
        "main_s": main_s, "step_device_ms": step_ms, "loop_s_between_steps": loop_s,
        "losses": losses, "launches": counts, "launches_per_step": per_step,
        "save_blocks_s_in_the_run": blocked, "save_probe": probe,
        "warm_step_ms": warm, "warm_s_per_step": statistics.median(warm) / 1e3,
        "warm_samples_per_s": cfg.batch_size / (statistics.median(warm) / 1e3),
        "peak_gib": peak_gib, "resume_main_s": resume_s, "eval_visualize_s": eval_s,
        "panels": [p.name for p in panels], "panel_shape": shape,
    }
    print(f"  train loader (host, {cfg.num_workers} threads): {aug_rate:.1f} samples/s with "
          f"the augmentation, {plain_rate:.1f} without; cli.train on the manifest "
          f"({TRAIN_FILES_STEPS} steps of {cfg.batch_size}, one val batch, async checkpoints): "
          f"main() {main_s:.1f} s, steps {[round(x, 1) for x in step_ms]} ms (device, CUDA "
          f"events), {[round(x, 2) for x in loop_s]} s between step starts; warm "
          f"{out['warm_s_per_step']:.3f} s/step ({out['warm_samples_per_s']:.1f} samples/s, "
          f"peak {peak_gib:.1f} GiB); launches per step {per_step}; saves held the loop "
          f"{ {k: round(v, 2) for k, v in blocked.items()} } s; a full state "
          f"({probe['state_gib']:.2f} GiB): {probe['sync_blocks_s']:.2f} s written in the loop, "
          f"{probe['async_blocks_s']:.2f} s with the async writer (its write "
          f"{probe['async_write_after_s']:.2f} s after); resumed main() {resume_s:.1f} s; "
          f"cli.eval --visualize {PANELS} {eval_s:.1f} s; {smi}", flush=True)
    print(json.dumps({"train_from_files": out}))
    print("phase 43 training from files: ok", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this check runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)
    # before any output: without the repository beside it, the script stops here
    import cor_tpu_torch.retrieval.index  # noqa: F401

    name, smi = phase_device()
    phase_build()
    phase_gpu_tests()
    mark("phase 2")
    memoize_seeded_inits()
    cuda = torch.device("cuda")
    # the kernel-check phases take TF32 off for themselves; every other phase
    # runs under torch's flags as a user's run finds them
    with phase_flags("phase 3", tf32_off=True):
        kernel_results = phase_kernels(cuda)

    with phase_flags("phases 4-6", tf32_off=False), tempfile.TemporaryDirectory() as d:
        pair_ids = save_synthetic_gallery(d)
        servers, launches = phase_serve(d, pair_ids)
        phase_numerics(servers["fp32"])
        phase_timings(servers["fp32"], smi)
    del servers
    mark("phases 1-6")

    with phase_flags("phases 7-9", tf32_off=False), tempfile.TemporaryDirectory() as d:
        d = Path(d)
        t0 = time.perf_counter()
        store_ids = write_store_index(d / "index")
        print(f"  store index: {STORE_ROWS} x {GRID} x {GRID} x {SAM_C} fp16 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        dec_servers, dec_launches, _ = phase_decode_serve(d / "index", store_ids, d / "masks")
        phase_decode_numerics(dec_servers["host"], d / "index")
        phase_decode_timings(dec_servers, smi)
    del dec_servers
    mark("phases 7-9")

    with phase_flags("phase 10", tf32_off=True):
        enc_kernels, ln_sam = phase_encoder_kernels(cuda)
    kernel_results["vit_attention_relpos"] = enc_kernels
    kernel_results["layer_norm"]["sam_encoder_shapes"] = ln_sam
    with phase_flags("phases 11-13", tf32_off=False):
        with tempfile.TemporaryDirectory() as d:
            build_launches, _ = phase_build_index(Path(d) / "index")
        enc_gpu, _, _ = phase_encoder_numerics()
        phase_build_timings(enc_gpu, smi)
    del enc_gpu
    torch.cuda.empty_cache()
    mark("phases 10-13")

    with phase_flags("phase 14", tf32_off=True):
        kernel_results["vit_attention_relpos_bwd"] = phase_k6b(cuda)
    with phase_flags("phases 15-17", tf32_off=False):
        with tempfile.TemporaryDirectory() as d:
            train_launches, _, _ = phase_train(Path(d))
        phase_train_numerics()
        phase_train_timings(smi)
    mark("phases 14-17")

    with phase_flags("phase 18", tf32_off=True):
        k4_72, k6_80, ln_large = phase_large_kernels(cuda)
    kernel_results["attention_seq_qkv@72"] = k4_72
    kernel_results["vit_attention_relpos@80"] = k6_80
    kernel_results["layer_norm"]["large_config_shapes"] = ln_large
    with phase_flags("phases 19-22", tf32_off=False):
        large_serve, large_build = phase_large(smi)
    mark("phases 18-22")

    with phase_flags("phases 23-24", tf32_off=True):
        kernel_results["vit_attention_relpos_bwd@80"] = phase_k6b(cuda, 16, 80, phase=23)
        kernel_results["vit_attention_relpos_windows"] = phase_k7(cuda)
    with phase_flags("phase 25", tf32_off=False):
        k7_launches = phase_k7_encoders(smi)
    mark("phases 23-25")
    with phase_flags("phases 26-28", tf32_off=False):
        large_train = phase_large_train(smi)
    mark("phases 26-28")

    with phase_flags("phase 29", tf32_off=True):
        kernel_results.update(phase_fp32_kernels(cuda))
    with phase_flags("phases 30-31", tf32_off=False), tempfile.TemporaryDirectory() as d:
        server32, enc32, index32, ids32, fp32_launches = phase_fp32_paths(Path(d))
        k7_fp32 = phase_fp32_timings(server32, enc32, index32, ids32, Path(d), smi)
        del server32, enc32
    torch.cuda.empty_cache()
    mark("phases 29-31")
    with phase_flags("phase 32", tf32_off=False):
        large32 = phase_large_fp32(smi)
    mark("phase 32")

    with phase_flags("phase 33", tf32_off=True):
        token_kernels = phase_token_kernels(cuda)
    for key in ("two_way_layer", "t2i_flash_kv", "two_way_layer@fp32", "t2i_flash_kv@fp32"):
        kernel_results[key]["at_tokens"] = token_kernels.pop(f"{key} at_tokens")
    kernel_results.update(token_kernels)
    mark("phase 33")
    with phase_flags("phase 34", tf32_off=False):
        prompt_launches = phase_prompts(smi)
    mark("phase 34")
    with phase_flags("phase 35", tf32_off=True):
        schedule_kernels, schedule_decodes = phase_decode_schedules(cuda, smi)
    kernel_results.update(schedule_kernels)
    mark("phase 35")
    with phase_flags("phase 36", tf32_off=False):
        schedule_launches_ = phase_decode_bench(smi)
    mark("phase 36")
    with phase_flags("phase 37", tf32_off=True):
        last_kernels, last_launches = phase_last_kernels(cuda)
    kernel_results.update(last_kernels)
    mark("phase 37")
    with phase_flags("phase 38", tf32_off=False):
        phase_p6(cuda)
    mark("phase 38")
    with phase_flags("phases 39-40", tf32_off=False), tempfile.TemporaryDirectory() as d:
        index_dir = phase_protocol(Path(d), smi)
        mark("phase 39")
        phase_tcp(index_dir, Path(d), smi)
    mark("phase 40")
    with phase_flags("phases 41-42", tf32_off=False), tempfile.TemporaryDirectory() as d:
        pth = phase_checkpoints(Path(d), smi)
        mark("phase 41")
        phase_eval(Path(d), pth, smi)
    mark("phase 42")
    with phase_flags("phase 43", tf32_off=False), tempfile.TemporaryDirectory() as d:
        phase_train_from_files(Path(d), smi)
    mark("phase 43")

    sources = {
        "layer_norm": ("cor_tpu_torch/csrc/layernorm.cuh", "cor_tpu/ops/pallas/layernorm.py:70",
                       launches),
        "attention_seq_qkv": ("cor_tpu_torch/csrc/seq_attention.cu",
                              "cor_tpu/ops/pallas/seq_attention.py:99", launches),
        "two_way_layer": ("cor_tpu_torch/csrc/two_way_layer.cu",
                          "cor_tpu/ops/pallas/two_way_layer.py:978", dec_launches),
        "t2i_flash_kv": ("cor_tpu_torch/csrc/t2i_final.cu",
                         "cor_tpu/ops/pallas/t2i_flash.py:220", dec_launches),
        "decoder_tail": ("cor_tpu_torch/csrc/decoder_tail.cu",
                         "cor_tpu/ops/pallas/decoder_tail.py:150", dec_launches),
        "vit_attention_relpos": ("cor_tpu_torch/csrc/vit_attention.cu",
                                 "cor_tpu/ops/pallas/vit_attention.py:284", build_launches),
        "vit_attention_relpos_bwd": ("cor_tpu_torch/csrc/vit_attention_bwd_wgmma.cuh",
                                     "cor_tpu/ops/pallas/vit_attention.py:459",
                                     train_launches["unfrozen"]),
        # the largest configuration's paths: K4′ is the same kernel at head_dim
        # 72, launched by the towers through the fused-QKV entry; K6 at 80
        "attention_seq_qkv@72": ("cor_tpu_torch/csrc/seq_attention.cu",
                                 "cor_tpu/ops/pallas/seq_attention.py:49", large_serve),
        "vit_attention_relpos@80": ("cor_tpu_torch/csrc/vit_attention.cu",
                                    "cor_tpu/ops/pallas/vit_attention.py:284", large_build),
        # unfrozen training at CFG (cli.train), and the sam_huge encoder with
        # fused_window_indexing (make_candidate_encoder, one batch of 8)
        "vit_attention_relpos_bwd@80": ("cor_tpu_torch/csrc/vit_attention_bwd_wgmma.cuh",
                                        "cor_tpu/ops/pallas/vit_attention.py:459", large_train),
        "vit_attention_relpos_windows": ("cor_tpu_torch/csrc/vit_attention.cu",
                                         "cor_tpu/ops/pallas/vit_attention.py:180", k7_launches),
        # compute_dtype float32 (phases 29-31): the fp32 instantiations of the
        # same sources, launched by the fp32 build, serving and frozen training
        "layer_norm@fp32": ("cor_tpu_torch/csrc/layernorm.cuh",
                            "cor_tpu/ops/pallas/layernorm.py:70", fp32_launches["serve"]),
        "attention_seq_qkv@fp32": ("cor_tpu_torch/csrc/seq_attention.cu",
                                   "cor_tpu/ops/pallas/seq_attention.py:99",
                                   fp32_launches["serve"]),
        "vit_attention_relpos@fp32": ("cor_tpu_torch/csrc/vit_attention_f32.cuh",
                                      "cor_tpu/ops/pallas/vit_attention.py:284",
                                      fp32_launches["build"]),
        # unfrozen fp32 training at the flagship (phase 30's cli.train)
        "vit_attention_relpos_bwd@fp32": ("cor_tpu_torch/csrc/vit_attention_bwd.cu",
                                          "cor_tpu/ops/pallas/vit_attention.py:459",
                                          fp32_launches["train"]),
        # the largest configuration's fp32 paths (phase 32): the SO400M towers
        # served, the sam_huge build, unfrozen training
        "attention_seq_qkv@72@fp32": ("cor_tpu_torch/csrc/seq_attention.cu",
                                      "cor_tpu/ops/pallas/seq_attention.py:49",
                                      large32["serve"]),
        "vit_attention_relpos@80@fp32": ("cor_tpu_torch/csrc/vit_attention_f32.cuh",
                                         "cor_tpu/ops/pallas/vit_attention.py:284",
                                         large32["build"]),
        "vit_attention_relpos_bwd@80@fp32": ("cor_tpu_torch/csrc/vit_attention_bwd.cu",
                                             "cor_tpu/ops/pallas/vit_attention.py:459",
                                             large32["train"]),
        "vit_attention_relpos_windows@fp32": ("cor_tpu_torch/csrc/vit_attention_f32.cuh",
                                              "cor_tpu/ops/pallas/vit_attention.py:180",
                                              k7_fp32),
        "two_way_layer@fp32": ("cor_tpu_torch/csrc/two_way_layer.cu",
                               "cor_tpu/ops/pallas/two_way_layer.py:978",
                               fp32_launches["serve"]),
        "t2i_flash_kv@fp32": ("cor_tpu_torch/csrc/t2i_final.cu",
                              "cor_tpu/ops/pallas/t2i_flash.py:220", fp32_launches["serve"]),
        "decoder_tail@fp32": ("cor_tpu_torch/csrc/decoder_tail.cu",
                              "cor_tpu/ops/pallas/decoder_tail.py:150", fp32_launches["serve"]),
        # SAM's stock prompts (phase 34): K8a and K8b above 8 tokens, bf16 and fp32
        "proj_q_t2i_flash": ("cor_tpu_torch/csrc/t2i_proj_q.cu",
                             "cor_tpu/ops/pallas/t2i_flash.py:163", prompt_launches),
        "proj_q_t2i_flash@fp32": ("cor_tpu_torch/csrc/t2i_proj_q.cu",
                                  "cor_tpu/ops/pallas/t2i_flash.py:163", prompt_launches),
        "i2t_attention_fused": ("cor_tpu_torch/csrc/twl_i2t.cu",
                                "cor_tpu/ops/pallas/i2t_attention.py:105", prompt_launches),
        "i2t_attention_fused@fp32": ("cor_tpu_torch/csrc/twl_i2t.cu",
                                     "cor_tpu/ops/pallas/i2t_attention.py:105", prompt_launches),
        # the opt-in decode schedules: decode_bench in bf16 (phase 36), the
        # fp32 decodes of phase 35
        "two_way_layer_dma": ("cor_tpu_torch/csrc/two_way_layer_dma.cu",
                              "cor_tpu/ops/pallas/two_way_layer.py:610", schedule_launches_),
        "two_way_layer_dma@fp32": ("cor_tpu_torch/csrc/two_way_layer_dma.cu",
                                   "cor_tpu/ops/pallas/two_way_layer.py:610", schedule_decodes),
        "two_way_stack_fused": ("cor_tpu_torch/csrc/two_way_stack.cuh",
                                "cor_tpu/ops/pallas/two_way_layer.py:1236", schedule_launches_),
        "two_way_stack_fused@fp32": ("cor_tpu_torch/csrc/two_way_stack.cuh",
                                     "cor_tpu/ops/pallas/two_way_layer.py:1236",
                                     schedule_decodes),
        "two_way_grid_fused": ("cor_tpu_torch/csrc/two_way_stack.cuh",
                               "cor_tpu/ops/pallas/two_way_layer.py:1135", schedule_launches_),
        "two_way_grid_fused@fp32": ("cor_tpu_torch/csrc/two_way_stack.cuh",
                                    "cor_tpu/ops/pallas/two_way_layer.py:1135",
                                    schedule_decodes),
        # the last two TPU kernels, whose only callers are tests: phase 37's
        # calls of their entry points
        "add_layer_norm": ("cor_tpu_torch/csrc/layernorm_add.cu",
                           "cor_tpu/ops/pallas/layernorm.py:100", last_launches),
        "add_layer_norm@fp32": ("cor_tpu_torch/csrc/layernorm_add.cu",
                                "cor_tpu/ops/pallas/layernorm.py:100", last_launches),
        "fused_upscale2_hyper": ("cor_tpu_torch/csrc/upscale.cu",
                                 "cor_tpu/ops/pallas/upscale.py:104", last_launches),
        "fused_upscale2_hyper@fp32": ("cor_tpu_torch/csrc/upscale.cu",
                                      "cor_tpu/ops/pallas/upscale.py:104", last_launches),
    }
    kernels = []
    for kname, res in kernel_results.items():
        src, replaces, counts = sources[kname]
        # the counts' key: the wrapper's name, and @fp32 for an fp32 instantiation
        key = kname.split("@")[0] + ("@fp32" if kname.endswith("@fp32") else "")
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[key], **res})
    idle = [k["name"] for k in kernels if not k["launches"] >= 1]
    if idle:
        fail(f"kernels that no path of this run launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
