#!/usr/bin/env python3
"""Drive cor_tpu_torch once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; no phase catches an exception):
 1. device: the card's name and power limit (nvidia-smi), TF32 switched off;
 2. build: every CUDA kernel from cor_tpu_torch/csrc (one nvcc per source,
    in parallel), with each kernel's registers and spills from ptxas;
 3. kernels: each kernel against its plain PyTorch version on identical bf16
    inputs at the serving path's shapes (K4, K5: batch 16 of
    ViT-B-16-SigLIP-384; K1, K2, K3: 40 candidates of the SAM-base decoder
    on the 64 x 64 grid, K1's layer 0 out of a 2,048-row int8 store), both
    timed with CUDA events beside the one PyTorch call that computes the
    same function where there is one (SDPA for K4, F.layer_norm for K5);
 4. serve: a synthetic 127,166 x 256 gallery index (the COR127K triplet
    count), then ``cor_tpu_torch.cli.serve.main`` with --self-test 8 at full
    ViT-B-16-SigLIP-384 width (random weights from seed 0), fp32 and --int8
    scans; checks every response and the kernels' launch counts;
 5. numerics: GPU bf16 queries against the same weights' CPU fp32 queries,
    per-query cosine >= 0.99;
 6. timings: encode+scan latency per batch bucket (1, 4, 16) and responses/s
    of the self-test loop, with the card's name and power limit;
 7. decode serve: a synthetic 2,048-row index with a [2048, 64, 64, 256]
    fp16 store (4 GiB on disk, written in chunks), then ``cli.serve.main``
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
14. K6b: the backward kernel against its plain version at the global shape
    (qkv [2, 4096, 2304]) and the windowed one ([50, 196, 2304]), random
    bias factors and cotangent, max relative error <= 2e-2 for dqkv, drel_h
    and drel_w; timed beside the plain version and the autograd backward
    of SDPA with the materialised bias requiring grad;
15. training: ``cor_tpu_torch.cli.train.main --synthetic`` on
    configs/train_config_m3.yaml's keys (epoch 1: 4 steps at batch 10, a
    2-batch val epoch), frozen and with ``freeze_towers: false``: finite
    losses, the val metrics line, best_model and best_model_full written;
    frozen, the towers, the IoU head and the PE matrix bit-identical and no
    K6b launch; unfrozen, a leaf of each tower moved, K6b 12 launches per
    step and K6 24 (remat) plus 12 per val batch;
16. training numerics: one unfrozen step at full width, batch 1 (rel-pos
    tables and pos_embed filled from a seed, no dropout, "add" fusion), on
    the card in bf16 and on the CPU in fp32: loss within 2e-2, gradient
    cosine >= 0.99 for a windowed block's qkv, a global block's rel_pos_h,
    the patch embed, a SigLIP block's qkv and the decoder's first layer;
    then the decoder alone on the card in bf16 against fp32 over 3 seeds
    (each layer's q_proj gradient cosine, reported, not gated);
17. training timings at batch 10, frozen and unfrozen: seconds per step
    (CUDA events, median and spread of 6 steps), samples/s, peak memory,
    and a torch.profiler breakdown of one unfrozen step by layer.
The line before the last lists every kernel ({"kernels": [...]}); the last
line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
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
MASK_AGREE_MIN = 0.99  # host-streamed fp16 vs int8 store: pixels that agree
# H100 SXM peaks (NVIDIA data sheet, dense): the bounds of the kernel table
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOP_S = 989e12


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


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(f"phase 1 device: {name}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"python {sys.version.split()[0]}; "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)
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
    names = ("layer_norm_kernel", "seq_attention_qkv_kernel", "twl_tokens_in_kernel",
             "t2i_image_kernel", "twl_tokens_mid_kernel", "twl_image_i2t_kernel",
             "t2i_combine_kernel", "decoder_tail_kernel", "vit_attention_relpos_kernel")
    kernel, spills, regs = None, {}, {}
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
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
    return dt


def bound(n_bytes: float, flops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOP_S
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


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
                       cuda_ms(lambda: F.layer_norm(x, (768,), scale, bias, 1e-6)))
        print(f"  K5 layer_norm [{n}, 768] bf16: max|d|={err:.3e} kernel "
              f"{ln_t[tower][0][0]:.4f} ms, plain {ln_t[tower][1][0]:.4f} ms, "
              f"F.layer_norm {ln_t[tower][2][0]:.4f} ms")
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
    results["layer_norm"] = entry(ln_err, v[0], v[1], ln_bound, v[2])

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
                           cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v)))
            print(f"  K4 attention_seq_qkv [{BATCH}, {n}, 2304] bf16: max|d|={err:.3e} kernel "
                  f"{at_t[tower][0][0]:.4f} ms, plain {at_t[tower][1][0]:.4f} ms, "
                  f"SDPA {at_t[tower][2][0]:.4f} ms")
            if tower == "vision":
                at_bound = bound(nbytes(qkv) + nbytes(got), 4 * BATCH * 12 * n * n * 64)
        else:
            print(f"  K4 attention_seq_qkv [{BATCH}, {n}, 2304] bf16: max|d|={err:.3e}")
    if at_err > KERNEL_TOL:
        fail(f"attention_seq_qkv kernel disagrees with its plain version: {at_err}")
    v = at_t["vision"]
    results["attention_seq_qkv"] = entry(at_err, v[0], v[1], at_bound, v[2])
    results.update(decoder_kernels(device))
    print("phase 3 kernels: ok", flush=True)
    return results


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def abs_err(*pairs) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in pairs)


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
        k1[label] = entry(abs_err((got_t, want_t), (got_k, want_k)), kt, pt, b, max_rel_err=err)
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
    b = bound(nbytes(keys, kpe, q_tok, got) + 2 * I * C * 2,
              n * (2 * N * C * 2 * I + 4 * N * T * I))
    print(f"  K2 t2i_flash_kv [{n}, {N}, {C}]: max|d|/max|plain| = {err:.3e}; kernel "
          f"{kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]})")
    if not err <= DECODE_REL:
        fail(f"t2i_flash_kv kernel disagrees with its plain version: {err}")
    out["t2i_flash_kv"] = entry(abs_err((got, want)), kt, pt, b, max_rel_err=err)

    up = dec.output_upscaling
    src = keys.reshape(n, GRID, GRID, C)
    hyper = rnd(n, 1, 32).to(bf16)
    args = (src, up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b,
            hyper)
    got, want = decoder_tail(*args), decoder_tail_plain(*args)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    kt, pt = cuda_ms(lambda: decoder_tail(*args)), cuda_ms(lambda: decoder_tail_plain(*args))
    b = bound(nbytes(src, hyper, got), n * 2 * N * (C * 4 * 64 + 4 * 64 * 4 * 32))
    print(f"  K3 decoder_tail [{n}, {GRID}, {GRID}, {C}] -> {tuple(got.shape)}: max|d|/max|plain| "
          f"= {err:.3e}; kernel {kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, "
          f"bound {b[0]:.4f} ms ({b[1]})")
    if not err <= DECODE_REL:
        fail(f"decoder_tail kernel disagrees with its plain version: {err}")
    out["decoder_tail"] = entry(abs_err((got, want)), kt, pt, b, max_rel_err=err)
    del store
    torch.cuda.empty_cache()
    return out


def kernel_wrappers():
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.layernorm import layer_norm
    from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_bwd,
    )

    return {"layer_norm": layer_norm, "attention_seq_qkv": attention_seq_qkv,
            "two_way_layer": two_way_layer, "t2i_flash_kv": t2i_flash_kv,
            "decoder_tail": decoder_tail, "vit_attention_relpos": vit_attention_relpos,
            "vit_attention_relpos_bwd": vit_attention_relpos_bwd}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def phase_serve(index_dir, pair_ids):
    from cor_tpu_torch.cli import serve as cli

    ids = set(pair_ids.tolist())
    servers, counts = {}, {}
    for mode, extra in (("fp32", []), ("int8", ["--int8"])):
        argv = ["--gallery-index", index_dir, "--k", "10", "--max-batch", "4",
                "--self-test", "8", *extra]
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
        want = {"layer_norm": 50 * n, "attention_seq_qkv": 24 * n, "two_way_layer": 0,
                "t2i_flash_kv": 0, "decoder_tail": 0, "vit_attention_relpos": 0,
                "vit_attention_relpos_bwd": 0}
        print(f"  serve {mode}: {len(resps)} responses, {n} encoded batches (warmup included), "
              f"launches {c} (expected {want}), main() took {dt:.1f} s")
        if c != want or min(c["layer_norm"], c["attention_seq_qkv"]) == 0:
            fail(f"{mode}: kernel launch counts {c} != expected {want}")
        servers[mode], counts[mode] = server, c
        print(f"  first response ({mode}): {json.dumps(resps[0])[:300]}")
    print("phase 4 serve: ok", flush=True)
    return servers, counts["fp32"]


def phase_numerics(server):
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import init_support_branch
    from cor_tpu_torch.retrieval.index import make_query_encoder

    assembled = [server._synthetic_query(i) for i in range(4)]
    imgs, masks, texts = server._batch_tensors(assembled)
    q_gpu = server.encode_query(server.model, imgs, texts, masks).cpu()
    cfg = dataclasses.replace(EvalConfig().core_config(), compute_dtype="float32")
    model_cpu = init_support_branch(cfg, EvalConfig().seed)  # the weights main() served
    t0 = time.perf_counter()
    q_cpu = make_query_encoder(cfg)(model_cpu, imgs.cpu(), texts.cpu(), masks.cpu())
    dt = time.perf_counter() - t0
    cos = torch.nn.functional.cosine_similarity(q_gpu, q_cpu, dim=1)
    print(f"  GPU bf16 vs CPU fp32 query cosine per query: {[round(v, 6) for v in cos.tolist()]} "
          f"(CPU encode {dt:.1f} s)")
    if not torch.isfinite(q_gpu).all() or q_gpu.shape != (4, DIM):
        fail(f"GPU queries malformed: shape {tuple(q_gpu.shape)}")
    if cos.min().item() < COS_MIN:
        fail(f"GPU bf16 and CPU fp32 queries disagree: min cosine {cos.min().item()}")
    print(f"phase 5 numerics: ok, min cosine {cos.min().item():.6f}", flush=True)
    return cos.min().item()


def phase_timings(server, smi):
    assembled = [server._synthetic_query(i) for i in range(16)]
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
        "timings": {
            "encode_scan_ms_by_bucket": latency,
            "self_test_responses_per_s": {"median": statistics.median(rps),
                                          "min": min(rps), "max": max(rps)},
            "gallery_rows": GALLERY_ROWS, "k": 10, "scan": "fp32",
            "card": smi,
        }
    }
    print(json.dumps(out))
    print("phase 6 timings: ok", flush=True)


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
    for s in range(0, STORE_ROWS, 128):
        store[s:s + 128] = (0.5 * rng.standard_normal((128, *shape[1:]), dtype=np.float32)
                            ).astype(np.float16)
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


def serve_masks(index_dir: Path, ids: set, out_dir: Path, mode: str, extra: list):
    """``cli.serve.main`` --decode-masks with --self-test 8, --max-batch 4,
    --k 10 (and ``extra``) on the index: every response and PNG checked, the
    kernels' launches per decoded batch checked. Returns (server, launches,
    {png name: mask})."""
    from cor_tpu_torch.cli import serve as cli
    from cor_tpu_torch.ops.kernels import t2i_flash, two_way_layer

    argv = ["--gallery-index", str(index_dir), "--k", "10", "--max-batch", "4",
            "--self-test", "8", "--decode-masks", str(out_dir), *extra]
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
    want = {"layer_norm": 50 * e, "attention_seq_qkv": 24 * e,
            "two_way_layer": two_way_layer.LAUNCHES * 2 * d,
            "t2i_flash_kv": t2i_flash.LAUNCHES * d, "decoder_tail": d, "vit_attention_relpos": 0,
            "vit_attention_relpos_bwd": 0}
    fg = np.mean([m.mean() / 255 for m in masks.values()])
    print(f"  decode serve {mode}: {len(resps)} responses, {e} encoded batches, {d} decode "
          f"calls (warmup included), launches {c} (expected {want}), foreground share "
          f"{fg:.4f}, main() took {dt:.1f} s")
    if c != want or min(v for k, v in c.items() if not k.startswith("vit_attention")) == 0:
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
def phase_decode_numerics(server, index_dir: Path):
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import init_decode_model
    from cor_tpu_torch.retrieval.index import load_gallery_index, make_candidate_mask_decoder

    assembled = [server._synthetic_query(i) for i in range(4)]
    imgs, masks, texts = server._batch_tensors(assembled)
    feats = server.encode_query(server.model, imgs, texts, masks)
    rows = np.asarray(load_gallery_index(index_dir)["store"][[3, 100, 1000, 2047]])
    gpu = make_candidate_mask_decoder(server.cfg)(
        server.decode_model, torch.from_numpy(rows).cuda(), feats).cpu()
    cfg = dataclasses.replace(EvalConfig().core_config(), compute_dtype="float32")
    model_cpu = init_decode_model(cfg, EvalConfig().seed)  # the weights main() served
    t0 = time.perf_counter()
    cpu = make_candidate_mask_decoder(cfg)(model_cpu, torch.from_numpy(rows), feats.cpu())
    dt = time.perf_counter() - t0
    cos = torch.nn.functional.cosine_similarity(gpu.flatten(1), cpu.flatten(1), dim=1)
    agree = ((gpu > 0) == (cpu > 0)).float().mean().item()
    print(f"  GPU bf16 vs CPU fp32 decode, per-candidate logit cosine: "
          f"{[round(v, 6) for v in cos.tolist()]}; mask pixels agreeing {agree:.6f} "
          f"(CPU decode {dt:.1f} s)")
    if gpu.shape != (4, 1, 4 * GRID, 4 * GRID) or not torch.isfinite(gpu).all():
        fail(f"GPU decode malformed: shape {tuple(gpu.shape)}")
    if cos.min().item() < COS_MIN:
        fail(f"GPU bf16 and CPU fp32 decodes disagree: min cosine {cos.min().item()}")
    print(f"phase 8 decode numerics: ok, min cosine {cos.min().item():.6f}", flush=True)
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
# first group that matches takes the kernel)
KERNEL_GROUPS = (
    ("K1 two_way_layer", ("twl_", "t2i_image_kernel<true, true>", "t2i_image_kernel<false, true>")),
    ("K2 t2i_flash_kv", ("t2i_image_kernel", "t2i_combine")),
    ("K3 decoder_tail", ("decoder_tail_kernel",)),
    ("K4 attention_seq_qkv", ("seq_attention",)),
    ("K5 layer_norm", ("layer_norm_kernel",)),
    ("K6b vit_attention_relpos_bwd", ("vit_attention_bwd",)),
    ("K6 vit_attention_relpos", ("vit_attention_relpos",)),
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


def phase_build_index(index_dir: Path):
    """cli.index.main at full SAM-base width, checked; then --decode-masks
    --store-hbm serving from the index it wrote."""
    from cor_tpu_torch.cli import index as cli
    from cor_tpu_torch.retrieval.index import load_gallery_index

    argv = ["--out", str(index_dir), "--synthetic", str(BUILD_ROWS),
            "--batch-size", str(SAM_BATCH), "--with-store"]
    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    dt = time.perf_counter() - t0
    c = read_counts()
    batches = -(-BUILD_ROWS // SAM_BATCH)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    want_line = {"rows": BUILD_ROWS, "dim": SAM_C, "with_store": True, "out": str(index_dir)}
    if line != want_line:
        fail(f"index: the JSON line {line} != {want_line}")
    idx = load_gallery_index(index_dir)
    emb, store = idx["embeddings"], np.asarray(idx["store"])
    norms = np.linalg.norm(emb, axis=1)
    print(f"  index build: {json.dumps(line)} in {dt:.1f} s; row norms [{norms.min():.6f}, "
          f"{norms.max():.6f}], store {store.shape} {store.dtype}, |store| max "
          f"{np.abs(store.astype(np.float32)).max():.3f}")
    if emb.shape != (BUILD_ROWS, SAM_C) or not np.allclose(norms, 1.0, atol=1e-3):
        fail(f"index: embeddings {emb.shape} are not {BUILD_ROWS} unit rows")
    if store.shape != (BUILD_ROWS, GRID, GRID, SAM_C) or store.dtype != np.float16 or not (
            np.isfinite(store).all()):
        fail(f"index: the store is {store.shape} {store.dtype}, or not finite")
    want = {k: 0 for k in c}
    want.update(vit_attention_relpos=12 * batches, layer_norm=26 * batches)
    print(f"  index build launches {c} over {batches} encoded batches (expected {want})")
    if c != want:
        fail(f"index: kernel launch counts {c} != expected {want}")
    _, dec_counts, _ = serve_masks(index_dir, set(idx["pair_ids"].tolist()),
                                   index_dir.parent / "built_masks", "hbm, built index",
                                   ["--store-hbm"])
    print("phase 11 gallery build: ok", flush=True)
    return c, dt


def filled_encoder(cfg):
    """The CLI's image encoder (seed + 2) with its rel-pos tables and
    pos_embed filled with seeded normals x 0.3 (zeros at init)."""
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import init_image_encoder

    enc = init_image_encoder(cfg, EvalConfig().seed + 2)
    gen = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        for name, prm in enc.named_parameters():
            if "rel_pos" in name or name == "pos_embed":
                prm.copy_(0.3 * torch.randn(prm.shape, generator=gen))
    return enc


def synthetic_batch(n: int):
    """n synthetic samples of the served config (the build's data)."""
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.data.pipeline import collate
    from cor_tpu_torch.data.synthetic import SyntheticDataset

    cfg = EvalConfig().core_config()
    sig = cfg.support.siglip
    ds = SyntheticDataset(length=n, query_img_size=cfg.encoder.img_size,
                          support_img_size=sig.vision.image_size,
                          context_length=sig.text.context_length,
                          vocab_size=sig.text.vocab_size, seed=SEED)
    return collate([ds[i] for i in range(n)])


def phase_encoder_numerics():
    import copy

    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.models.core_model import _cast, core_forward, init_core_model
    from cor_tpu_torch.retrieval.index import make_candidate_encoder

    cfg = EvalConfig().core_config()
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    enc = filled_encoder(cfg).eval()
    b = synthetic_batch(2)
    img, mask = torch.from_numpy(b["query_img"][:1]), torch.from_numpy(b["query_mask"][:1])
    enc_gpu = _cast(copy.deepcopy(enc).cuda(), cfg.dtype)
    pooled_g, emb_g = make_candidate_encoder(cfg)(enc_gpu, img.cuda(), mask.cuda())
    t0 = time.perf_counter()
    pooled_c, emb_c = make_candidate_encoder(cfg32)(enc, img, mask)
    dt = time.perf_counter() - t0
    cos_flat = torch.nn.functional.cosine_similarity(
        emb_g.cpu().flatten()[None], emb_c.flatten()[None]).item()
    cos_pool = torch.nn.functional.cosine_similarity(pooled_g.cpu(), pooled_c).item()
    print(f"  encoder GPU bf16 vs CPU fp32: cosine {cos_flat:.6f} flattened, {cos_pool:.6f} "
          f"pooled (CPU encode {dt:.1f} s)")
    if emb_g.shape != (1, GRID, GRID, SAM_C) or not torch.isfinite(emb_g).all():
        fail(f"GPU encoder output malformed: {tuple(emb_g.shape)}")
    if min(cos_flat, cos_pool) < COS_MIN:
        fail(f"GPU bf16 and CPU fp32 encoders disagree: cosines {cos_flat}, {cos_pool}")

    # core_forward at full width, batch 2, the filled encoder in place
    model = init_core_model(cfg, SEED)
    model.image_encoder = enc
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
    print("phase 12 encoder numerics: ok", flush=True)
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
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(io.StringIO()):
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


def phase_k6b(device):
    """K6b against its plain backward at the global and windowed shapes,
    timed beside the plain version and SDPA's autograd backward with the
    materialised bias requiring grad."""
    import torch.nn.functional as F

    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos_bwd,
        vit_attention_relpos_bwd_plain,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=device)  # noqa: E731
    bf16 = torch.bfloat16
    out = {}
    for label, B, side in (("global", 2, GRID), ("windowed", 50, 14)):
        N = side * side
        qkv = rnd(B, N, 3 * 768).to(bf16)
        rel_h, rel_w = (0.3 * rnd(B, 12, N, side)).to(bf16), (0.3 * rnd(B, 12, N, side)).to(bf16)
        do = rnd(B, N, 768).to(bf16)
        args = (qkv, rel_h, rel_w, do, 12, (side, side))
        got = vit_attention_relpos_bwd(*args)
        want = vit_attention_relpos_bwd_plain(*args)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        err_abs = abs_err(*zip(got, want))
        if not all(torch.isfinite(g.float()).all() for g in got) or max(errs) > DECODE_REL:
            fail(f"vit_attention_relpos_bwd ({label}) disagrees with its plain version: "
                 f"dqkv {errs[0]}, drel_h {errs[1]}, drel_w {errs[2]}")
        kt = cuda_ms(lambda: vit_attention_relpos_bwd(*args))
        pt = cuda_ms(lambda: vit_attention_relpos_bwd_plain(*args), windows=3, iters=2)
        del want
        # the library call: autograd's backward of SDPA with the additive
        # [B, heads, N, N] bias, both requiring grad (the graph built once)
        q, k, v = (qkv[..., i * 768:(i + 1) * 768].unflatten(-1, (12, 64)).transpose(1, 2)
                   .detach().requires_grad_() for i in range(3))
        bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(B, 12, N, N).requires_grad_()
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        do4 = do.unflatten(-1, (12, 64)).transpose(1, 2)
        lt = cuda_ms(lambda: torch.autograd.grad(o, (q, k, v, bias), do4, retain_graph=True),
                     windows=5, iters=3)
        del o, bias, q, k, v
        # the five N x N x 64 products the gradient needs: the logits' recompute
        # q k^T, do v^T, a^T do, dl k and dl^T q
        flops = 5 * 2 * N * N * 64 * B * 12
        b = bound(nbytes(qkv, rel_h, rel_w, do) + nbytes(*got), flops)
        print(f"  K6b vit_attention_relpos_bwd {label} [{B}, {N}, 2304]: max|d|/max|plain| = "
              f"dqkv {errs[0]:.3e}, drel_h {errs[1]:.3e}, drel_w {errs[2]:.3e}; kernel "
              f"{kt[0]:.4f} ms [{kt[1]:.4f}, {kt[2]:.4f}], plain {pt[0]:.4f} ms, SDPA backward "
              f"with the bias {lt[0]:.4f} ms, bound {b[0]:.4f} ms ({b[1]})", flush=True)
        out[label] = entry(err_abs, kt, pt, b, lt, max_rel_err=max(errs))
        del got
        torch.cuda.empty_cache()
    print("phase 14 K6b: ok", flush=True)
    return dict(out["global"], windowed=out["windowed"])


def m3_config(d: Path, **overrides) -> Path:
    """configs/train_config_m3.yaml's keys, with ``overrides``, as a file."""
    from cor_tpu_torch.config import read_flat_yaml

    keys = read_flat_yaml((Path(__file__).resolve().parent / "configs" /
                           "train_config_m3.yaml").read_text())
    keys.update(overrides)
    path = d / "train.yaml"
    path.write_text("".join(f"{k}: {json.dumps(v)}\n" for k, v in keys.items()))
    return path


TOWERS = ("image_encoder.", "support_branch.siglip.", "mask_decoder.iou_prediction_head.",
          "prompt_encoder.pe_layer.")


def phase_train(root: Path):
    """cli.train.main --synthetic at full width on m3's keys, frozen and
    unfrozen; the launch counts of each run."""
    from cor_tpu_torch.cli import train as cli
    from cor_tpu_torch.config import load_train_config
    from cor_tpu_torch.models.core_model import init_core_model

    counts, results = {}, {}
    for mode, freeze in (("frozen", True), ("unfrozen", False)):
        d = root / mode
        d.mkdir(parents=True)
        cfg_path = m3_config(d, epoch=1, train_model_save_path=str(d / "ck"),
                             freeze_towers=freeze)
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
        fresh = init_core_model(cfg.core_config(), cfg.seed).state_dict()
        got = trainer.state.model.state_dict()
        same = {p: all(torch.equal(got[n].cpu(), fresh[n]) for n in fresh if n.startswith(p))
                for p in TOWERS}
        k6_want = (12 if freeze else 24) * steps + 12 * val_batches
        k6b_want = 0 if freeze else 12 * steps
        print(f"  train {mode}: unchanged since init {same}; K6 {c['vit_attention_relpos']} "
              f"(expected {k6_want}), K6b {c['vit_attention_relpos_bwd']} (expected {k6b_want})")
        if freeze and not all(same.values()):
            fail(f"train frozen: a frozen part moved: {same}")
        if not freeze and (same[TOWERS[0]] or same[TOWERS[1]] or not same[TOWERS[3]]):
            fail(f"train unfrozen: a tower did not move, or the PE matrix did: {same}")
        if c["vit_attention_relpos"] != k6_want or c["vit_attention_relpos_bwd"] != k6b_want or \
                min(v for k, v in c.items() if k != "vit_attention_relpos_bwd") == 0:
            fail(f"train {mode}: kernel launch counts {c}")
        counts[mode], results[mode] = c, {"seconds": dt, "losses": losses, "val": val[0]}
        del trainer, got, fresh
        torch.cuda.empty_cache()
    print("phase 15 training: ok", flush=True)
    return counts, results


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


def phase_train_numerics():
    import copy

    from cor_tpu_torch.config import TrainConfig
    from cor_tpu_torch.models.core_model import init_core_model
    from cor_tpu_torch.train.step import train_loss

    cfg = deterministic_config(TrainConfig().core_config())
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    model = init_core_model(cfg, SEED)
    model.image_encoder = filled_encoder(cfg)
    gpu = copy.deepcopy(model).cuda()  # remat on, as the trainer runs it
    # the CPU reference keeps every block's activations: no recompute
    model.image_encoder.cfg = dataclasses.replace(model.image_encoder.cfg, remat_blocks=False)
    b = synthetic_batch(1)
    batch = {k: torch.from_numpy(b[k]) for k in ("query_img", "query_mask", "support_img",
                                                   "support_mask", "text")}
    loss_g, _ = train_loss(cfg, gpu, {k: v.cuda() for k, v in batch.items()}, None)
    loss_g.backward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_c, _ = train_loss(cfg32, model, batch, None)
    loss_c.backward()
    dt = time.perf_counter() - t0
    names = ("image_encoder.blocks.0.attn.qkv.w", "image_encoder.blocks.2.attn.rel_pos_h",
             "image_encoder.patch_embed.w", "support_branch.siglip.visual.blocks.0.attn.qkv.w",
             "mask_decoder.transformer.layers.0.self_attn.q_proj.w")
    pg, pc = dict(gpu.named_parameters()), dict(model.named_parameters())
    cos = {n: torch.nn.functional.cosine_similarity(
        pg[n].grad.cpu().flatten()[None], pc[n].grad.flatten()[None]).item() for n in names}
    d = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    print(f"  unfrozen step, batch 1: loss GPU bf16 {loss_g.item():.6f}, CPU fp32 "
          f"{loss_c.item():.6f} (relative {d:.3e}); gradient cosines {json.dumps(cos)} "
          f"(CPU forward and backward {dt:.1f} s)")
    if not d <= 2e-2 or min(cos.values()) < COS_MIN:
        fail(f"GPU bf16 and CPU fp32 training steps disagree: loss {d}, cosines {cos}")
    dec_cos = decoder_bf16_cosines(gpu.mask_decoder, gpu.prompt_encoder, cfg.multimask_output)
    print(f"  the decoder alone on the card, bf16 vs fp32, seeds 0-2: q_proj gradient cosines "
          f"{json.dumps(dec_cos)}")
    del gpu, model
    torch.cuda.empty_cache()
    print("phase 16 training numerics: ok", flush=True)
    return d, cos


def phase_train_timings(smi: str):
    from cor_tpu_torch.config import TrainConfig
    from cor_tpu_torch.models.core_model import init_core_model
    from cor_tpu_torch.ops.common import gelu
    from cor_tpu_torch.train.optim import make_optimizer
    from cor_tpu_torch.train.step import BATCH_KEYS, TrainState, make_train_step

    b = synthetic_batch(TrainConfig().batch_size)
    batch = {k: torch.from_numpy(b[k]).cuda() for k in BATCH_KEYS}
    batch["valid"] = torch.ones(TrainConfig().batch_size, device="cuda")
    out = {}
    for mode, freeze in (("frozen", True), ("unfrozen", False)):
        cfg = dataclasses.replace(TrainConfig(), freeze_towers=freeze)
        model = init_core_model(cfg.core_config(), cfg.seed).cuda()
        opt, _ = make_optimizer(model, cfg.optimizer, cfg.lr, freeze_towers=freeze)
        state = TrainState(model, opt)
        step = make_train_step(cfg.core_config(), cfg.seed)
        step(state, batch, cfg.lr)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, batch, cfg.lr)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        med = statistics.median(times)
        out[mode] = {"s_per_step": med, "min_s": min(times), "max_s": max(times),
                     "samples_per_s": TrainConfig().batch_size / med,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if not freeze:
            out[mode]["profile"] = profile(lambda: step(state, batch, cfg.lr), 1)
        del state, model, opt
        torch.cuda.empty_cache()
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
    print("phase 17 training timings: ok", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this check runs on a GPU only",
              file=sys.stderr)
        sys.exit(2)
    # before any output: without the repository beside it, the script stops here
    from cor_tpu_torch.retrieval.index import save_gallery_index

    name, smi = phase_device()
    phase_build()
    kernel_results = phase_kernels(torch.device("cuda"))

    rng = np.random.default_rng(SEED)
    gallery = rng.standard_normal((GALLERY_ROWS, DIM), dtype=np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    pair_ids = np.arange(GALLERY_ROWS, dtype=np.int64)
    with tempfile.TemporaryDirectory() as d:
        save_gallery_index(d, gallery, pair_ids)
        servers, launches = phase_serve(d, pair_ids)
    phase_numerics(servers["fp32"])
    phase_timings(servers["fp32"], smi)
    del servers

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        t0 = time.perf_counter()
        store_ids = write_store_index(d / "index")
        print(f"  store index: {STORE_ROWS} x {GRID} x {GRID} x {SAM_C} fp16 written in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        dec_servers, dec_launches, _ = phase_decode_serve(d / "index", store_ids, d / "masks")
        phase_decode_numerics(dec_servers["host"], d / "index")
        phase_decode_timings(dec_servers, smi)
    del dec_servers

    enc_kernels, ln_sam = phase_encoder_kernels(torch.device("cuda"))
    kernel_results["vit_attention_relpos"] = enc_kernels
    kernel_results["layer_norm"]["sam_encoder_shapes"] = ln_sam
    with tempfile.TemporaryDirectory() as d:
        build_launches, _ = phase_build_index(Path(d) / "index")
    enc_gpu, _, _ = phase_encoder_numerics()
    phase_build_timings(enc_gpu, smi)
    del enc_gpu
    torch.cuda.empty_cache()

    kernel_results["vit_attention_relpos_bwd"] = phase_k6b(torch.device("cuda"))
    with tempfile.TemporaryDirectory() as d:
        train_launches, _ = phase_train(Path(d))
    phase_train_numerics()
    phase_train_timings(smi)

    sources = {
        "layer_norm": ("cor_tpu_torch/csrc/layernorm.cu", "cor_tpu/ops/pallas/layernorm.py:70",
                       launches),
        "attention_seq_qkv": ("cor_tpu_torch/csrc/seq_attention.cu",
                              "cor_tpu/ops/pallas/seq_attention.py:99", launches),
        "two_way_layer": ("cor_tpu_torch/csrc/two_way_layer.cu",
                          "cor_tpu/ops/pallas/two_way_layer.py:978", dec_launches),
        "t2i_flash_kv": ("cor_tpu_torch/csrc/t2i_flash.cu",
                         "cor_tpu/ops/pallas/t2i_flash.py:220", dec_launches),
        "decoder_tail": ("cor_tpu_torch/csrc/decoder_tail.cu",
                         "cor_tpu/ops/pallas/decoder_tail.py:150", dec_launches),
        "vit_attention_relpos": ("cor_tpu_torch/csrc/vit_attention.cu",
                                 "cor_tpu/ops/pallas/vit_attention.py:284", build_launches),
        "vit_attention_relpos_bwd": ("cor_tpu_torch/csrc/vit_attention_bwd.cu",
                                     "cor_tpu/ops/pallas/vit_attention.py:459",
                                     train_launches["unfrozen"]),
    }
    kernels = []
    for kname, res in kernel_results.items():
        src, replaces, counts = sources[kname]
        kernels.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                        "launches": counts[kname], **res})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
