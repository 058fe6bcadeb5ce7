#!/usr/bin/env python3
"""Drive cor_tpu_torch once on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases (any failure exits non-zero; no phase catches an exception):
 1. device: the card's name and power limit (nvidia-smi), TF32 switched off;
 2. build: both CUDA kernels from cor_tpu_torch/csrc;
 3. kernels: each kernel against its plain PyTorch version on identical bf16
    inputs at the serving path's shapes (batch 16, ViT-B-16-SigLIP-384),
    max |difference| <= 2e-2, and both timed with CUDA events;
 4. serve: a synthetic 127,166 x 256 gallery index (the COR127K triplet
    count), then ``cor_tpu_torch.cli.serve.main`` with --self-test 8 at full
    ViT-B-16-SigLIP-384 width (random weights from seed 0), fp32 and --int8
    scans; checks every response and the kernels' launch counts;
 5. numerics: GPU bf16 queries against the same weights' CPU fp32 queries,
    per-query cosine >= 0.99;
 6. timings: encode+scan latency per batch bucket (1, 4, 16) and responses/s
    of the self-test loop, with the card's name and power limit.
The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
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
import time

import numpy as np
import torch

SEED = 0
GALLERY_ROWS = 127_166  # COR127K triplets
DIM = 256
BATCH = 16  # the kernels are checked and timed at the largest serving bucket
KERNEL_TOL = 2e-2  # ~1 bf16 ulp at |y| <= 4; statistics and softmax are fp32 in both
COS_MIN = 0.99


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
    # ptxas -v: per kernel, its registers (and shared memory) and spill bytes
    kernel = None
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = "attention" if "seq_attention" in line else "layer_norm"
        elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            print(f"  ptxas {kernel} spills: {line.strip()}")
        elif "Used" in line and "registers" in line and kernel == "attention":
            print(f"  ptxas attention: {line.split(':', 1)[1].strip()}")
    return dt


def phase_kernels(device):
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
                       cuda_ms(lambda: layer_norm_plain(x, scale, bias, 1e-6)))
        print(f"  K5 layer_norm [{n}, 768] bf16: max|d|={err:.3e} kernel "
              f"{ln_t[tower][0][0]:.4f} ms, plain {ln_t[tower][1][0]:.4f} ms")
    # fp32 input and ragged row count: the same kernel, other template cases
    x = torch.randn(1001, 768, generator=gen, device=device)
    err32 = (layer_norm(x, scale, bias) - layer_norm_plain(x, scale, bias)).abs().max().item()
    torch.cuda.synchronize()
    print(f"  K5 layer_norm [1001, 768] fp32: max|d|={err32:.3e}")
    if ln_err > KERNEL_TOL or err32 > 1e-4:
        fail(f"layer_norm kernel disagrees with its plain version: {ln_err} (bf16), {err32} (fp32)")
    results["layer_norm"] = (ln_err, ln_t["vision"])

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
            at_t[tower] = (cuda_ms(lambda: attention_seq_qkv(qkv, 12)),
                           cuda_ms(lambda: attention_seq_qkv_plain(qkv, 12)))
            print(f"  K4 attention_seq_qkv [{BATCH}, {n}, 2304] bf16: max|d|={err:.3e} kernel "
                  f"{at_t[tower][0][0]:.4f} ms, plain {at_t[tower][1][0]:.4f} ms")
        else:
            print(f"  K4 attention_seq_qkv [{BATCH}, {n}, 2304] bf16: max|d|={err:.3e}")
    if at_err > KERNEL_TOL:
        fail(f"attention_seq_qkv kernel disagrees with its plain version: {at_err}")
    results["attention_seq_qkv"] = (at_err, at_t["vision"])
    print("phase 3 kernels: ok", flush=True)
    return results


def reset_counts():
    from cor_tpu_torch.ops.kernels.layernorm import layer_norm
    from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv

    layer_norm.launches = 0
    attention_seq_qkv.launches = 0


def read_counts():
    from cor_tpu_torch.ops.kernels.layernorm import layer_norm
    from cor_tpu_torch.ops.kernels.seq_attention import attention_seq_qkv

    return {"layer_norm": layer_norm.launches, "attention_seq_qkv": attention_seq_qkv.launches}


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
        want = {"layer_norm": 50 * n, "attention_seq_qkv": 24 * n}
        print(f"  serve {mode}: {len(resps)} responses, {n} encoded batches (warmup included), "
              f"launches {c} (expected {want}), main() took {dt:.1f} s")
        if c != want or min(c.values()) == 0:
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

    sources = {
        "layer_norm": ("cor_tpu_torch/csrc/layernorm.cu", "cor_tpu/ops/pallas/layernorm.py:70"),
        "attention_seq_qkv": ("cor_tpu_torch/csrc/seq_attention.cu",
                              "cor_tpu/ops/pallas/seq_attention.py:99"),
    }
    kernels = []
    for kname, (err, (kern_t, plain_t)) in kernel_results.items():
        src, replaces = sources[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": err,
            "ms": kern_t[0], "plain_ms": plain_t[0],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
