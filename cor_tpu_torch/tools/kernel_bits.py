"""Check that the bf16 kernels give the same bits as those of another source
tree of ``csrc/`` (an earlier commit's), on the card, and time the ones
that were redesigned against it.

    python3 -m cor_tpu_torch.tools.kernel_bits OLD_CSRC_DIR
    python3 -m cor_tpu_torch.tools.kernel_bits OLD_CSRC_DIR --time

builds OLD_CSRC_DIR's ``*.cu`` into a library of its own (under
``cor_tpu_torch/_build/``), runs every bf16 kernel wrapper at the served,
built and trained shapes once through the current library and once through
the old one, on identical inputs, and exits non-zero unless every output is
equal bit for bit. The entries whose sums now run in another order (K4/K4′,
``cor_seq_attention``, and K6b, ``cor_vit_attention_relpos_bwd``, both
redesigned on wgmma) are not compared; ``--time`` times them instead,
through the old library and the current one in one process on the same
inputs (old, new, new, old: CUDA-event medians of CUDA-graph replays),
prints each shape's
milliseconds and the largest difference of the two outputs relative to the
old one's max, one JSON line per shape, and exits non-zero if a new kernel
is slower than the old one at any shape; then the query encode of the
SigLIP towers (K4's caller) at the serving buckets through each library.

An old entry point whose declaration in OLD_CSRC_DIR takes no ``f32`` flag
(the ABI before the kernel took fp32) is called with the flag dropped, and a
call with ``f32 = 1`` to it raises; one that takes no ``n_tok`` (the
decoder's ABI before its kernels took 5 to 32 tokens) is called with the
token count dropped, and a call with another than 6 raises. K6's ``lse``
and K6b's ``out`` and ``lse`` (the forward's statistics, before the
redesign) are dropped whatever they hold: the old K6 writes no ``lse`` and
the old K6b reads neither.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from cor_tpu_torch.ops.kernels import _build

# the entries compared bit for bit (the kernels the main paths ran before the
# decode schedules K1-dma, K1-stack and K1-grid came in: those have no older
# version, and their own checks against K1 and their plain versions)
_COMPARED = ("cor_layer_norm", "cor_vit_attention_relpos", "cor_vit_attention_relpos_windows",
             "cor_twl_tokens_in", "cor_t2i_image_pass", "cor_twl_tokens_mid",
             "cor_twl_image_i2t", "cor_t2i_combine", "cor_decoder_tail")
# the redesigned entries: timed (--time), not compared
_TIMED = ("cor_seq_attention", "cor_vit_attention_relpos_bwd")
_ENTRIES = _COMPARED + _TIMED
# the parameters an older ABI may lack, by entry: (name, position in the
# current signature, the only value the old entry computes, or None: dropped
# whatever it holds); f32 is every entry's second-to-last argument but
# cor_layer_norm's, n_tok follows n
_OPTIONAL = {name: [("f32", len(_build._SIGNATURES[name]) - 2, 0)] for name in _ENTRIES
             if name != "cor_layer_norm"}
for _name, _pos in (("cor_twl_tokens_in", 9), ("cor_t2i_image_pass", 6),
                    ("cor_twl_tokens_mid", 10), ("cor_twl_image_i2t", 6), ("cor_t2i_combine", 5)):
    _OPTIONAL[_name].append(("n_tok", _pos, 6))
_OPTIONAL["cor_vit_attention_relpos"].append(("lse", 4, None))
_OPTIONAL["cor_vit_attention_relpos_bwd"] += [("out", 4, None), ("lse", 5, None)]


def lacking(csrc: Path) -> dict:
    """{entry: [(parameter, position, value), ...]}: the optional parameters
    that the entry's ``extern "C"`` declaration in ``csrc`` lacks."""
    text = "".join(src.read_text() for src in sorted(csrc.glob("*.cu")))
    out = {}
    for name, params in _OPTIONAL.items():
        decl = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        if decl is None:
            raise ValueError(f"{csrc} declares no {name}")
        missing = [p for p in params if not re.search(rf"\b{p[0]}\b", decl.group(1))]
        if missing:
            out[name] = missing
    return out


_WRAPPER_MODULES = ("layernorm", "seq_attention", "vit_attention", "two_way_layer", "t2i_flash",
                    "i2t_attention", "decoder_tail")


def build_old(csrc: Path, missing: dict) -> ctypes.CDLL:
    """Compile ``csrc``'s sources into one library with the current flags;
    ``missing``: ``lacking(csrc)``."""
    h = hashlib.sha256()
    for src in sorted(csrc.glob("*.cu*")):
        h.update(src.read_bytes())
    out = _build.BUILD_DIR / f"libcor_kernels_old_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _build._nvcc()
        objs, procs = [], []
        for src in sorted(csrc.glob("*.cu")):
            obj = out.with_name(f"{out.stem}.{src.stem}.o")
            objs.append(obj)
            procs.append(subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-c", "-o", str(obj),
                                           str(src)], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        for p in procs:
            text = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"nvcc failed on the old sources:\n{text}")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
                        str(out), *map(str, objs)], check=True)
    lib = ctypes.CDLL(str(out))
    for name in _ENTRIES:
        sig = _build._SIGNATURES[name]
        fn = getattr(lib, name)
        drop = {pos for _, pos, _ in missing.get(name, ())}
        fn.argtypes = [a for i, a in enumerate(sig) if i not in drop]
        fn.restype = ctypes.c_int
    return lib


class _OldABI:
    """The old library behind the current calls: the parameters the old
    entry lacks dropped, after a check that they hold the one value it
    computes."""

    def __init__(self, lib, missing):
        self._lib, self._missing = lib, missing

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._missing:
            return fn

        def call(*args):
            drop = set()
            for param, pos, value in self._missing[name]:
                if value is not None and args[pos] != value:
                    raise TypeError(f"{name}: the old library takes only {param} = {value}")
                drop.add(pos)
            return fn(*(a for i, a in enumerate(args) if i not in drop))

        return call


def use_library(lib) -> None:
    """Point every kernel wrapper at ``lib`` (``None``: the current build)."""
    import importlib

    for mod in _WRAPPER_MODULES:
        m = importlib.import_module(f"cor_tpu_torch.ops.kernels.{mod}")
        m.library = _build.library if lib is None else (lambda lib=lib: lib)


@torch.no_grad()
def cases(device, token_counts: bool = True):
    """(label, thunk) of every bf16 kernel at the main paths' shapes; each
    thunk returns the kernel's outputs as a tuple of tensors. The decoder
    kernels run at 6 tokens, and with ``token_counts`` also at every count
    the main paths give them: K1 at 5 to 8, K2 at 5 to 32, K8a and K8b at 9
    to 32 (an older library without ``n_tok`` computes 6 only)."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.layernorm import layer_norm
    from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
    from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash, t2i_flash_kv
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_windows,
        vit_attention_relpos_with_lse,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    out = []
    x = (2 * rnd(9216, 768) + 0.5).to(bf)
    s, b = (1 + 0.1 * rnd(768)).to(bf), (0.1 * rnd(768)).to(bf)
    out.append(("K5 [9216, 768]", lambda: (layer_norm(x, s, b, 1e-6),)))
    for heads, D in ((12, 64), (16, 80)):
        for B, side in ((2, 64), (50, 14)):
            N = side * side
            qkv = rnd(B, N, 3 * heads * D).to(bf)
            rh, rw = (0.3 * rnd(B, heads, N, side)).to(bf), (0.3 * rnd(B, heads, N, side)).to(bf)
            a = (qkv, rh, rw, heads, (side, side))
            out.append((f"K6 d{D} [{B}, {N}]", lambda a=a: (vit_attention_relpos(*a),)))
            # the forward autograd records: out with the rows' lse written
            # (the old library writes none; out is compared)
            out.append((f"K6 d{D} [{B}, {N}] writing lse",
                        lambda a=a: vit_attention_relpos_with_lse(*a)[:1]))
        qkv = rnd(2, 70, 70, 3 * heads * D).to(bf)
        rh, rw = (0.3 * rnd(2, heads, 4900, 14)).to(bf), (0.3 * rnd(2, heads, 4900, 14)).to(bf)
        a = (qkv, rh, rw, heads, 14, (64, 64))
        out.append((f"K7 d{D} [2, 70, 70]", lambda a=a: (vit_attention_relpos_windows(*a),)))
    dec = init_mask_decoder(CoreConfig(), 1).to(device, bf).eval()
    n, N = 40, 4096
    kpe, qpe = (0.5 * rnd(N, 128)).to(bf), (0.5 * rnd(N, 128)).to(bf)
    store = torch.randint(-127, 128, (256, N, 256), generator=gen, device=device, dtype=torch.int8)
    scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(256, generator=gen, device=device))
    idx = torch.randperm(256, generator=gen, device=device)[:n].to(torch.int32)
    keys = (0.5 * rnd(n, N, 256)).to(bf)
    q_img = (0.5 * rnd(n, N, 128)).to(bf)
    lp0, lp1 = dec.transformer.layers
    fa = dec.transformer.final_attn_t2i
    t2i, i2t = lp1.cross_attn_t2i, lp1.cross_attn_i2t
    up = dec.output_upscaling
    hyper = rnd(n, 3, 32).to(bf)
    counts = (5, 6, 7, 8, 9, 16, 32) if token_counts else (6,)
    for T in counts:
        tokens, q_tok = rnd(n, T, 256).to(bf), rnd(n, T, 128).to(bf)
        kv = rnd(n, T, 128).to(bf), rnd(n, T, 128).to(bf)
        if T <= 8:
            out.append((f"K1 layer 0 int8 store, {T} tokens",
                        lambda tokens=tokens: two_way_layer(lp0, tokens, tokens, store, kpe, qpe,
                                                            True, idx=idx, scale=scales)))
            out.append((f"K1 layer 1 bf16, {T} tokens",
                        lambda tokens=tokens: two_way_layer(lp1, tokens, tokens, keys, kpe, qpe,
                                                            False)))
        out.append((f"K2, {T} tokens", lambda q_tok=q_tok: (t2i_flash_kv(
            keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe, q_tok, 8),)))
        if T == 6 or T > 8:
            # K8a and K8b run the image passes of K1 and K2: at 6 tokens an
            # older library computes them too
            out.append((f"K8a, {T} tokens", lambda q_tok=q_tok: proj_q_t2i_flash(
                keys, t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b, i2t.q_proj.w,
                i2t.q_proj.b, kpe, qpe, q_tok, 8)))
            out.append((f"K8b, {T} tokens", lambda kv=kv: (i2t_attention_fused(
                q_img, keys, *kv, i2t.out_proj.w, i2t.out_proj.b, lp1.norm4.scale,
                lp1.norm4.bias, 8),)))
    out.append(("K3", lambda: (decoder_tail(keys.reshape(n, 64, 64, 256), up.convt1.w,
                                            up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w,
                                            up.convt2.b, hyper),)))
    return out


@torch.no_grad()
def timed_cases(device):
    """(label, thunk, bound inputs) of the redesigned kernels at the main
    paths' shapes: K4 at ViT-B's [16, 576] and [16, 64] (12 heads of 64),
    K4′ at SO400M's [16, 729] and [16, 64] (16 heads of 72) through both
    entries, K6b at SAM-base's and sam_huge's global [2, 4096] and windowed
    [50, 196] shapes given the forward's out and lse."""
    from cor_tpu_torch.ops.kernels.seq_attention import attention_seq, attention_seq_qkv
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos_bwd,
        vit_attention_relpos_with_lse,
    )

    gen = torch.Generator(device=device).manual_seed(1)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    out = []
    for heads, D, n in ((12, 64, 576), (12, 64, 64), (16, 72, 729), (16, 72, 64)):
        C = heads * D
        qkv = rnd(16, n, 3 * C).to(bf)
        out.append((f"K4 d{D} [16, {n}, {3 * C}]",
                    lambda qkv=qkv, h=heads: (attention_seq_qkv(qkv, h),)))
        if D == 72:
            q, k, v = (qkv[..., i * C:(i + 1) * C].unflatten(-1, (heads, D)).transpose(1, 2)
                       .contiguous() for i in range(3))
            out.append((f"K4′ [B, H, N, D] d{D} [16, {heads}, {n}, {D}]",
                        lambda q=q, k=k, v=v, h=heads: (attention_seq(q, k, v, h),)))
    for heads, D in ((12, 64), (16, 80)):
        for B, side in ((2, 64), (50, 14)):
            N = side * side
            qkv = rnd(B, N, 3 * heads * D).to(bf)
            rh, rw = (0.3 * rnd(B, heads, N, side)).to(bf), (0.3 * rnd(B, heads, N, side)).to(bf)
            do = rnd(B, N, heads * D).to(bf)
            o, lse = vit_attention_relpos_with_lse(qkv, rh, rw, heads, (side, side))
            out.append((f"K6b d{D} [{B}, {N}, {3 * heads * D}]",
                        lambda a=(qkv, rh, rw, do, heads, (side, side)), o=o, lse=lse:
                        vit_attention_relpos_bwd(*a, out=o, lse=lse)))
    return out


def _ms(run, windows: int = 7, iters: int = 10) -> float:
    """The median device milliseconds per call over ``windows`` replays of a
    CUDA graph of ``iters`` calls (CUDA events), after a warm-up: the host's
    launch overhead, which sets a small kernel's eager time, stays out."""
    import statistics

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            run()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def _device_us(run) -> dict:
    """{kernel name: device microseconds} of one call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.device_time_total, 1) for e in prof.key_averages()
            if e.device_time_total > 0}


@torch.no_grad()
def tower_cases(device):
    """(label, thunk) of K4's end-to-end caller: the SigLIP towers' query
    encode (an image and its text, bf16, random weights from a seed) of
    ViT-B-16-SigLIP-384 (24 K4 launches) and ViT-SO400M-14-SigLIP-384 (54)
    at the serving buckets 1, 4 and 16."""
    from cor_tpu_torch.models.siglip import SIGLIP_MODELS, SigLIP

    gen = torch.Generator(device=device).manual_seed(2)
    out = []
    for name in ("ViT-B-16-SigLIP-384", "ViT-SO400M-14-SigLIP-384"):
        cfg = SIGLIP_MODELS[name]
        model = SigLIP(cfg).to(device)
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        model = model.to(torch.bfloat16).eval()
        for b in (1, 4, 16):
            images = torch.rand(b, 384, 384, 3, generator=gen, device=device).to(torch.bfloat16)
            tokens = torch.randint(0, cfg.text.vocab_size, (b, cfg.text.context_length),
                                   generator=gen, device=device)
            out.append((f"query encode {name} bucket {b}",
                        lambda m=model, i=images, t=tokens: m(i, t)))
    return out


def _eager_ms(run, windows: int = 7, iters: int = 3) -> float:
    """The median milliseconds per call of ``run`` launched from the host
    (CUDA events over ``iters`` calls, ``windows`` windows), as a server
    runs it: the host's launches included."""
    import statistics

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            run()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return statistics.median(per_call)


def time_towers(old, device, card: str) -> None:
    """The towers' query encode through ``old`` and the current library
    (old, new, new, old; host-launched, CUDA events, and as CUDA-graph
    replays: the device's time alone); one JSON line each."""
    import json

    for label, run in tower_cases(device):
        times = {"old": [], "new": [], "old_graph": [], "new_graph": []}
        for which in ("old", "new", "new", "old"):
            use_library(old if which == "old" else None)
            times[which].append(_eager_ms(run))
            times[f"{which}_graph"].append(_ms(run, iters=3))
        use_library(None)
        print(json.dumps({"e2e": label, "old_ms": times["old"], "new_ms": times["new"],
                          "old_graph_ms": times["old_graph"], "new_graph_ms": times["new_graph"],
                          "card": card}), flush=True)


def time_redesigned(old, device) -> int:
    """Time every case of ``timed_cases`` through ``old`` and the current
    library (old, new, new, old; CUDA graphs of 10 calls); one JSON line
    each, with each call's kernels' device time (torch.profiler).
    Returns 1 if a new kernel is slower than the old one anywhere."""
    import json
    import subprocess as sp

    smi = sp.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                 capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip() if smi else torch.cuda.get_device_name(0)
    slower = []
    for label, run in timed_cases(device):
        use_library(old)
        old_out = run()
        use_library(None)
        new_out = run()
        torch.cuda.synchronize()
        diff = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(new_out, old_out))
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            use_library(old if which == "old" else None)
            times[which].append(_ms(run))
        old_us = _device_us(run)
        use_library(None)
        t_old, t_new = min(times["old"]), min(times["new"])
        print(json.dumps({"kernel": label, "old_ms": times["old"], "new_ms": times["new"],
                          "speedup": t_old / t_new, "max_rel_diff": diff, "card": card,
                          "old_kernels_us": old_us, "new_kernels_us": _device_us(run)}),
              flush=True)
        if t_new > t_old:
            slower.append(label)
    print(f"redesigned kernels against the old library: "
          f"{'faster at every shape' if not slower else f'slower at {slower}'}")
    time_towers(old, device, card)
    return 1 if slower else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    timing = "--time" in argv
    argv = [a for a in argv if a != "--time"]
    if len(argv) != 1 or not Path(argv[0]).is_dir():
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    missing = lacking(Path(argv[0]))
    print(f"entries without f32, n_tok, out or lse in {argv[0]}: "
          f"{ {name: [p for p, _, _ in ps] for name, ps in missing.items()} }")
    old = _OldABI(build_old(Path(argv[0]), missing), missing)
    torch.set_grad_enabled(False)  # the decoder kernels take no autograd
    if timing:
        return time_redesigned(old, device)
    differ = []
    for label, run in cases(device, token_counts="cor_twl_tokens_in" not in missing):
        use_library(None)
        new_out = run()
        use_library(old)
        old_out = run()
        use_library(None)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(new_out, old_out))
        print(f"  {label}: {'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
        if not same:
            differ.append(label)
    print(f"bf16 kernels against {argv[0]}: "
          f"{'all equal bit for bit' if not differ else f'different: {differ}'}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
