"""Check that the bf16 kernels give the same bits as those of another source
tree of ``csrc/`` (an earlier commit's), on the card, and time the ones
that were redesigned against it.

    python3 -m cor_tpu_torch.tools.kernel_bits OLD_CSRC_DIR
    python3 -m cor_tpu_torch.tools.kernel_bits OLD_CSRC_DIR --time [--only K6,K7] [--draws 4]

builds OLD_CSRC_DIR's ``*.cu`` into a library of its own (under
``cor_tpu_torch/_build/``), runs every bf16 kernel wrapper at the served,
built and trained shapes once through the current library and once through
the old one, on identical inputs, and exits non-zero unless every output is
equal bit for bit. The entries whose sums now run in another order (K4/K4′,
``cor_seq_attention``, and K6b, ``cor_vit_attention_relpos_bwd``, both
redesigned on wgmma; K5 and K5′, ``cor_layer_norm`` and
``cor_add_layer_norm``, whose lanes own contiguous chunks of a row since
their redesign) are not compared. ``--time`` times the redesigned kernels
(K4/K4′ in bf16 and fp32, K6/K7 on wgmma in bf16 and fp32, K6b in bf16 and
fp32, K5/K5′ in bf16 and fp32) through the old library and the current one
in one process
on the same inputs (old, new, new, old: CUDA-event medians of CUDA-graph
replays), prints each shape's milliseconds and the largest difference of
the two outputs relative to the old one's max (and for K6b in fp32 each
library's largest error against float64), one JSON line per shape, and
exits non-zero if a new kernel is slower than the old one at any shape; then
the end-to-end callers through each library: the query encode of the SigLIP
towers (K4's and K5's) in bf16 and fp32 at the serving buckets and the SAM
image encode (K6's and K5's) in bf16 and fp32 at SAM-base batch 1 and 8 and
sam_huge batch 1.
K1, whose image passes were redesigned for Hopper (``cor_twl_t2i``,
``cor_twl_i2t``) with the bits kept, is both compared and timed: in bf16
and fp32, layer 0 out of an int8 store and layer 1 on rows, at 5, 6 and 8
tokens and 40 and 128 candidates, each line with both libraries' device
time by launch (``k1_split``), then the fused mask decode end to end. So
are K2 (``cor_t2i_final``, one launch on K1's t2i pass; an older library
runs it through ``cor_t2i_image_pass`` and ``cor_t2i_combine``) and K3
(``cor_decoder_tail``, persistent on wgmma, every map from one pass; its
``w_blocks`` dropped for an older library), redesigned for Hopper with the
bits kept: K2 at 5, 6, 8, 16 and 32 tokens, K3 with 1 and 3 maps, both at
40 and 128 candidates in bf16 and fp32 (``k2k3_cases``). So are K8a
(``cor_t2i_proj_q``, one launch on K1's t2i pass with K2's folded combine;
an older library runs it through ``cor_t2i_image_pass`` and
``cor_t2i_combine``) and K8b (``cor_twl_i2t`` at 9 to 32 tokens; an older
``cor_twl_i2t``, which takes at most 8, is served by ``cor_twl_image_i2t``),
redesigned for Hopper with the bits kept: at 9, 11, 16 and 32 tokens, 40
and 128 candidates, bf16 and fp32 (``k8_cases``), then the K8 route's fused
decode at 16 tokens (``k8_decode_cases``), whose graph replays count among
the cases that must be faster. So are K1-stack and K1-grid
(``cor_two_way_fused``, rebuilt on K1's and K2's Hopper passes with the bits
kept; an older library's entry takes the same arguments and reads the first
50 of the pointers): at 5, 6 and 8 tokens, 40 and 128 candidates, on rows and
on a store through idx, bf16 and fp32 (``stack_cases``; compared in bf16 at
40 candidates too). In ``--time`` every decoder case (K1, K2, K3, K8a, K8b,
K1-stack, K1-grid) must also equal the old library's outputs bit for bit,
and the exit code says so.
So is K1-dma (``cor_twl_dma_image_t2i`` and ``cor_twl_dma_image_i2t``,
rebuilt on K1's Hopper passes with the rows moved by bulk copies and stores;
an older library's entries take no ring blocks, ``w_blocks`` and
``wo_blocks`` dropped): layer 0 from an int8 store, layer 1 on rows and on a
store through idx, at 5, 6 and 8 tokens, 40 and 128 candidates, bf16 and
fp32 (``dma_cases``), each line with both libraries' device time by launch,
K1's time in the same call and whether K1-dma's outputs equal K1's bit for
bit. K9 (``cor_fused_upscale2_hyper``, redesigned as a persistent kernel on
wgmma, its sums in another order) is timed at ``K9_SHAPES`` in bf16 and
fp32 (``k9_cases``) and held to its plain version within ``K9_TOL``.
``--only`` keeps the cases whose label holds one of the comma-separated
parts (``K1``, ``K2`` and ``K3`` also the decode at 6 tokens, ``K8a`` and
``K8b`` the K8 route's); ``--draws N`` reads K6b in fp32's errors against
float64 on N draws of its inputs.

An old entry point whose declaration in OLD_CSRC_DIR takes no ``f32`` flag
(the ABI before the kernel took fp32) is called with the flag dropped, and a
call with ``f32 = 1`` to it raises; one that takes no ``n_tok`` (the
decoder's ABI before its kernels took 5 to 32 tokens) is called with the
token count dropped, and a call with another than 6 raises. K6's ``lse``
and K6b's ``out`` and ``lse`` (the forward's statistics, before the bf16
redesign) are dropped whatever they hold where the old entry lacks them: the
old K6 writes no ``lse`` and the old K6b reads neither. A K6b in fp32 of
the first design takes them and reads neither (it recomputes its own
statistics into twice the scratch the current one needs, which the wrapper
allocates).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import re
import subprocess
import sys
from pathlib import Path

import torch

from cor_tpu_torch.ops.kernels import _build

# the entries compared bit for bit: the kernels of the main paths and K1-stack
# and K1-grid (cor_two_way_fused, since their redesign on K1's and K2's
# passes; K1-dma is held to K1's bits by its own checks)
_COMPARED = ("cor_vit_attention_relpos", "cor_vit_attention_relpos_windows",
             "cor_twl_tokens_in", "cor_t2i_image_pass", "cor_twl_tokens_mid",
             "cor_twl_image_i2t", "cor_t2i_combine", "cor_decoder_tail", "cor_two_way_fused")
# the redesigned entries: timed (--time), not compared
_TIMED = ("cor_seq_attention", "cor_vit_attention_relpos_bwd", "cor_layer_norm",
          "cor_add_layer_norm")
_ENTRIES = _COMPARED + _TIMED
# K1's own entries since its redesign for Hopper, and the shared entries an
# older csrc/ without them ran K1 through: the old library serves a call to
# the first by the second, without the argument at the position given (the
# weight laid out as the new ring's blocks), or with all of them (None)
_K1_ENTRIES = {"cor_twl_t2i": ("cor_t2i_image_pass", 9),
               "cor_twl_i2t": ("cor_twl_image_i2t", 12),
               "cor_twl_tokens_in_cluster": ("cor_twl_tokens_in", None),
               "cor_twl_tokens_mid_cluster": ("cor_twl_tokens_mid", None)}
# the parameters an older ABI may lack, by entry: (name, position in the
# current signature, the only value the old entry computes, or None: dropped
# whatever it holds); f32 is every entry's second-to-last argument but the
# LayerNorms' (their dtype flags are always there), n_tok follows n
_OPTIONAL = {name: [("f32", len(_build._SIGNATURES[name]) - 2, 0)] for name in _ENTRIES
             if name not in ("cor_layer_norm", "cor_add_layer_norm")}
for _name, _pos in (("cor_twl_tokens_in", 9), ("cor_t2i_image_pass", 6),
                    ("cor_twl_tokens_mid", 10), ("cor_twl_image_i2t", 6), ("cor_t2i_combine", 5)):
    _OPTIONAL[_name].append(("n_tok", _pos, 6))
_OPTIONAL["cor_vit_attention_relpos"].append(("lse", 4, None))
# K3's bf16 weights laid out as its shared memory holds them, since its redesign
_OPTIONAL["cor_decoder_tail"].append(("w_blocks", 3, None))
# K1-dma's image passes take K1's ring blocks since their redesign on K1's
# passes; an older csrc/ (before K1-dma) lacks the entries
_DMA_ENTRIES = ("cor_twl_dma_image_t2i", "cor_twl_dma_image_i2t")
_K9_ENTRY = "cor_fused_upscale2_hyper"  # the same arguments since K9's port
_OPTIONAL["cor_twl_dma_image_t2i"] = [("w_blocks", 9, None)]
_OPTIONAL["cor_twl_dma_image_i2t"] = [("wo_blocks", 12, None)]
# K2's own entry since its redesign for Hopper; an older csrc/ without it runs
# K2 through the shared image pass and the combine (_OldABI.cor_t2i_final)
_K2_ENTRY = "cor_t2i_final"
# K8a's own entry since its redesign for Hopper; an older csrc/ without it runs
# K8a through the shared image pass and the combine (_OldABI.cor_t2i_proj_q)
_K8A_ENTRY = "cor_t2i_proj_q"
# K1-stack's and K1-grid's entry: 96bd5c1's takes the same arguments; its
# pointer array is the first 50 of the current one (_OldABI.cor_two_way_fused)
_FUSED_ENTRY = "cor_two_way_fused"
_OPTIONAL["cor_vit_attention_relpos_bwd"] += [("out", 4, None), ("lse", 5, None)]


def lacking(csrc: Path) -> dict:
    """{entry: [(parameter, position, value), ...]}: the optional parameters
    that the entry's ``extern "C"`` declaration in ``csrc`` lacks."""
    text = "".join(src.read_text() for src in sorted(csrc.glob("*.cu")))
    out = {}
    for name, params in _OPTIONAL.items():
        decl = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
        if decl is None and name in _DMA_ENTRIES:
            continue
        if decl is None:
            raise ValueError(f"{csrc} declares no {name}")
        missing = [p for p in params if not re.search(rf"\b{p[0]}\b", decl.group(1))]
        if missing:
            out[name] = missing
    return out


def narrow_i2t(csrc: Path) -> bool:
    """Whether ``csrc``'s ``cor_twl_i2t`` takes at most 8 tokens (K1's alone,
    before K8b ran on it)."""
    src = csrc / "twl_i2t.cu"
    return src.exists() and "n_tok > kMaxT ||" in src.read_text()


_WRAPPER_MODULES = ("layernorm", "seq_attention", "vit_attention", "two_way_layer", "t2i_flash",
                    "i2t_attention", "decoder_tail", "two_way_stack", "upscale")


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
    for name in _ENTRIES + tuple(n for n in (*_K1_ENTRIES, _K2_ENTRY, _K8A_ENTRY, *_DMA_ENTRIES,
                                             _K9_ENTRY) if hasattr(lib, n)):
        sig = _build._SIGNATURES[name]
        fn = getattr(lib, name)
        drop = {pos for _, pos, _ in missing.get(name, ())}
        fn.argtypes = [a for i, a in enumerate(sig) if i not in drop]
        fn.restype = ctypes.c_int
    return lib


class _OldABI:
    """The old library behind the current calls: the parameters the old
    entry lacks dropped, after a check that they hold the one value it
    computes; ``narrow_i2t``: its ``cor_twl_i2t`` takes at most 8 tokens, and
    a call with more goes to ``cor_twl_image_i2t``."""

    def __init__(self, lib, missing, narrow_i2t: bool = False):
        self._lib, self._missing, self._narrow_i2t = lib, missing, narrow_i2t

    def __getattr__(self, name):
        if name == _FUSED_ENTRY:
            return self._fused
        if name == _K2_ENTRY and not hasattr(self._lib, name):
            return self._final
        if name == _K8A_ENTRY and not hasattr(self._lib, name):
            return self._proj_q
        if name == "cor_twl_i2t" and self._narrow_i2t:
            return self._i2t
        if name in _K1_ENTRIES and not hasattr(self._lib, name):
            shared, pos = _K1_ENTRIES[name]
            fn = getattr(self, shared)
            return fn if pos is None else lambda *args: fn(*args[:pos], *args[pos + 1:])
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

    def _final(self, keys, n, n_tok, N, w, w_blocks, b, kpe, qt, pm, pl, pa, tickets, out, f32,
               stream):
        """K2 on a library without cor_t2i_final: the shared image pass, then
        cor_t2i_combine (the tickets unused)."""
        err = self.cor_t2i_image_pass(keys, 0, 0, 0, n, n, n_tok, N, w, b, kpe, 0, qt, 0, pm, pl,
                                      pa, f32, stream)
        return err or self.cor_t2i_combine(pm, pl, pa, N // 64, n, n_tok, out, f32, stream)

    def _proj_q(self, keys, n, n_tok, N, w, w_blocks, b, kpe, qpe, qt, q_img, pm, pl, pa,
                tickets, out, f32, stream):
        """K8a on a library without cor_t2i_proj_q: the shared image pass
        (q_img written), then cor_t2i_combine (the tickets unused)."""
        err = self.cor_t2i_image_pass(keys, 0, 0, 0, n, n, n_tok, N, w, b, kpe, qpe, qt, q_img,
                                      pm, pl, pa, f32, stream)
        return err or self.cor_t2i_combine(pm, pl, pa, N // 64, n, n_tok, out, f32, stream)

    def _fused(self, cluster, *args):
        """K1-stack and K1-grid on an older library: its entry takes the same
        arguments and reads the first 50 of the pointers the current wrappers
        hand it (the ring blocks follow them); the schedule alone in
        ``cluster`` (0 or 1: no team size, which it has no notion of)."""
        if cluster not in (0, 1):
            raise TypeError(f"{_FUSED_ENTRY}: the old library takes cluster 0 or 1, got "
                            f"{cluster:#x}")
        return self._lib.cor_two_way_fused(cluster, *args)

    def _i2t(self, *args):
        """cor_twl_i2t on a library whose entry takes at most 8 tokens: above,
        K8b's shared body (cor_twl_image_i2t, without wo_blocks)."""
        if args[6] <= 8:
            return self._lib.cor_twl_i2t(*args)
        return self.cor_twl_image_i2t(*args[:12], *args[13:])


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
    from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
    from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash, t2i_flash_kv
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer
    from cor_tpu_torch.ops.kernels.two_way_stack import two_way_grid_fused, two_way_stack_fused
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_windows,
        vit_attention_relpos_with_lse,
    )

    gen = torch.Generator(device=device).manual_seed(0)
    bf = torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    out = []
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
    # K1-stack and K1-grid on the rows and on a bf16 store through idx
    p = dec.transformer
    kpe_f, qpe1, kpe1 = ((0.5 * rnd(N, 128)).to(bf) for _ in range(3))
    store16 = (0.5 * rnd(256, N, 256)).to(bf)
    for T in [t for t in counts if t <= 8]:
        tokens = rnd(n, T, 256).to(bf)
        for name, fn in (("K1-stack", two_way_stack_fused), ("K1-grid", two_way_grid_fused)):
            for rows, kw, what in ((keys, {}, "rows"), (store16, dict(idx=idx), "store-indexed")):
                out.append((f"{name} {what}, {T} tokens", lambda fn=fn, tokens=tokens, rows=rows,
                            kw=kw: fn(p, tokens, tokens, rows, (kpe, kpe1), (qpe, qpe1), kpe_f,
                                      **kw)))
    return out


@torch.no_grad()
def timed_cases(device, draw: int = 0):
    """(label, make) of the redesigned kernels at the main paths' shapes;
    ``make()`` builds the case's inputs (random, from seeds that ``draw``
    offsets) and returns its thunk. K4 at ViT-B's [16, 576] and [16, 64]
    (12 heads of 64), K4′ at SO400M's [16, 729] and [16, 64] (16 heads of
    72) through both entries, in bf16 and fp32 (K4@fp32 through both entries
    too); K5 and K5′ at the towers' [9216, 768], the SAM encoder's [32768,
    768], its neck's [32768, 256], SO400M's [11664, 1152] and sam_huge's
    [32768, 1280], in bf16 (bf16 weights) and fp32; K6 at SAM-base's (12
    heads of 64) and sam_huge's (16 of 80) global [2, 4096] and windowed
    [50, 196] shapes, with and without the rows' lse written, in bf16 and
    fp32; K7 at both encoders' padded grid [2, 70, 70] in bf16 and fp32; K6b
    in bf16 and in fp32 at K6's four shapes, given the forward's out and
    lse."""
    from cor_tpu_torch.ops.kernels.layernorm import add_layer_norm, layer_norm
    from cor_tpu_torch.ops.kernels.seq_attention import attention_seq, attention_seq_qkv
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos,
        vit_attention_relpos_bwd,
        vit_attention_relpos_windows,
        vit_attention_relpos_with_lse,
    )

    bf = torch.bfloat16

    def rnd(seed, *shape, dtype=bf, mul=1.0):
        gen = torch.Generator(device=device).manual_seed(seed + 100 * draw)
        return (mul * torch.randn(*shape, generator=gen, device=device)).to(dtype)

    out = []
    for dt, sfx in ((bf, ""), (torch.float32, "@fp32")):
        for heads, D, n in ((12, 64, 576), (12, 64, 64), (16, 72, 729), (16, 72, 64)):
            C = heads * D

            def k4(heads=heads, n=n, C=C, dt=dt):
                qkv = rnd(1, 16, n, 3 * C, dtype=dt)
                return lambda: (attention_seq_qkv(qkv, heads),)

            out.append((f"K4{sfx} d{D} [16, {n}, {3 * C}]", k4))
            if D == 72 or sfx:
                def k4b(heads=heads, n=n, C=C, D=D, dt=dt):
                    q, k, v = (rnd(1, 16, n, 3 * C, dtype=dt)[..., i * C:(i + 1) * C]
                               .unflatten(-1, (heads, D)).transpose(1, 2).contiguous()
                               for i in range(3))
                    return lambda: (attention_seq(q, k, v, heads),)

                out.append((f"K4′{sfx} [B, H, N, D] d{D} [16, {heads}, {n}, {D}]", k4b))
    for dt, sfx in ((bf, ""), (torch.float32, "@fp32")):
        for rows, C in ((9216, 768), (32768, 768), (32768, 256), (11664, 1152), (32768, 1280)):
            def k5(rows=rows, C=C, dt=dt, add=False):
                x = rnd(9, rows, C, dtype=dt, mul=2.0)
                s, b = 1 + rnd(10, C, dtype=dt, mul=0.1), rnd(11, C, dtype=dt, mul=0.1)
                if add:
                    y = rnd(12, rows, C, dtype=dt)
                    return lambda: (add_layer_norm(x, y, s, b, 1e-6),)
                return lambda: (layer_norm(x, s, b, 1e-6),)

            out.append((f"K5{sfx} [{rows}, {C}]", k5))
            out.append((f"K5′{sfx} [{rows}, {C}]", functools.partial(k5, add=True)))
    for heads, D in ((12, 64), (16, 80)):
        C = heads * D
        for B, side in ((2, 64), (50, 14)):
            N = side * side

            def k6_args(B=B, N=N, C=C, side=side, heads=heads, dtype=bf):
                return (rnd(2, B, N, 3 * C, dtype=dtype),
                        rnd(3, B, heads, N, side, dtype=dtype, mul=0.3),
                        rnd(4, B, heads, N, side, dtype=dtype, mul=0.3), heads, (side, side))

            def k6(k6_args=k6_args, with_lse=False, dtype=bf):
                a = k6_args(dtype=dtype)
                if with_lse:  # the forward autograd records: out with the rows' lse
                    return lambda: (vit_attention_relpos_with_lse(*a)[0],)
                return lambda: (vit_attention_relpos(*a),)

            def k6b(k6_args=k6_args, dtype=bf, B=B, N=N, C=C):
                a = k6_args(dtype=dtype)
                do = rnd(5, B, N, C, dtype=dtype)
                o, lse = vit_attention_relpos_with_lse(*a)
                run = lambda: vit_attention_relpos_bwd(*a[:3], do, *a[3:], out=o, lse=lse)  # noqa: E731
                if dtype == torch.float32:
                    from cor_tpu_torch.tools.k6b_accuracy import k6b_float64

                    run.exact = lambda: k6b_float64(*a[:3], do, *a[3:])
                return run

            label = f"[{B}, {N}, {3 * C}]"
            out.append((f"K6 d{D} {label}", k6))
            out.append((f"K6 d{D} {label} writing lse", functools.partial(k6, with_lse=True)))
            out.append((f"K6b d{D} {label}", k6b))
            f32 = torch.float32
            out.append((f"K6@fp32 d{D} {label}", functools.partial(k6, dtype=f32)))
            out.append((f"K6@fp32 d{D} {label} writing lse",
                        functools.partial(k6, with_lse=True, dtype=f32)))
            out.append((f"K6b@fp32 d{D} {label}", functools.partial(k6b, dtype=f32)))

        def k7(heads=heads, C=C, dtype=bf):
            a = (rnd(6, 2, 70, 70, 3 * C, dtype=dtype), rnd(7, 2, heads, 4900, 14, dtype=dtype,
                                                            mul=0.3),
                 rnd(8, 2, heads, 4900, 14, dtype=dtype, mul=0.3), heads, 14, (64, 64))
            return lambda: (vit_attention_relpos_windows(*a),)

        out.append((f"K7 d{D} [2, 70, 70, {3 * C}]", k7))
        out.append((f"K7@fp32 d{D} [2, 70, 70, {3 * C}]",
                    functools.partial(k7, dtype=torch.float32)))
    return out


K1_TOKENS = (5, 6, 8)  # a mask or no prompt, one point (the served decode), a box
K1_CANDIDATES = (40, 128)  # the served decode's candidates, decode_bench's chunk


@torch.no_grad()
def k1_cases(device, draw: int = 0):
    """(label, make) of K1, redesigned for Hopper, at the fused decode's
    shapes: layer 0 out of an int8 store of 256 rows [4096, 256] through idx
    and layer 1 on rows [n, 4096, 256], at ``K1_TOKENS`` tokens and
    ``K1_CANDIDATES`` candidates, in bf16 and fp32 (the SAM-base decoder's
    layers, random weights from a seed). Each thunk carries ``split()``, its
    device time by launch (``k1_split``)."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer

    N, S = 4096, 256

    @functools.lru_cache(maxsize=1)
    def shared(dt):
        gen = torch.Generator(device=device).manual_seed(20 + 100 * draw)
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
        kpe, qpe = (0.5 * rnd(N, 128)).to(dt), (0.5 * rnd(N, 128)).to(dt)
        store = torch.randint(-127, 128, (S, N, 256), generator=gen, device=device,
                              dtype=torch.int8)
        scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(S, generator=gen, device=device))
        return dec, kpe, qpe, store, scales

    def make(dt, layer, T, n):
        dec, kpe, qpe, store, scales = shared(dt)
        gen = torch.Generator(device=device).manual_seed(21 + 100 * draw + T + n)
        tokens = torch.randn(n, T, 256, generator=gen, device=device).to(dt)
        if layer == 0:
            idx = torch.randint(0, S, (n,), generator=gen, device=device, dtype=torch.int32)
            args = (dec.transformer.layers[0], tokens, tokens, store, kpe, qpe, True)
            kw = dict(idx=idx, scale=scales)
        else:
            keys = (0.5 * torch.randn(n, N, 256, generator=gen, device=device)).to(dt)
            args = (dec.transformer.layers[1], tokens, tokens, keys, kpe, qpe, False)
            kw = {}
        run = lambda: two_way_layer(*args, **kw)  # noqa: E731
        run.split = lambda: k1_split(*args, **kw)
        return run

    return [(f"K1{sfx} layer {layer} {'int8 store' if layer == 0 else 'rows'} [{n}, {N}], "
             f"{T} tokens", functools.partial(make, dt, layer, T, n))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32"))
            for layer in (0, 1) for T in K1_TOKENS for n in K1_CANDIDATES]


@torch.no_grad()
def dma_cases(device, draw: int = 0):
    """(label, make) of K1-dma, rebuilt on K1's Hopper passes, at the fused
    decode's shapes: layer 0 out of an int8 store of 256 rows [4096, 256]
    through idx, layer 1 on rows [n, 4096, 256] and on a store of the
    compute dtype through idx, at ``K1_TOKENS`` tokens and ``K1_CANDIDATES``
    candidates, in bf16 and fp32 (the SAM-base decoder's layers, random
    weights from a seed). Each thunk carries ``split()``, its device time by
    launch, and ``k1``, K1 on the same inputs, whose bits it keeps."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.two_way_layer import two_way_layer, two_way_layer_dma

    N, S = 4096, 256

    @functools.lru_cache(maxsize=1)
    def shared(dt):
        gen = torch.Generator(device=device).manual_seed(70 + 100 * draw)
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
        kpe, qpe = (0.5 * rnd(N, 128)).to(dt), (0.5 * rnd(N, 128)).to(dt)
        store8 = torch.randint(-127, 128, (S, N, 256), generator=gen, device=device,
                               dtype=torch.int8)
        scales = (0.5 * 4 / 127) * (1 + 0.1 * torch.rand(S, generator=gen, device=device))
        return dec, kpe, qpe, store8, scales, (0.5 * rnd(S, N, 256)).to(dt)

    def make(dt, what, T, n):
        dec, kpe, qpe, store8, scales, store = shared(dt)
        gen = torch.Generator(device=device).manual_seed(71 + 100 * draw + T + n)
        tokens = torch.randn(n, T, 256, generator=gen, device=device).to(dt)
        idx = torch.randint(0, S, (n,), generator=gen, device=device, dtype=torch.int32)
        if what == "int8 store":
            args = (dec.transformer.layers[0], tokens, tokens, store8, kpe, qpe, True)
            kw = dict(idx=idx, scale=scales)
        else:
            rows = store if what == "store-indexed" else (0.5 * torch.randn(
                n, N, 256, generator=gen, device=device)).to(dt)
            args = (dec.transformer.layers[1], tokens, tokens, rows, kpe, qpe, False)
            kw = dict(idx=idx) if what == "store-indexed" else {}
        run = lambda: two_way_layer_dma(*args, **kw)  # noqa: E731
        run.split = lambda: k1_split(*args, **kw, fn=two_way_layer_dma)
        run.k1 = lambda: two_way_layer(*args, **kw)
        return run

    return [(f"K1-dma{sfx} layer {0 if what == 'int8 store' else 1} {what} [{n}, {N}], "
             f"{T} tokens", functools.partial(make, dt, what, T, n))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32"))
            for what in ("int8 store", "rows", "store-indexed")
            for T in K1_TOKENS for n in K1_CANDIDATES]


# K9: cor_tpu's own test's shape and the SAM decoder's last upscale at 40
# candidates with 1 and 4 maps (chip_smoke.py's K9_SHAPES): (B, H, W, C, O, N)
K9_SHAPES = ((2, 8, 8, 64, 32, 3), (40, 128, 128, 64, 32, 1), (40, 128, 128, 64, 32, 4))
K9_TOL = 1e-4  # cor_tpu's fp32 tolerance (tests/test_pallas_kernels.py:58), bf16 too


@torch.no_grad()
def k9_cases(device, draw: int = 0):
    """(label, make) of K9 (fused_upscale2_hyper), redesigned for Hopper, at
    ``K9_SHAPES`` in bf16 and fp32 (random inputs from a seed). Each thunk
    carries ``plain``, its plain version, which it must match within
    ``K9_TOL``."""
    from cor_tpu_torch.ops.kernels.upscale import (
        fused_upscale2_hyper,
        fused_upscale2_hyper_plain,
    )

    def make(dt, shape):
        B, H, W, C, O, N = shape
        gen = torch.Generator(device=device).manual_seed(80 + 100 * draw + B + W)
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
        x, h = rnd(B, H, W, C).to(dt), rnd(B, N, O).to(dt)
        w, b = (rnd(C, 2, 2, O) / C ** 0.5).to(dt), 0.1 * rnd(O)
        run = lambda: (fused_upscale2_hyper(x, w, b, h),)  # noqa: E731
        run.plain = lambda: (fused_upscale2_hyper_plain(x, w, b, h),)
        return run

    return [(f"K9{sfx} x [{B}, {H}, {W}, {C}], O {O}, N {N}", functools.partial(make, dt, shape))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32"))
            for shape in K9_SHAPES for B, H, W, C, O, N in (shape,)]


K2_TOKENS = (5, 6, 8, 16, 32)  # K1's counts, and the K8 route's above 8 (phase 34)
K3_MAPS = (1, 3)  # the served decode's one map, SAM's multimask three


@torch.no_grad()
def k2k3_cases(device, draw: int = 0):
    """(label, make) of K2 and K3, redesigned for Hopper, at the fused
    decode's shapes: K2 (the final attention) on rows [n, 4096, 256] at
    ``K2_TOKENS`` tokens, K3 (the upscale tail) on [n, 64, 64, 256] with
    ``K3_MAPS`` maps, both at ``K1_CANDIDATES`` candidates, in bf16 and fp32
    (the SAM-base decoder's weights, random from a seed)."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.decoder_tail import decoder_tail
    from cor_tpu_torch.ops.kernels.t2i_flash import t2i_flash_kv

    N = 4096

    @functools.lru_cache(maxsize=1)
    def shared(dt):
        gen = torch.Generator(device=device).manual_seed(30 + 100 * draw)
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        kpe = (0.5 * torch.randn(N, 128, generator=gen, device=device)).to(dt)
        return dec, kpe

    def rows(dt, n, seed):
        gen = torch.Generator(device=device).manual_seed(seed + 100 * draw)
        return (0.5 * torch.randn(n, N, 256, generator=gen, device=device)).to(dt), gen

    def k2(dt, T, n):
        dec, kpe = shared(dt)
        keys, gen = rows(dt, n, 31 + T + n)
        q_tok = torch.randn(n, T, 128, generator=gen, device=device).to(dt)
        fa = dec.transformer.final_attn_t2i
        return lambda: (t2i_flash_kv(keys, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b,
                                     kpe, q_tok, 8),)

    def k3(dt, m, n):
        dec, _ = shared(dt)
        src, gen = rows(dt, n, 32 + m + n)
        hyper = torch.randn(n, m, 32, generator=gen, device=device).to(dt)
        up = dec.output_upscaling
        return lambda: (decoder_tail(src.reshape(n, 64, 64, 256), up.convt1.w, up.convt1.b,
                                     up.ln.scale, up.ln.bias, up.convt2.w, up.convt2.b, hyper),)

    dts = ((torch.bfloat16, ""), (torch.float32, "@fp32"))
    return ([(f"K2{sfx} [{n}, {N}, 256], {T} tokens", functools.partial(k2, dt, T, n))
             for dt, sfx in dts for T in K2_TOKENS for n in K1_CANDIDATES]
            + [(f"K3{sfx} [{n}, 64, 64, 256], {m} map{'s' if m > 1 else ''}",
                functools.partial(k3, dt, m, n))
               for dt, sfx in dts for m in K3_MAPS for n in K1_CANDIDATES])


K8_TOKENS = (9, 11, 16, 32)  # the K8 route: 3 points; a box and 4 points; 10; 26


@torch.no_grad()
def k8_cases(device, draw: int = 0):
    """(label, make) of K8a and K8b, redesigned for Hopper on K1's image
    passes, at the K8 route's shapes: rows [n, 4096, 256] (K8b: and q_img
    [n, 4096, 128]) at ``K8_TOKENS`` tokens and ``K1_CANDIDATES``
    candidates, in bf16 and fp32 (the SAM-base decoder's second layer,
    random weights from a seed)."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.i2t_attention import i2t_attention_fused
    from cor_tpu_torch.ops.kernels.t2i_flash import proj_q_t2i_flash

    N = 4096

    @functools.lru_cache(maxsize=1)
    def shared(dt):
        gen = torch.Generator(device=device).manual_seed(40 + 100 * draw)
        dec = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval()
        kpe, qpe = ((0.5 * torch.randn(N, 128, generator=gen, device=device)).to(dt)
                    for _ in range(2))
        return dec.transformer.layers[1], kpe, qpe

    def k8a(dt, T, n):
        lp, kpe, qpe = shared(dt)
        gen = torch.Generator(device=device).manual_seed(41 + 100 * draw + T + n)
        keys = (0.5 * torch.randn(n, N, 256, generator=gen, device=device)).to(dt)
        q_tok = torch.randn(n, T, 128, generator=gen, device=device).to(dt)
        t2i, i2t = lp.cross_attn_t2i, lp.cross_attn_i2t
        return lambda: proj_q_t2i_flash(keys, t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w,
                                        t2i.v_proj.b, i2t.q_proj.w, i2t.q_proj.b, kpe, qpe,
                                        q_tok, 8)

    def k8b(dt, T, n):
        lp, _, _ = shared(dt)
        gen = torch.Generator(device=device).manual_seed(42 + 100 * draw + T + n)
        keys = (0.5 * torch.randn(n, N, 256, generator=gen, device=device)).to(dt)
        q_img = (0.5 * torch.randn(n, N, 128, generator=gen, device=device)).to(dt)
        kv = [torch.randn(n, T, 128, generator=gen, device=device).to(dt) for _ in range(2)]
        o = lp.cross_attn_i2t.out_proj
        return lambda: (i2t_attention_fused(q_img, keys, *kv, o.w, o.b, lp.norm4.scale,
                                            lp.norm4.bias, 8),)

    return [(f"{name}{sfx} [{n}, {N}, 256], {T} tokens", functools.partial(fn, dt, T, n))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32"))
            for name, fn in (("K8a", k8a), ("K8b", k8b))
            for T in K8_TOKENS for n in K1_CANDIDATES]


STACK_TOKENS = (5, 6, 8)  # K1's counts (chip_smoke.py phase 35's)


@torch.no_grad()
def stack_cases(device, draw: int = 0):
    """(label, make) of K1-stack and K1-grid, redesigned on K1's and K2's
    Hopper passes, at the fused decode's shapes: the SAM-base decoder's
    transformer (random weights from a seed) on rows [n, 4096, 256] and on a
    store of 256 rows [4096, 256] through idx, at ``STACK_TOKENS`` tokens and
    ``K1_CANDIDATES`` candidates, in bf16 and fp32."""
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels.two_way_stack import two_way_grid_fused, two_way_stack_fused

    N, S = 4096, 256

    @functools.lru_cache(maxsize=1)
    def shared(dt):
        gen = torch.Generator(device=device).manual_seed(50 + 100 * draw)
        p = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval().transformer
        rnd = lambda *s: (0.5 * torch.randn(*s, generator=gen, device=device)).to(dt)  # noqa: E731
        pes = [rnd(N, 128) for _ in range(5)]
        return p, pes[:2], pes[2:4], pes[4], rnd(S, N, 256)

    def make(fn, dt, T, n, indexed):
        p, kpe, qpe, kpe_f, store = shared(dt)
        gen = torch.Generator(device=device).manual_seed(51 + 100 * draw + T + n)
        tokens = torch.randn(n, T, 256, generator=gen, device=device).to(dt)
        if indexed:
            rows = store
            kw = dict(idx=torch.randint(0, S, (n,), generator=gen, device=device,
                                        dtype=torch.int32))
        else:
            rows = (0.5 * torch.randn(n, N, 256, generator=gen, device=device)).to(dt)
            kw = {}
        return lambda: fn(p, tokens, tokens, rows, kpe, qpe, kpe_f, **kw)

    return [(f"{name}{sfx} [{n}, {N}], {T} tokens, {'store-indexed' if ix else 'rows'}",
             functools.partial(make, fn, dt, T, n, ix))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32"))
            for name, fn in (("K1-stack", two_way_stack_fused), ("K1-grid", two_way_grid_fused))
            for T in STACK_TOKENS for n in K1_CANDIDATES for ix in (False, True)]


@torch.no_grad()
def k1_split(lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, idx=None, scale=None,
             fn=None) -> dict:
    """K1's (or ``fn``'s: K1-dma) device milliseconds by launch
    (``two_way_layer.layer_launches``; each launch alone as CUDA-graph
    replays) and of the layer's launches together, through the library the
    wrappers use now: {"tokens_in": ms, "image_t2i": ms, "tokens_mid": ms,
    "image_i2t": ms, "layer": ms}."""
    from cor_tpu_torch.ops.kernels.two_way_layer import layer_launches, two_way_layer

    launches = layer_launches(fn or two_way_layer, lp, tokens, qpe_tok, keys, kpe, qpe_img,
                              skip_pe, idx=idx, scale=scale)[0]
    out = {name: graph_ms(go) for name, go in launches}
    out["layer"] = graph_ms(lambda: [go() for _, go in launches])
    return out


def graph_ms(run, windows: int = 7, iters: int = 10) -> float:
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
    """(label, make) of K4's and K5's end-to-end caller: the SigLIP towers'
    query encode (an image and its text, random weights from a seed) of
    ViT-B-16-SigLIP-384 (24 K4 and 50 K5 launches) and
    ViT-SO400M-14-SigLIP-384 (54 and 110) at the serving buckets 1, 4 and 16,
    in bf16 and in fp32 (``compute_dtype: float32``: K4@fp32, K5@fp32);
    ``make()`` builds the model (once for its buckets) and inputs and returns
    the thunk."""
    from cor_tpu_torch.models.siglip import SIGLIP_MODELS, SigLIP

    @functools.lru_cache(maxsize=1)
    def model(name, dt):
        gen = torch.Generator(device=device).manual_seed(2)
        m = SigLIP(SIGLIP_MODELS[name]).to(device)
        for p in m.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        return m.to(dt).eval()

    def make(name, dt, b):
        cfg, m = SIGLIP_MODELS[name], model(name, dt)
        gen = torch.Generator(device=device).manual_seed(3 + b)
        images = torch.rand(b, 384, 384, 3, generator=gen, device=device).to(dt)
        tokens = torch.randint(0, cfg.text.vocab_size, (b, cfg.text.context_length),
                               generator=gen, device=device)
        return lambda: m(images, tokens)

    return [(f"query encode {name}{sfx} bucket {b}", functools.partial(make, name, dt, b))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, " fp32"))
            for name in ("ViT-B-16-SigLIP-384", "ViT-SO400M-14-SigLIP-384")
            for b in (1, 4, 16)]


@torch.no_grad()
def encode_cases(device):
    """(label, make) of K6's end-to-end caller: the SAM image encode (random
    weights from a seed, the rel-pos tables and pos_embed filled) of SAM-base
    at batch 1 and 8 (12 K6 launches an encode) and sam_huge at batch 1 (32),
    in bf16 and in fp32 (``compute_dtype: float32``: K6@fp32); ``make()``
    builds the encoder and images."""
    from cor_tpu_torch.models.sam_encoder import SamEncoder, sam_encoder_config

    def make(name, b, dt):
        gen = torch.Generator(device=device).manual_seed(3)
        model = SamEncoder(sam_encoder_config(name)).to(device)
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
        model = model.to(dt).eval()
        images = torch.rand(b, 1024, 1024, 3, generator=gen, device=device).to(dt)
        return lambda: model(images)

    return [(f"image encode {name}{sfx} batch {b}", functools.partial(make, name, b, dt))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, " fp32"))
            for name, b in (("sam_base", 1), ("sam_base", 8), ("sam_huge", 1))]


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


@torch.no_grad()
def decode_cases(device):
    """(label, make) of K1's end-to-end caller: the fused mask decode
    (``sam_decoder.mask_decoder`` out of an int8 store of 256 rows [64, 64,
    256] through idx, one sparse prompt token a candidate: 6 tokens; K1's two
    layers, K2 and K3) of the SAM-base decoder (random weights from a seed)
    at ``K1_CANDIDATES`` candidates, in bf16 and fp32; ``make()`` builds the
    decoder and inputs and returns the thunk."""
    from cor_tpu_torch.models import sam_decoder
    from cor_tpu_torch.models.core_model import CoreConfig, init_decode_model
    from cor_tpu_torch.models.prompt_encoder import get_dense_pe
    from cor_tpu_torch.tools.decode_bench import quantize_rows

    def make(dt, n):
        model = init_decode_model(CoreConfig(), 0).to(device, dt).eval()
        gen = torch.Generator(device=device).manual_seed(22 + n)
        raw = torch.randn(256, 64, 64, 256, generator=gen, device=device)
        store, scales = quantize_rows(raw + model.prompt_encoder.no_mask_embed[0].float())
        del raw
        idx = torch.randint(0, 256, (n,), generator=gen, device=device, dtype=torch.int32)
        prompts = torch.randn(n, 1, 256, generator=gen, device=device).to(dt)
        pe = get_dense_pe(model.prompt_encoder).to(device, dt)
        return lambda: sam_decoder.mask_decoder(model.mask_decoder, store, pe, prompts, None,
                                                False, store_idx=idx, store_scale=scales)

    return [(f"fused decode{sfx} [{n}, 4096], 6 tokens", functools.partial(make, dt, n))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, " fp32"))
            for n in K1_CANDIDATES]


K8_DECODE_TOKENS = 16  # 10 points, or a box and 8 points: the K8 route


@torch.no_grad()
def k8_decode_cases(device):
    """(label, make) of K8a's and K8b's end-to-end caller: the fused mask
    decode on the K8 route (``decode_cases``' int8 store and decoder,
    ``K8_DECODE_TOKENS`` tokens: the rows gathered in torch, each layer's
    token side in torch around K8a and K8b, then K2 and K3) at
    ``K1_CANDIDATES`` candidates, in bf16 and fp32."""
    from cor_tpu_torch.models import sam_decoder
    from cor_tpu_torch.models.core_model import CoreConfig, init_decode_model
    from cor_tpu_torch.models.prompt_encoder import get_dense_pe
    from cor_tpu_torch.tools.decode_bench import quantize_rows

    T = K8_DECODE_TOKENS

    def make(dt, n):
        model = init_decode_model(CoreConfig(), 0).to(device, dt).eval()
        gen = torch.Generator(device=device).manual_seed(23 + n)
        raw = torch.randn(256, 64, 64, 256, generator=gen, device=device)
        store, scales = quantize_rows(raw + model.prompt_encoder.no_mask_embed[0].float())
        del raw
        idx = torch.randint(0, 256, (n,), generator=gen, device=device, dtype=torch.int32)
        prompts = torch.randn(n, T - 5, 256, generator=gen, device=device).to(dt)
        pe = get_dense_pe(model.prompt_encoder).to(device, dt)
        return lambda: sam_decoder.mask_decoder(model.mask_decoder, store, pe, prompts, None,
                                                False, store_idx=idx, store_scale=scales)

    return [(f"fused decode{sfx} [{n}, 4096], {T} tokens, K8 route",
             functools.partial(make, dt, n))
            for dt, sfx in ((torch.bfloat16, ""), (torch.float32, " fp32"))
            for n in K1_CANDIDATES]


def time_e2e(old, device, card: str, only=()) -> list:
    """The towers' query encode (K4's caller), the SAM image encode (K6's)
    and the fused mask decode (K1's, K2's and K3's; on the K8 route K8a's and
    K8b's) through ``old`` and the current library (old, new, new, old;
    host-launched, CUDA events, and for the towers and the decode as
    CUDA-graph replays too: the device's time alone; the encoder copies its
    rel-pos indices from the host at each call, which a graph cannot
    capture); one JSON line each. ``only``: the cases whose label holds one
    of its parts (K1, K2 and K3 select the decode at 6 tokens, K8a and K8b
    the K8 route's). Returns the K8 route's cases whose graph replays were
    slower through the current library."""
    import json

    e2e = {"K1": "6 tokens", "K2": "6 tokens", "K3": "6 tokens", "K8a": "K8 route",
           "K8b": "K8 route"}
    only = tuple(e2e.get(o, o) for o in only)
    cases = [(label, make, True) for label, make in tower_cases(device)]
    cases += [(label, make, False) for label, make in encode_cases(device)]
    cases += [(label, make, True) for label, make in decode_cases(device)]
    cases += [(label, make, True) for label, make in k8_decode_cases(device)]
    slower = []
    for label, make, graph in cases:
        if only and not any(o in label for o in only):
            continue
        use_library(None)
        run = make()
        times = {"old": [], "new": [], "old_graph": [], "new_graph": []}
        for which in ("old", "new", "new", "old"):
            use_library(old if which == "old" else None)
            times[which].append(_eager_ms(run))
            if graph:
                times[f"{which}_graph"].append(graph_ms(run, iters=3))
        use_library(None)
        print(json.dumps({"e2e": label, "old_ms": times["old"], "new_ms": times["new"],
                          "old_graph_ms": times["old_graph"], "new_graph_ms": times["new_graph"],
                          "card": card}), flush=True)
        if "K8 route" in label and min(times["new_graph"]) > min(times["old_graph"]):
            slower.append(label)
        del run
        torch.cuda.empty_cache()
    return slower


def float64_errors(old, run) -> dict:
    """Both libraries' largest |error| of a K6b-in-fp32 case's outputs
    against its float64 yardstick (``run.exact``)."""
    use_library(old)
    old_out = run()
    use_library(None)
    new_out = run()
    exact = run.exact()
    return {name: [(x.double() - e).abs().max().item() for x, e in zip(outs, exact)]
            for name, outs in (("old", old_out), ("new", new_out))}


def time_redesigned(old, device, only=(), draws: int = 1) -> int:
    """Time every case of ``timed_cases``, ``k1_cases``, ``k2k3_cases``,
    ``k8_cases`` and ``stack_cases`` (those whose label holds one of
    ``only``, if given) through ``old`` and the current library (old, new,
    new, old; CUDA graphs of 10 calls); one JSON line each, with each call's
    kernels' device time (torch.profiler), for K1 both libraries' device
    time by launch, for the decoder's kernels whether the outputs are the old
    library's bit for bit, and for K6b in fp32 both libraries' largest errors
    against float64 (on ``draws`` draws of the inputs). Returns 1 if a new
    kernel is slower than the old one anywhere, or the K8 route's decode
    (``time_e2e``) is, or a decoder kernel's bits differ."""
    import json
    import subprocess as sp

    smi = sp.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                 capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip() if smi else torch.cuda.get_device_name(0)
    slower, differ = [], []
    # the cases whose kernels keep the old library's bits (the decoder's,
    # redesigned with their bits kept); the others' sums run in another order
    keep = [label for label, _ in k1_cases(device) + k2k3_cases(device) + k8_cases(device)
            + stack_cases(device) + dma_cases(device)]
    for label, make in (timed_cases(device) + k1_cases(device) + k2k3_cases(device)
                        + k8_cases(device) + stack_cases(device) + dma_cases(device)
                        + k9_cases(device)):
        if only and not any(o in label for o in only):
            continue
        use_library(None)  # the inputs (and a forward's lse) from the current library
        run = make()
        use_library(old)
        old_out = run()
        use_library(None)
        new_out = run()
        torch.cuda.synchronize()
        diff = max(((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
                   for a, b in zip(new_out, old_out))
        line = {"kernel": label}
        if label in keep:
            line["bits_equal"] = all(torch.equal(a, b) for a, b in zip(new_out, old_out))
            if not line["bits_equal"]:
                differ.append(label)
        if hasattr(run, "k1"):  # K1-dma: K1's bits, K1's time in the same call
            line["bits_equal_to_k1"] = all(torch.equal(a, b) for a, b in zip(new_out, run.k1()))
            line["k1_ms"] = [graph_ms(run.k1), graph_ms(run.k1)]
            if not line["bits_equal_to_k1"]:
                differ.append(f"{label} (against K1)")
        if hasattr(run, "plain"):  # K9: within its tolerance of the plain version
            err = max((a.float() - b.float()).abs().max().item()
                      for a, b in zip(new_out, run.plain()))
            line.update(max_abs_err_vs_plain=err, tol=K9_TOL)
            if err > K9_TOL:
                differ.append(f"{label} (plain version: {err:.3e})")
        del old_out, new_out
        if hasattr(run, "exact"):
            line["max_abs_err_vs_float64"] = float64_errors(old, run)
            for draw in range(1, draws):
                use_library(None)
                again = dict(timed_cases(device, draw))[label]()
                line.setdefault("max_abs_err_vs_float64_other_draws", []).append(
                    float64_errors(old, again))
                del again
            torch.cuda.empty_cache()
        times = {"old": [], "new": []}
        for which in ("old", "new", "new", "old"):
            use_library(old if which == "old" else None)
            times[which].append(graph_ms(run))
        old_us = _device_us(run)
        if hasattr(run, "split"):
            line["old_split_ms"] = run.split()
        use_library(None)
        if hasattr(run, "split"):
            line["new_split_ms"] = run.split()
        t_old, t_new = min(times["old"]), min(times["new"])
        line.update(old_ms=times["old"], new_ms=times["new"], speedup=t_old / t_new,
                    max_rel_diff=diff, card=card, old_kernels_us=old_us,
                    new_kernels_us=_device_us(run))
        print(json.dumps(line), flush=True)
        if t_new > t_old:
            slower.append(label)
        del run
        torch.cuda.empty_cache()
    slower += time_e2e(old, device, card, only)
    print(f"redesigned kernels (and the K8 route's decode) against the old library: "
          f"{'faster at every shape' if not slower else f'slower at {slower}'}; the "
          f"decoder's kept their bits (K1-dma K1's, K9 within {K9_TOL} of its plain "
          f"version){'' if not differ else f' but at {differ}'}")
    return 1 if slower or differ else 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    timing = "--time" in argv
    argv = [a for a in argv if a != "--time"]
    only, draws = (), 1
    if "--only" in argv:  # --only LABEL_PART,...: time only the cases whose label holds one
        i = argv.index("--only")
        only = tuple(argv[i + 1].split(",")) if i + 1 < len(argv) else ()
        argv = argv[:i] + argv[i + 2:]
    if "--draws" in argv:  # --draws N: K6b in fp32's errors on N draws of its inputs
        i = argv.index("--draws")
        draws = int(argv[i + 1]) if i + 1 < len(argv) else 1
        argv = argv[:i] + argv[i + 2:]
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
    old = _OldABI(build_old(Path(argv[0]), missing), missing, narrow_i2t(Path(argv[0])))
    torch.set_grad_enabled(False)  # the decoder kernels take no autograd
    if timing:
        return time_redesigned(old, device, only, draws)
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
