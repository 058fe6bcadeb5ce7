"""Build the port's CUDA kernels from ``cor_tpu_torch/csrc`` and load them.

Every ``*.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` for
Hopper (``sm_90a``), all of them at once, and the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library goes into ``cor_tpu_torch/_build/`` (git-ignored) under a name that carries a hash of the sources and flags, so
an edited source is rebuilt at its first use and an unchanged one is loaded
as it is. Nothing is built at import time: the first kernel launch (or an
explicit :func:`library` call) builds.

The kernels take their compute dtype, bf16 or fp32, as a flag (``f32``) of
each C entry point; :func:`operand_dtype` is the wrappers' check of it and
:func:`count_launch` counts a wrapper's launches by it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v", "-lineinfo",
)

_VP = ctypes.c_void_p
_I = ctypes.c_int
# every entry but cor_layer_norm and cor_add_layer_norm takes its compute
# dtype as f32 (0: bf16, 1: fp32) just before the stream; the decoder's
# entries take their token count as n_tok, just after n
_SIGNATURES = {
    # x, scale, bias, y, rows, cols, eps, x_bf16, w_bf16, stream
    "cor_layer_norm": (
        _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _VP,
    ),
    # x, y, scale, bias, out, rows, cols, eps, x_bf16, y_bf16, w_bf16, stream
    "cor_add_layer_norm": (
        _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ),
    # q, k, v, out, B, H, N, D, in_b, in_h, in_n, out_b, out_h, out_n, f32, stream
    "cor_seq_attention": (
        _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *(ctypes.c_longlong,) * 6, _I, _VP,
    ),
    # qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale, f32, stream
    "cor_vit_attention_relpos": (
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, _I, _VP,
    ),
    # qkv, rel_h, rel_w, out, B, Hp, Wp, H, W, C, num_heads, window, scale, f32, stream
    "cor_vit_attention_relpos_windows": (
        _VP, _VP, _VP, _VP, *(ctypes.c_int,) * 8, ctypes.c_float, _I, _VP,
    ),
    # qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w, stats, B, N, C, num_heads, H,
    # W, scale, f32, stream
    "cor_vit_attention_relpos_bwd": (
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _I, _VP,
    ),
    # tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps, n, n_tok, x_out, qt_out,
    # f32, stream
    "cor_twl_tokens_in": (
        _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _I, _VP, _VP, _I, _VP,
    ),
    # src, src_int8, idx, scale, S, n, n_tok, N, w, b, kpe, qpe, qt, q_img, part_m, part_l,
    # part_acc, f32, stream
    "cor_t2i_image_pass": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP,
    ),
    # x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps, n, n_tok, tokens_out, k_out,
    # v_out, f32, stream
    "cor_twl_tokens_mid": (
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_float, ctypes.c_int, _I,
        _VP, _VP, _VP, _I, _VP,
    ),
    # src, src_int8, idx, scale, S, n, n_tok, N, q_img, k_i, v_i, wo, bo_ln4, eps,
    # cross_scale, keys_out, f32, stream
    "cor_twl_image_i2t": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, ctypes.c_float, ctypes.c_float, _VP, _I, _VP,
    ),
    # part_m, part_l, part_acc, tiles, n, n_tok, out, f32, stream
    "cor_t2i_combine": (_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, _VP, _I, _VP),
    # K2: keys, n, n_tok, N, w, w_blocks, b, kpe, qt, part_m, part_l, part_acc, tickets, out,
    # f32, stream
    "cor_t2i_final": (
        _VP, ctypes.c_int, _I, ctypes.c_int, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
        _I, _VP,
    ),
    # K8a: keys, n, n_tok, N, w, w_blocks, b, kpe, qpe, qt, q_img, part_m, part_l, part_acc,
    # tickets, out, f32, stream
    "cor_t2i_proj_q": (
        _VP, ctypes.c_int, _I, ctypes.c_int, *(_VP,) * 12, _I, _VP,
    ),
    # K1's stages 1 and 3 over a cluster of CTAs a candidate: cor_twl_tokens_in's and
    # cor_twl_tokens_mid's arguments
    "cor_twl_tokens_in_cluster": (
        _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _I, _VP, _VP, _I, _VP,
    ),
    "cor_twl_tokens_mid_cluster": (
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_float, ctypes.c_int, _I,
        _VP, _VP, _VP, _I, _VP,
    ),
    # K1's own image passes (redesigned for Hopper): cor_t2i_image_pass's and
    # cor_twl_image_i2t's arguments, each with the weight laid out as its ring's
    # blocks after the weight (w_blocks, wo_blocks)
    "cor_twl_t2i": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP,
    ),
    "cor_twl_i2t": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_float, ctypes.c_float, _VP, _I, _VP,
    ),
    # K1-dma's image passes: cor_twl_t2i's and cor_twl_i2t's arguments
    "cor_twl_dma_image_t2i": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _VP,
    ),
    "cor_twl_dma_image_i2t": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_float, ctypes.c_float, _VP, _I, _VP,
    ),
    # cluster, S, n, n_tok, N, ptrs (a host array of device pointers), self_scale,
    # cross_scale, eps, f32, stream
    "cor_two_way_fused": (
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _I, ctypes.c_int, _VP,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, _I, _VP,
    ),
    # cluster, n, n_tok, N, f32, team (int32 [2], host): the launch cor_two_way_fused
    # would make
    "cor_two_way_fused_team": (ctypes.c_int, ctypes.c_int, _I, ctypes.c_int, _I, _VP),
    # x, wt, b, hyper, out, B, H, W, C, O, N, f32, stream
    "cor_fused_upscale2_hyper": (_VP, _VP, _VP, _VP, _VP, *(ctypes.c_int,) * 6, _I, _VP),
    # src, w1t, w2t, w_blocks, vec, hyper, n, m, H, eps, out, f32, stream
    "cor_decoder_tail": (
        _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        _VP, _I, _VP,
    ),
}


def _sources():
    return sorted(list(CSRC_DIR.glob("*.cu")) + list(CSRC_DIR.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of cor_tpu_torch are built from source at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcor_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists.

    One ``nvcc -c`` per source, all started together, then one link. The
    build writes to temporary names and renames the library into place, so
    two processes that build at once both end with a whole library. The
    compilers' output (with ``-Xptxas=-v``: registers, shared memory and
    spills of every kernel) and when each finished are kept beside the
    library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    t0 = time.perf_counter()
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    # each compiler's output, read as it runs, and the seconds it took
    outs = {}
    readers = [threading.Thread(target=lambda p=p: outs.__setitem__(
        p, (p.communicate()[0], time.perf_counter() - t0))) for _, _, p in jobs]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        text, secs = outs[proc]
        logs.append(f"$ {' '.join(cmd)}\n# {Path(cmd[-1]).name}: done {secs:.1f} s after the "
                    f"build started\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *[str(obj) for _, obj, _ in jobs]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the compute dtypes the kernels take
FP16_ITEM = "ROADMAP Queue 2, @fp16"  # the row that ports the kernels to fp16


def operand_dtype(what: str, *ts) -> torch.dtype:
    """The one compute dtype (bf16 or fp32) of a kernel's operands ``ts``
    (``None`` skipped); raises ``TypeError`` on another dtype or a mix of
    two, before anything launches."""
    dts = {t.dtype for t in ts if t is not None}
    if len(dts) != 1 or next(iter(dts)) not in KERNEL_DTYPES:
        fp16 = f" (fp16: {FP16_ITEM})" if torch.float16 in dts else ""
        raise TypeError(f"{what} kernel takes bf16 or fp32 operands, all of one dtype; got "
                        f"{', '.join(sorted(str(d) for d in dts))}{fp16}")
    return dts.pop()


def count_launch(fn, dtype: torch.dtype, n: int = 1) -> None:
    """Add ``n`` launches to the wrapper ``fn``'s count of its ``dtype``:
    ``fn.launches`` (bf16) or ``fn.launches_fp32``."""
    if dtype == torch.float32:
        fn.launches_fp32 += n
    else:
        fn.launches += n
