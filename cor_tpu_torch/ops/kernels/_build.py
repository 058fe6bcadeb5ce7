"""Build the port's CUDA kernels from ``cor_tpu_torch/csrc`` and load them.

Every ``*.cu`` file under ``csrc/`` is compiled by its own ``nvcc`` for
Hopper (``sm_90a``), all of them at once, and the objects are linked into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library goes into ``cor_tpu_torch/_build/`` (git-ignored) under a name that carries a hash of the sources and flags, so
an edited source is rebuilt at its first use and an unchanged one is loaded
as it is. Nothing is built at import time: the first kernel launch (or an
explicit :func:`library` call) builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas=-v", "-lineinfo",
)

_VP = ctypes.c_void_p
_SIGNATURES = {
    # x, scale, bias, y, rows, cols, eps, x_bf16, w_bf16, stream
    "cor_layer_norm": (
        _VP, _VP, _VP, _VP, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, _VP,
    ),
    # qkv, out, B, N, C, num_heads, stream
    "cor_seq_attention_qkv": (
        _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _VP,
    ),
    # qkv, rel_h, rel_w, out, B, N, C, num_heads, H, W, scale, stream
    "cor_vit_attention_relpos": (
        _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, _VP,
    ),
    # qkv, rel_h, rel_w, dout, dqkv, drel_h, drel_w, stats, B, N, C, num_heads, H, W, scale,
    # stream
    "cor_vit_attention_relpos_bwd": (
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _VP,
    ),
    # tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps, n, x_out, qt_out, stream
    "cor_twl_tokens_in": (
        _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _VP, _VP, _VP,
    ),
    # src, src_int8, idx, scale, S, n, N, w, b, kpe, qpe, qt, q_img, part_m, part_l,
    # part_acc, stream
    "cor_t2i_image_pass": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
    ),
    # x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps, n, tokens_out, k_out,
    # v_out, stream
    "cor_twl_tokens_mid": (
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int, _VP, _VP, ctypes.c_float, ctypes.c_int,
        _VP, _VP, _VP, _VP,
    ),
    # src, src_int8, idx, scale, S, n, N, q_img, k_i, v_i, wo, bo_ln4, eps, cross_scale,
    # keys_out, stream
    "cor_twl_image_i2t": (
        _VP, ctypes.c_int, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _VP, _VP, _VP, _VP, _VP, ctypes.c_float, ctypes.c_float, _VP, _VP,
    ),
    # part_m, part_l, part_acc, tiles, n, out, stream
    "cor_t2i_combine": (_VP, _VP, _VP, ctypes.c_int, ctypes.c_int, _VP, _VP),
    # src, w1t, w2t, vec, hyper, n, m, H, eps, out, stream
    "cor_decoder_tail": (
        _VP, _VP, _VP, _VP, _VP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        _VP, _VP,
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
    spills of every kernel) is kept beside the library as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, obj, proc in jobs:
        text = proc.communicate()[0]
        logs.append(f"$ {' '.join(cmd)}\n{text}")
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
