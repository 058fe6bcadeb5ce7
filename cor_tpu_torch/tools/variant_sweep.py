"""Time variants of K9 (``csrc/upscale.cu``) that differ in one design
constant, on the card, through the kernel's own wrapper.

    python3 -m cor_tpu_torch.tools.variant_sweep

Each variant is a copy of ``upscale.cu`` with textual substitutions (the
consumer warpgroups a CTA, the maps whose hyper dots a thread sums at once),
built alone into a library of its own under ``cor_tpu_torch/_build/`` (one
``nvcc`` each, all at once), and run through ``ops/kernels/upscale.py`` with
the wrapper pointed at it: every variant is checked against the plain
version (K9's tolerance, 1e-4) and timed as CUDA-graph replays
(``kernel_bits.graph_ms``), in turns, twice, at the decoder's shape
(x [40, 128, 128, 64], O 32, N 1 and 4) in bf16 and fp32. One JSON line a
shape and dtype, with each variant's ptxas registers and spills and the
card's name and power limit. The shipped constants are the "shipped"
variant.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys

import torch

from cor_tpu_torch.ops.kernels import _build

SOURCE = _build.CSRC_DIR / "upscale.cu"
GROUPS = "constexpr int kGroupsOf = kNP == 256 ? 2 : 3;"
GROUPS_PLAN = "groups > (n == 256 ? 2 : 3)"
MAPS = "constexpr int kMaps = 2;"
ORDER3 = "{{4, 3}, {4, 2}, {2, 3}, {2, 2}, {1, 3},"


def _groups(g: int) -> dict:
    """Substitutions for at most ``g`` consumer warpgroups a CTA (2 at n 256)."""
    return {GROUPS: f"constexpr int kGroupsOf = kNP == 256 ? 2 : {g};",
            GROUPS_PLAN: f"groups > (n == 256 ? 2 : {g})",
            ORDER3: ORDER3.replace("3}", f"{g}}}")}


VARIANTS = {
    "shipped": {},
    "4 warpgroups": _groups(4),
    "2 warpgroups": _groups(2),
    "4 maps at once": {MAPS: "constexpr int kMaps = 4;"},
}
SHAPES = ((40, 128, 128, 64, 32, 1), (40, 128, 128, 64, 32, 4))
TOL = 1e-4


def build(name: str, subs: dict):
    """The variant's library and its ptxas lines (registers, spills)."""
    text = SOURCE.read_text()
    for a, b in subs.items():
        if a not in text:
            raise ValueError(f"{SOURCE.name} has no {a!r}: the variant is stale")
        text = text.replace(a, b)
    tag = re.sub(r"\W+", "_", name)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / f"variant_{tag}.cu"
    out = _build.BUILD_DIR / f"libcor_variant_{tag}.so"
    src.write_text(text)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
                             "-shared", "-o", str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return src, out, proc


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 2
    from cor_tpu_torch.ops.kernels import upscale as up
    from cor_tpu_torch.tools.kernel_bits import graph_ms

    jobs = {name: build(name, subs) for name, subs in VARIANTS.items()}
    libs, ptxas = {}, {}
    for name, (src, out, proc) in jobs.items():
        log = proc.communicate()[0]
        src.unlink()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
        ptxas[name] = [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                       if "Used" in ln or "spill stores" in ln]
        lib = ctypes.CDLL(str(out))
        fn = lib.cor_fused_upscale2_hyper
        fn.argtypes = list(_build._SIGNATURES["cor_fused_upscale2_hyper"])
        fn.restype = ctypes.c_int
        libs[name] = lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"ptxas": ptxas, "card": smi}))
    dev = torch.device("cuda")
    torch.set_grad_enabled(False)
    failed = False
    try:
        for dt in (torch.bfloat16, torch.float32):
            for B, H, W, C, O, N in SHAPES:
                gen = torch.Generator(device=dev).manual_seed(3)
                rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
                x, h = rnd(B, H, W, C).to(dt), rnd(B, N, O).to(dt)
                w, b = (rnd(C, 2, 2, O) / C ** 0.5).to(dt), 0.1 * rnd(O)
                want = up.fused_upscale2_hyper_plain(x, w, b, h)
                line = {"shape": [B, H, W, C, O, N], "dtype": str(dt)[6:], "card": smi}
                for _ in range(2):
                    for name, lib in libs.items():
                        up.library = lambda lib=lib: lib
                        err = (up.fused_upscale2_hyper(x, w, b, h) - want).abs().max().item()
                        failed |= err > TOL
                        line.setdefault(f"{name} ms", []).append(
                            graph_ms(lambda: up.fused_upscale2_hyper(x, w, b, h)))
                        line[f"{name} max_abs_err"] = err
                print(json.dumps(line), flush=True)
    finally:
        up.library = _build.library
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
