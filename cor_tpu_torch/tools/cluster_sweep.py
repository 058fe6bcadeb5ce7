"""Time K1-stack and K1-grid at each size of a candidate's team of CTAs on
the card (``csrc/two_way_stack.cuh``: a cluster of 2, 4 or 8 CTAs, or the
CTA alone), beside the size the kernel chooses itself.

    python3 -m cor_tpu_torch.tools.cluster_sweep [--n 40,128] [--tokens 6]

runs both schedules of the SAM-base decoder's transformer (random weights
from a seed) on rows [n, 4096, 256], bf16 and fp32, at each size (1, 2, 4,
8, and 0: the kernel's choice) and prints one JSON line per case: device ms
per call (``kernel_bits.graph_ms``: CUDA-graph replays), whether the size's
outputs equal the kernel's choice's bit for bit, and the card's name and
power limit; a size the card refuses is printed with its error.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch


@torch.no_grad()
def sweep(device, ns=(40, 128), tokens=(6,), sizes=(0, 1, 2, 4, 8)):
    from cor_tpu_torch.models.core_model import CoreConfig, init_mask_decoder
    from cor_tpu_torch.ops.kernels import two_way_stack as ws
    from cor_tpu_torch.tools.kernel_bits import graph_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()
    card = smi[0].strip() if smi else torch.cuda.get_device_name(0)
    N = 4096
    for dt, sfx in ((torch.bfloat16, ""), (torch.float32, "@fp32")):
        gen = torch.Generator(device=device).manual_seed(60)
        p = init_mask_decoder(CoreConfig(), 1).to(device, dt).eval().transformer
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device).to(dt)  # noqa: E731
        kpe, qpe = [0.5 * rnd(N, 128) for _ in range(2)], [0.5 * rnd(N, 128) for _ in range(2)]
        kpe_f = 0.5 * rnd(N, 128)
        for n in ns:
            keys = 0.5 * rnd(n, N, 256)
            for T in tokens:
                tok = rnd(n, T, 256)
                for fn in (ws.two_way_stack_fused, ws.two_way_grid_fused):
                    name = fn.__name__
                    ref = None
                    for size in sizes:
                        ws.CLUSTER_SIZE[name] = size
                        line = {"kernel": f"{'K1-stack' if 'stack' in name else 'K1-grid'}{sfx}",
                                "n": n, "tokens": T, "team": size or "chosen", "card": card}
                        try:
                            run = lambda: fn(p, tok, tok, keys, kpe, qpe, kpe_f)  # noqa: E731
                            out = run()
                            torch.cuda.synchronize()
                            if ref is None:
                                ref = out
                            line["bits_equal_to_chosen"] = all(
                                torch.equal(a, b) for a, b in zip(out, ref))
                            line["ms"] = graph_ms(run)
                        except RuntimeError as e:
                            line["error"] = str(e)
                        finally:
                            ws.CLUSTER_SIZE[name] = 0
                        print(json.dumps(line), flush=True)
            del keys
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(zip(argv[::2], argv[1::2]))
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 2
    ns = tuple(int(v) for v in opts.get("--n", "40,128").split(","))
    tokens = tuple(int(v) for v in opts.get("--tokens", "6").split(","))
    sweep(torch.device("cuda"), ns, tokens)
    return 0


if __name__ == "__main__":
    sys.exit(main())
