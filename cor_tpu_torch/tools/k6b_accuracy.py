"""Where K6b in fp32 loses its digits: its largest errors against float64
beside those of float64 backwards that take one of its inexact parts at a
time, on the card.

    python3 -m cor_tpu_torch.tools.k6b_accuracy

At SAM-base's (12 heads of 64) and sam_huge's (16 of 80) global shape, one
image of 64 x 64 tokens, fp32 inputs from a seed, TF32 off, it prints one
JSON line per shape with the largest |error| of (dqkv, drel_h, drel_w)
against K6b's function in float64 for

- ``kernel``: K6b in fp32 given the fp32 K6's out and lse;
- ``plain``: the plain fp32 backward (torch's fp32 products);
- ``lse``: float64 with a = exp(l - lse) from the fp32 K6's lse;
- ``delta``: float64 with delta = rowsum(do * out) over the fp32 K6's out;
- ``stats``: float64 with both, the kernel's statistics;
- ``tf32x3``: float64 sums of 3xTF32 products (each fp32 operand split into
  its big and small TF32 halves, round to nearest, and the small * small
  term dropped, as csrc/mma_tf32x3.cuh does), exact statistics;
- ``tf32x3+stats``: both.
"""

from __future__ import annotations

import json
import sys

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero (cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take an fp32 product on the tensor cores: the
    operands rounded to fp32 and split into TF32 halves, small * big + big *
    small + big * big, here summed in float64."""
    a32, b32 = a.float(), b.float()
    ab, bb = tf32(a32), tf32(b32)
    a_s, b_s = tf32(a32 - ab), tf32(b32 - bb)
    d = torch.float64
    return a_s.to(d) @ bb.to(d) + ab.to(d) @ b_s.to(d) + ab.to(d) @ bb.to(d)


def k6b_float64(qkv, rel_h, rel_w, do, heads: int, hw, lse=None, out=None, mm=torch.matmul):
    """K6b's function in float64, image by image: (dqkv, drel_h, drel_w).
    With ``lse``, a = exp(l - lse) (else the exact softmax); with ``out``,
    delta = rowsum(do * out) (else the exact rowsum(a * da)); every product
    by ``mm`` (``mm_tf32x3``: the kernels' 3xTF32 products on fp32
    operands)."""
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    D = C // heads
    d = torch.float64
    exact = mm is torch.matmul
    res = []
    for i in range(B):
        q, k, v = (qkv[i, :, j * C:(j + 1) * C].reshape(N, heads, D).transpose(0, 1)
                   for j in range(3))
        dof = do[i].reshape(N, heads, D).transpose(0, 1)
        if exact:
            q, k, v, dof = (x.to(d) for x in (q, k, v, dof))
            qs = q * D**-0.5
        else:
            qs = (q.float() * D**-0.5).float()  # the kernel's fp32 q * scale
        logits = mm(qs, k.transpose(-1, -2)).reshape(heads, N, H, W)
        logits = logits + rel_h[i].to(d)[..., :, None] + rel_w[i].to(d)[..., None, :]
        logits = logits.reshape(heads, N, N)
        if lse is None:
            a = torch.softmax(logits, dim=-1)
        else:
            a = torch.exp(logits - lse[i].to(d)[..., None])
        del logits
        da = mm(dof, v.transpose(-1, -2))
        if out is None:
            delta = (a * da).sum(dim=-1, keepdim=True)
        else:
            delta = (do[i].to(d) * out[i].to(d)).reshape(N, heads, D).sum(-1).T[..., None]
        dl = a * (da - delta)
        del da
        merge = lambda x: x.transpose(0, 1).reshape(N, C).to(d)  # noqa: E731
        dqkv = torch.cat([merge(mm(dl, k) * D**-0.5), merge(mm(dl.transpose(-1, -2), qs)),
                          merge(mm(a.transpose(-1, -2), dof))], dim=-1)
        dl4 = dl.reshape(heads, N, H, W)
        res.append((dqkv, dl4.sum(dim=-1), dl4.sum(dim=-2)))
        del a, dl, dl4
    return tuple(torch.stack(x) for x in zip(*res))


def errors(got, exact):
    return [(g.double() - e).abs().max().item() for g, e in zip(got, exact)]


def main(argv=None) -> int:
    from cor_tpu_torch.ops.kernels.vit_attention import (
        vit_attention_relpos_bwd,
        vit_attention_relpos_bwd_plain,
        vit_attention_relpos_with_lse,
    )

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    torch.set_grad_enabled(False)
    for heads, D in ((12, 64), (16, 80)):
        gen = torch.Generator(device=device).manual_seed(13)
        side, N, C = 64, 4096, heads * D
        rnd = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
        qkv, do = rnd(1, N, 3 * C), rnd(1, N, C)
        rel_h, rel_w = 0.3 * rnd(1, heads, N, side), 0.3 * rnd(1, heads, N, side)
        hw = (side, side)
        out, lse = vit_attention_relpos_with_lse(qkv, rel_h, rel_w, heads, hw)
        exact = k6b_float64(qkv, rel_h, rel_w, do, heads, hw)
        line = {"shape": f"d{D} [1, {N}, {3 * C}]"}
        line["kernel"] = errors(vit_attention_relpos_bwd(qkv, rel_h, rel_w, do, heads, hw,
                                                         out=out, lse=lse), exact)
        line["plain"] = errors(vit_attention_relpos_bwd_plain(qkv, rel_h, rel_w, do, heads, hw),
                               exact)
        for name, kw in (("lse", dict(lse=lse)), ("delta", dict(out=out)),
                         ("stats", dict(lse=lse, out=out)), ("tf32x3", dict(mm=mm_tf32x3)),
                         ("tf32x3+stats", dict(lse=lse, out=out, mm=mm_tf32x3))):
            line[name] = errors(k6b_float64(qkv, rel_h, rel_w, do, heads, hw, **kw), exact)
            torch.cuda.empty_cache()
        line["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(line), flush=True)
        del exact
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
