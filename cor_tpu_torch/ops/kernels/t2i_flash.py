"""The token -> image attention of the SAM two-way transformer: the CUDA
kernels of ``csrc/t2i_flash.cu`` and their plain PyTorch versions.

Replaces ``cor_tpu/ops/pallas/t2i_flash.py``'s two kernels:

- ``t2i_flash_kv`` (K2, its ``pallas_call`` at line 220): the final
  attention. Per candidate, with the image rows ``keys`` [N, C] and the
  projected token queries ``q_tok`` [T, I]:

      k = bf16(keys @ wk + bk + kpe),  v = bf16(keys @ wv + bv)
      out[t, head h] = softmax_over_rows(q_h[t] k_h^T / sqrt(d)) v_h

  for every head of width d = I / heads, without k or v reaching device
  memory.
- ``proj_q_t2i_flash`` (K8a, its ``pallas_call`` at line 163): the same
  attention inside a two-way layer, which also emits the image -> token
  query ``q_img = bf16(keys @ wq + bq + qpe)`` of every row. ``cor_tpu``'s
  fused decode runs it where its layer kernel (K1) does not: above 8 tokens
  (SAM's stock prompts: 3 points or more, a box and 2 points or more).

The queries are scaled and rounded to the compute dtype first, the
exponentials are rounded before their product with v, and the division by
the fp32 row sum comes last, as in the TPU kernels.

On the card each is two launches (``launches`` adds 2 per call): the image
pass (one CTA per 64-row tile of a candidate: projections on the tensor
cores, q_img written out for K8a, then the tile's flash partials: max, sum
and the unnormalised [heads x T, d] product) and a combine over the tiles.
The image pass is shared with stage 2 of the two-way layer kernel. The
kernels take C = 256, 8 heads, I = 128, T from 5 to 32 tokens (the mask
decoder's 5 output tokens and up to 27 prompt tokens) and N a multiple of
64, in bf16 or fp32 (keys, the PE projections and q_tok of one dtype; in
fp32 the projections run in 3xTF32 on the tensor cores and nothing is
rounded); any other CUDA input raises, and a CPU tensor takes the plain
version. With autograd recording they raise: ``cor_tpu``'s kernels have no
backward either. Launches are counted by dtype (``launches``: bf16,
``launches_fp32``).
"""

from __future__ import annotations

import math

import torch

from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype

# the SAM decoder's geometry, which the decoder kernels take
C_DIM, HEADS, INTERNAL = 256, 8, 128
ROW_TILE = 64  # image rows per CTA of the image passes
MIN_TOKENS, MAX_TOKENS = 5, 32  # the tokens of a decode: 5 output tokens + the prompts


def cached_pack(holder, attr: str, tensors, device, dtype, make):
    """``make()``, kept on ``holder`` as ``attr`` and made again only for
    another device or compute dtype, when one of ``tensors`` is another
    tensor (the per-call copies of an eval under ``functional_call``), or
    when one was written in place since (its ``_version``: an optimizer's
    step, a checkpoint's ``copy_``): serving weights are packed once, a pack
    of one dtype never reaches the kernel of the other, and a validation
    after a training epoch runs that epoch's weights. A tensor made under
    ``torch.inference_mode`` keeps no version (those per-call copies are
    new tensors at every call)."""
    stamp = [(id(t), 0 if t.is_inference() else t._version) for t in tensors]
    cache = getattr(holder, attr, None)
    if cache is None or cache[0] != (device, dtype) or cache[1] != stamp:
        # the tensors ride along so that their ids stay theirs while cached
        cache = ((device, dtype), stamp, make(), tuple(tensors))
        setattr(holder, attr, cache)
    return cache[2]


def t2i_flash_kv_plain(keys, wk, bk, wv, bv, kpe, q_tok, num_heads: int) -> torch.Tensor:
    """The plain PyTorch version: [n, T, I] in the keys' dtype. ``wk``/``wv``
    are [I, C] (``Dense`` layout), ``kpe`` [N, I], ``q_tok`` [n, T, I]."""
    dt = keys.dtype
    r = lambda x: x.to(dt).float()  # noqa: E731 -- round to the compute dtype
    n, T, I = q_tok.shape
    d = I // num_heads
    kf = keys.float()
    k = r(kf @ wk.float().T + bk.float() + kpe.float())
    v = r(kf @ wv.float().T + bv.float())
    qh = r(q_tok.float() / math.sqrt(d)).reshape(n, T, num_heads, d).transpose(1, 2)
    kh = k.reshape(n, -1, num_heads, d).transpose(1, 2)
    vh = v.reshape(n, -1, num_heads, d).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2)  # [n, H, T, N]
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = (r(e) @ vh) / e.sum(dim=-1, keepdim=True)
    return out.transpose(1, 2).reshape(n, T, I).to(dt)


def proj_q_t2i_flash_plain(keys, wk, bk, wv, bv, wq, bq, kpe, qpe, q_tok, num_heads: int):
    """The plain PyTorch version of K8a: (q_img [n, N, I], attention [n, T,
    I]) in the keys' dtype; ``wq`` [I, C] and ``qpe`` [N, I] as ``wk`` and
    ``kpe``."""
    dt = keys.dtype
    q_img = (keys.float() @ wq.float().T + bq.float() + qpe.float()).to(dt)
    return q_img, t2i_flash_kv_plain(keys, wk, bk, wv, bv, kpe, q_tok, num_heads)


def _flash(keys, w, b, kpe, qpe, q_tok, dt, emit_q: bool):
    """The image pass (with ``qpe``: q_img written too) and the combine:
    (q_img or None, attention [n, T, I])."""
    n, N, _ = keys.shape
    T = q_tok.shape[1]
    dev = keys.device
    qt = (q_tok.float() / math.sqrt(INTERNAL // HEADS)).to(dt).contiguous()
    tiles = N // ROW_TILE
    f32 = dict(device=dev, dtype=torch.float32)
    part_m = torch.empty((n, tiles, HEADS * T), **f32)
    part_l = torch.empty((n, tiles, HEADS * T), **f32)
    part_acc = torch.empty((n, tiles, HEADS * T, INTERNAL // HEADS), **f32)
    q_img = torch.empty((n, N, INTERNAL), device=dev, dtype=dt) if emit_q else None
    out = torch.empty((n, T, INTERNAL), device=dev, dtype=dt)
    is_f32 = int(dt == torch.float32)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(lib.cor_t2i_image_pass(
            keys.data_ptr(), 0, 0, 0, n, n, T, N, w.data_ptr(), b.data_ptr(),
            kpe.data_ptr(), qpe.data_ptr() if emit_q else 0, qt.data_ptr(),
            q_img.data_ptr() if emit_q else 0,
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), is_f32, stream),
            "t2i image pass")
        check(lib.cor_t2i_combine(
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), tiles, n, T,
            out.data_ptr(), is_f32, stream), "t2i combine")
    return q_img, out


def t2i_flash_kv(keys, wk, bk, wv, bv, kpe, q_tok, num_heads: int) -> torch.Tensor:
    """keys [n, N, C], q_tok [n, T, I] -> [n, T, I]."""
    if keys.device.type == "cpu":
        refuse_grad("t2i_flash_kv", keys, wk, bk, wv, bv, kpe, q_tok)
        return t2i_flash_kv_plain(keys, wk, bk, wv, bv, kpe, q_tok, num_heads)
    if keys.device.type != "cuda":
        raise ValueError(f"t2i_flash_kv: no kernel for device {keys.device}")
    dt = _check(keys, wk, wv, kpe, q_tok, num_heads)
    refuse_grad("t2i_flash_kv", keys, wk, bk, wv, bv, kpe, q_tok)
    w, b = _pack(wk, bk, wv, bv, keys.device, dt)
    out = _flash(keys, w, b, kpe, None, q_tok, dt, emit_q=False)[1]
    count_launch(t2i_flash_kv, dt, LAUNCHES)
    return out


def proj_q_t2i_flash(keys, wk, bk, wv, bv, wq, bq, kpe, qpe, q_tok, num_heads: int):
    """keys [n, N, C], q_tok [n, T, I] -> (q_img [n, N, I], attention [n, T,
    I]), ``cor_tpu``'s signature (the weights in the port's [I, C] layout)."""
    if keys.device.type == "cpu":
        refuse_grad("proj_q_t2i_flash", keys, wk, bk, wv, bv, wq, bq, kpe, qpe, q_tok)
        return proj_q_t2i_flash_plain(keys, wk, bk, wv, bv, wq, bq, kpe, qpe, q_tok, num_heads)
    if keys.device.type != "cuda":
        raise ValueError(f"proj_q_t2i_flash: no kernel for device {keys.device}")
    dt = _check(keys, wk, wv, kpe, q_tok, num_heads, wq, qpe)
    refuse_grad("proj_q_t2i_flash", keys, wk, bk, wv, bv, wq, bq, kpe, qpe, q_tok)
    w, b = _pack(wk, bk, wv, bv, keys.device, dt, wq, bq)
    q_img, out = _flash(keys, w, b, kpe, qpe, q_tok, dt, emit_q=True)
    count_launch(proj_q_t2i_flash, dt, LAUNCHES)
    return q_img, out


def _check(keys, wk, wv, kpe, q_tok, num_heads: int, wq=None, qpe=None) -> torch.dtype:
    """The compute dtype (bf16 or fp32) of keys, the PE projections and
    q_tok, or raise on what the kernels do not take; with ``wq`` and
    ``qpe``, K8a's."""
    what = "t2i_flash_kv" if wq is None else "proj_q_t2i_flash"
    ws = (wk, wv) if wq is None else (wk, wv, wq)
    pes = (kpe,) if qpe is None else (kpe, qpe)
    n, N, C = keys.shape
    T = q_tok.shape[1]
    if (C, num_heads, q_tok.shape[2], {tuple(w.shape) for w in ws}) != (
            C_DIM, HEADS, INTERNAL, {(INTERNAL, C_DIM)}):
        raise ValueError(
            f"{what} kernel takes C {C_DIM}, {HEADS} heads, q_tok [n, T, {INTERNAL}]; got keys "
            f"{tuple(keys.shape)}, {num_heads} heads, q_tok {tuple(q_tok.shape)}")
    if not MIN_TOKENS <= T <= MAX_TOKENS:
        raise ValueError(f"{what} kernel takes {MIN_TOKENS} to {MAX_TOKENS} tokens, got {T}")
    if N == 0 or N % ROW_TILE or q_tok.shape[0] != n or any(
            pe.shape != (N, INTERNAL) for pe in pes):
        raise ValueError(f"{what} kernel: N {N} must be a multiple of {ROW_TILE}, the PE "
                         f"projections [N, {INTERNAL}], q_tok [{n}, ...]")
    dt = operand_dtype(what, keys, *pes, q_tok)
    if not keys.is_contiguous() or not all(pe.is_contiguous() for pe in pes) or n > 65535:
        raise ValueError(f"{what} kernel takes contiguous keys and PE projections, n <= 65535")
    return dt


def _pack(wk, bk, wv, bv, device, dtype, wq=None, bq=None):
    """The packed [k | v (| q: K8a's)] weight in the compute dtype and its
    fp32 bias, kept on ``wk`` (``cached_pack``: keyed by device and dtype)."""
    ws, bs = (wk, wv) if wq is None else (wk, wv, wq), (bk, bv) if bq is None else (bk, bv, bq)
    return cached_pack(wk, f"_t2i_pack{len(ws)}", ws + bs, device, dtype, lambda: (
        torch.cat([w.detach() for w in ws]).to(device, dtype).contiguous(),
        torch.cat([b.detach() for b in bs]).to(device, torch.float32).contiguous()))


LAUNCHES = 2  # kernel launches per call on the card
t2i_flash_kv.launches = t2i_flash_kv.launches_fp32 = 0
proj_q_t2i_flash.launches = proj_q_t2i_flash.launches_fp32 = 0
