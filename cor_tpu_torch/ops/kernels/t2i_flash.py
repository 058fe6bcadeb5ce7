"""The token -> image attention of the SAM two-way transformer: the CUDA
kernels of ``csrc/t2i_final.cu`` (K2) and ``csrc/t2i_proj_q.cu`` (K8a), and
their plain PyTorch versions.

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

On the card K2 is one launch (``FINAL_LAUNCHES``): K1's image pass
redesigned for Hopper (``csrc/twl_t2i.cuh``) without its q chunk,
persistent CTAs on ``wgmma`` that take the tokens 8 at a time, each tile's
flash partials (max, sum and the unnormalised [heads x T, d] product)
combined by the CTA that finishes a candidate's last tile (per-candidate
tickets, ``_tickets``, which each launch leaves at zero). K8a is one launch
too (``LAUNCHES``): the same pass with K1's q chunk (q_img written out) and
K2's tokens and folded combine, its weight in K1's ring blocks (chunks q,
k, v), sharing K2's tickets. The
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


def _partials(n, N, T, dev):
    """The flash partials of n candidates' N // 64 row tiles at T tokens:
    (max, sum) fp32 [n, tiles, 8 T] and acc [n, tiles, 8 T, 16]."""
    tiles = N // ROW_TILE
    f32 = dict(device=dev, dtype=torch.float32)
    return (torch.empty((n, tiles, HEADS * T), **f32), torch.empty((n, tiles, HEADS * T), **f32),
            torch.empty((n, tiles, HEADS * T, INTERNAL // HEADS), **f32))


def _scaled_queries(q_tok, dt):
    return (q_tok.float() / math.sqrt(INTERNAL // HEADS)).to(dt).contiguous()


_TICKETS = {}  # device index -> the per-candidate tickets of K2 and K8a


def _tickets(dev) -> torch.Tensor:
    """The per-candidate tickets of K2 and K8a on ``dev``: int32 [65535],
    zeroed once; every launch of either leaves them at zero, so a CUDA graph
    can replay a call. Made at the first call on a device, which therefore
    must not be under a CUDA graph's capture. Two launches in flight at once
    on one device (two streams) would share them: the port launches on one
    stream."""
    if dev.index not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("t2i_flash_kv / proj_q_t2i_flash: call one of them once on this "
                               "device before capturing it in a CUDA graph (their tickets are "
                               "made at the first call)")
        _TICKETS[dev.index] = torch.zeros(65535, dtype=torch.int32, device=dev)
    return _TICKETS[dev.index]


def _final(keys, w, b, w_blocks, kpe, q_tok, dt):
    """K2: the final attention [n, T, I], one launch."""
    n, N, _ = keys.shape
    T = q_tok.shape[1]
    dev = keys.device
    qt = _scaled_queries(q_tok, dt)
    parts = _partials(n, N, T, dev)
    out = torch.empty((n, T, INTERNAL), device=dev, dtype=dt)
    lib = library()
    with torch.cuda.device(dev):
        check(lib.cor_t2i_final(
            keys.data_ptr(), n, T, N, w.data_ptr(), 0 if w_blocks is None else w_blocks.data_ptr(),
            b.data_ptr(), kpe.data_ptr(), qt.data_ptr(), *(p.data_ptr() for p in parts),
            _tickets(dev).data_ptr(), out.data_ptr(), int(dt == torch.float32),
            torch.cuda.current_stream(dev).cuda_stream), "t2i final attention")
    return out


def _proj_q(keys, w, b, w_blocks, kpe, qpe, q_tok, dt):
    """K8a: (q_img [n, N, I], the attention [n, T, I]), one launch."""
    n, N, _ = keys.shape
    T = q_tok.shape[1]
    dev = keys.device
    qt = _scaled_queries(q_tok, dt)
    parts = _partials(n, N, T, dev)
    q_img = torch.empty((n, N, INTERNAL), device=dev, dtype=dt)
    out = torch.empty((n, T, INTERNAL), device=dev, dtype=dt)
    lib = library()
    with torch.cuda.device(dev):
        check(lib.cor_t2i_proj_q(
            keys.data_ptr(), n, T, N, w.data_ptr(), 0 if w_blocks is None else w_blocks.data_ptr(),
            b.data_ptr(), kpe.data_ptr(), qpe.data_ptr(), qt.data_ptr(), q_img.data_ptr(),
            *(p.data_ptr() for p in parts), _tickets(dev).data_ptr(), out.data_ptr(),
            int(dt == torch.float32), torch.cuda.current_stream(dev).cuda_stream),
            "proj_q_t2i_flash")
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
    w_blocks = _final_blocks(wk, bk, wv, bv, w) if dt == torch.bfloat16 else None
    out = _final(keys, w, b, w_blocks, kpe, q_tok, dt)
    count_launch(t2i_flash_kv, dt, FINAL_LAUNCHES)
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
    w_blocks = _proj_q_blocks(wk, bk, wv, bv, wq, bq, w) if dt == torch.bfloat16 else None
    q_img, out = _proj_q(keys, w, b, w_blocks, kpe, qpe, q_tok, dt)
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


def ring_blocks(w: torch.Tensor, kb: int, order=None) -> torch.Tensor:
    """A weight [out, in] (bf16) laid out as the ring blocks of the image
    passes redesigned for Hopper (csrc/twl_t2i.cuh, twl_i2t.cu), each a
    contiguous TMA bulk copy: for each group of 128 outputs (in ``order``, or
    all outputs as one group), its blocks of ``kb`` inputs, each
    [outputs][kb] in wgmma's core-matrix layout (element (o, k) at ((o / 8) *
    kb / 8 + k / 8) * 64 + (o % 8) * 8 + k % 8)."""
    out, inp = w.shape
    groups = [w] if order is None else [w[c * INTERNAL:(c + 1) * INTERNAL] for c in order]
    blocks = []
    for g in groups:
        o = g.shape[0]
        for k0 in range(0, inp, kb):
            blk = g[:, k0:k0 + kb].reshape(o // 8, 8, kb // 8, 8).permute(0, 2, 1, 3)
            blocks.append(blk.reshape(-1))
    return torch.cat(blocks).contiguous()


FINAL_CHUNK_ORDER = (0, 1)  # k, v: the order of K2's chunks (csrc/twl_t2i.cuh)
PROJ_Q_CHUNK_ORDER = (2, 0, 1)  # q, k, v: the order of K1's and K8a's chunks


def _pack(wk, bk, wv, bv, device, dtype, wq=None, bq=None):
    """The packed [k | v (| q: K8a's)] weight in the compute dtype and its
    fp32 bias, kept on ``wk`` (``cached_pack``: keyed by device and dtype)."""
    ws, bs = (wk, wv) if wq is None else (wk, wv, wq), (bk, bv) if bq is None else (bk, bv, bq)
    return cached_pack(wk, f"_t2i_pack{len(ws)}", ws + bs, device, dtype, lambda: (
        torch.cat([w.detach() for w in ws]).to(device, dtype).contiguous(),
        torch.cat([b.detach() for b in bs]).to(device, torch.float32).contiguous()))


def _final_blocks(wk, bk, wv, bv, w):
    """K2's bf16 [k | v] weight ``w`` (``_pack``'s) laid out as its ring's
    blocks (fp32 splits the weight as it streams it), kept on ``wk`` beside
    the pack."""
    return cached_pack(wk, "_t2i_blocks", (wk, bk, wv, bv), w.device, w.dtype,
                       lambda: ring_blocks(w, 64, FINAL_CHUNK_ORDER))


def _proj_q_blocks(wk, bk, wv, bv, wq, bq, w):
    """K8a's bf16 [k | v | q] weight ``w`` (``_pack``'s) laid out as its
    ring's blocks, K1's layout (chunks q, k, v), kept on ``wk`` beside the
    pack."""
    return cached_pack(wk, "_t2i_blocks3", (wk, bk, wv, bv, wq, bq), w.device, w.dtype,
                       lambda: ring_blocks(w, 64, PROJ_Q_CHUNK_ORDER))


SMEM_LIMIT = 232_448  # the dynamic shared memory a block may take on the H100


def final_smem(dtype: torch.dtype, T: int) -> int:
    """K2's dynamic shared memory at T tokens, as csrc/twl_t2i.cuh lays it out
    (``T2iSmem<T, false, true>``: the weight ring; per consumer warpgroup its row
    tile, k, v, the logits and queries of at most 8 tokens; the bias, the
    mbarriers and a ticket slot per warpgroup)."""
    bf16 = dtype == torch.bfloat16
    el, held, groups = (2 if bf16 else 4), min(T, 8), (2 if bf16 else 1)  # tiles an item
    ld_i = INTERNAL + (8 if bf16 else 4)  # k and v rows: Elem<T>::kLdI
    stages, stage = (3, INTERNAL * 64 * 2) if bf16 else (4, INTERNAL * 16 * 8)
    rows = ROW_TILE * C_DIM * 2 if bf16 else ROW_TILE * (C_DIM + 4) * 4
    group = (rows + 2 * ROW_TILE * ld_i * el + HEADS * held * (ROW_TILE + 4) * 4
             + held * INTERNAL * 4)
    return (stages * stage + groups * group + 2 * INTERNAL * 4 + (2 * stages + 2 * groups) * 8
            + 4 * groups)


def proj_q_smem(dtype: torch.dtype, T: int) -> int:
    """K8a's dynamic shared memory at T tokens (``T2iSmem<T, true, true>``):
    K2's layout with the q chunk's bias (K1's layout with K2's ticket
    slots)."""
    return final_smem(dtype, T) + INTERNAL * 4


FINAL_LAUNCHES = 1  # K2's kernel launches per call on the card: the combine folded in
LAUNCHES = 1  # K8a's: q_img and the attention, the combine folded in

t2i_flash_kv.launches = t2i_flash_kv.launches_fp32 = 0
proj_q_t2i_flash.launches = proj_q_t2i_flash.launches_fp32 = 0
