"""One two-way transformer layer of the SAM mask decoder: the CUDA kernels
of K1 (``csrc/twl_tokens_in.cu``, ``twl_t2i.cu``, ``twl_tokens_mid.cu``,
``twl_i2t.cu``) and K1-dma (``csrc/two_way_layer_dma.cu``) and their plain
PyTorch version.

Replaces ``cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused`` (its
``pallas_call``s at lines 978, 998 and 1012): one TwoWayAttentionBlock
(reference transformer.py:151-182) over [n, T, C] tokens and [n, N, C] image
rows, each candidate attending only to its own rows:

1. token self-attention (no PE and no residual on the first layer,
   ``skip_pe``), LN1;
2. token -> image attention, the image-side k/v projections (+ the k-side PE)
   computed from the rows inside, and the i2t query ``q_img`` of every row
   emitted beside it; out-projection, residual, LN2;
3. token ReLU MLP, residual, LN3;
4. image -> token attention (softmax over the T tokens of each head),
   out-projection, residual with the rows, LN4 -> the new rows.

With ``idx`` the rows are a candidate store [S, N, C] and candidate b reads
store row ``clip(idx[b], 0, S - 1)``; with ``scale`` the store is int8 and a
row dequantises as ``(int8 -> fp32) * scale[row]``, rounded to the compute
dtype, in stage 2 and again for the residual of stage 4.

Numerics, as in the TPU kernel: the token state stays fp32 inside the layer;
every operand of a product is rounded to the compute dtype first (the image
projections k_t, v_t, q_img; the attention queries after their scale, which
follows the bias; the unnormalised t2i exponentials; the i2t
probabilities); every sum and every statistic is fp32. The i2t softmax
shifts by the exact per-head max (the TPU kernel shifts by the per-head
mean, the same function).

On the card the layer is four launches (``two_way_layer.launches`` adds 4
per call): a token kernel (``csrc/twl_tokens_in.cu``: stage 1 and the t2i
query), K1's image pass ``csrc/twl_t2i.cu`` (stage 2's projections and
per-tile flash partials), a token kernel (``csrc/twl_tokens_mid.cu``: the
partials' combine, the rest of stage 2, stage 3, the i2t keys and values),
and K1's image pass ``csrc/twl_i2t.cu`` (stage 4). All four are K1's own,
redesigned for Hopper (the token stages over a cluster of 4 CTAs a
candidate while they all fit on the card at once, else one CTA a candidate,
the image passes persistent on wgmma, the weights streamed through
shared-memory rings by TMA bulk copies in bf16), and compute what the
first designs' bodies (``csrc/t2i_flash.cuh``, ``i2t_attention.cuh``)
compute, bit for bit (K2 runs the t2i pass without its q chunk, K8a with
K2's tokens and combine, K8b the i2t pass above 8 tokens, K1-dma both passes
with the rows moved by bulk copies and stores); their
bf16 weights go in the pack a second time, laid out as the rings' blocks
(``t2i_flash.ring_blocks``). ``layer_launches`` returns the four launches unrun, for
timing them one by one. See the sources for what bounds each. The kernels
take the SAM geometry only: C = 256, 8 heads, internal width 128, 5 to 8
tokens (the tokens at which ``cor_tpu`` runs its
layer kernel: the mask decoder's 5 output tokens and up to 3 prompt tokens;
the TPU kernel pads them to 8, the token kernels here are compiled for each
count), MLP 2048, N a multiple of 64, in the compute
dtype bf16 or fp32 (tokens, rows, PE projections of one dtype; the rows may
be an int8 store, dequantised to it). In fp32 the image passes' products run
in 3xTF32 on the tensor cores, the token kernels in fp32 FMAs, and nothing
is rounded. Any other CUDA input raises; a CPU tensor takes the plain
version. Launches are counted by dtype (``two_way_layer.launches``: bf16,
``launches_fp32``). ``cor_tpu``'s
kernel has no backward, and neither has this one: with autograd recording
(an input or a weight that requires grad, grad mode on) it raises. Training
runs the decoder's ``fused=False`` path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from cor_tpu_torch.ops.common import layer_norm
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, count_launch, library, operand_dtype
from cor_tpu_torch.ops.kernels.i2t_attention import (
    I2T_BLOCK,
    _heads,
    i2t_attention_fused_plain,
    i2t_smem,
)
from cor_tpu_torch.ops.kernels.t2i_flash import (
    C_DIM,
    HEADS,
    INTERNAL,
    PROJ_Q_CHUNK_ORDER,
    ROW_TILE,
    SMEM_LIMIT,
    cached_pack,
    proj_q_t2i_flash_plain,
    ring_blocks,
)

MLP_DIM = 2048
LAYER_TOKENS = (5, 6, 7, 8)  # the token counts the token kernels are compiled for


def _lin(x: torch.Tensor, d) -> torch.Tensor:
    """fp32 x @ w.T + b of a ``Dense`` holder, with fp32 accumulation."""
    return x @ d.w.float().T + d.b.float()


def gather_rows(keys, idx, scale, dt) -> torch.Tensor:
    """The rows a layer reads: ``keys`` itself, or store rows
    ``keys[clip(idx)]``, dequantised by ``scale`` when the store is int8."""
    if idx is None:
        return keys.to(dt)
    rows_idx = idx.long().clamp(0, keys.shape[0] - 1)
    rows = keys[rows_idx]
    if scale is None:
        return rows.to(dt)
    return (rows.float() * scale.float()[rows_idx][:, None, None]).to(dt)


def _merge(x: torch.Tensor) -> torch.Tensor:
    n, h, t, d = x.shape
    return x.transpose(1, 2).reshape(n, t, h * d)


def two_way_layer_plain(
    lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe: bool, eps: float = 1e-5,
    idx=None, scale=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: (tokens', rows') in the tokens' dtype.

    ``lp`` is a ``TwoWayBlock``; ``kpe`` and ``qpe_img`` [N, I] are the
    bias-free projections of the image PE by t2i.k_proj and i2t.q_proj."""
    dt = tokens.dtype
    rows = gather_rows(keys, idx, scale, dt)
    x, z = layer_math(lp, tokens.float(), qpe_tok.float(), rows, kpe, qpe_img, skip_pe, eps, dt)
    return x.to(dt), z


def layer_math(lp, x, qpe, rows, kpe, qpe_img, skip_pe: bool, eps: float,
               dt: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer on the fp32 token state ``x`` and ``rows`` of the compute
    dtype ``dt``, each product operand rounded to ``dt``: (the fp32 state
    after LN3, unrounded; the new rows in ``dt``)."""
    r = lambda v: v.to(dt).float()  # noqa: E731 -- round to the compute dtype
    sa, t2i, i2t = lp.self_attn, lp.cross_attn_t2i, lp.cross_attn_i2t
    H = sa.num_heads
    C = x.shape[-1]

    # 1) token self-attention
    qin = r(x if skip_pe else x + qpe)
    q = r(_lin(qin, sa.q_proj) / math.sqrt(C // H))
    k = r(_lin(qin, sa.k_proj))
    v = r(_lin(r(x), sa.v_proj))
    p = torch.softmax(_heads(q, H) @ _heads(k, H).transpose(-1, -2), dim=-1)
    s = _lin(r(_merge(r(p) @ _heads(v, H))), sa.out_proj)
    x = s if skip_pe else x + s
    x = layer_norm(x, lp.norm1.scale, lp.norm1.bias, eps)

    # 2) token -> image attention (K8a's function); q_img for stage 4
    q_img, av = proj_q_t2i_flash_plain(
        rows, t2i.k_proj.w, t2i.k_proj.b, t2i.v_proj.w, t2i.v_proj.b, i2t.q_proj.w,
        i2t.q_proj.b, kpe, qpe_img, _lin(r(x + qpe), t2i.q_proj), H)
    x = x + _lin(av.float(), t2i.out_proj)
    x = layer_norm(x, lp.norm2.scale, lp.norm2.bias, eps)

    # 3) token MLP (ReLU)
    h = torch.relu(_lin(r(x), lp.mlp.lin1))
    x = x + _lin(r(h), lp.mlp.lin2)
    x = layer_norm(x, lp.norm3.scale, lp.norm3.bias, eps)

    # 4) image -> token attention over the T tokens of each head (K8b's
    # function)
    k_i = r(_lin(r(x + qpe), i2t.k_proj))
    v_i = r(_lin(r(x), i2t.v_proj))
    z = i2t_attention_fused_plain(q_img, rows, k_i, v_i, i2t.out_proj.w, i2t.out_proj.b,
                                  lp.norm4.scale, lp.norm4.bias, H, eps)
    return x, z


def _pack(lp, device, dtype) -> dict:
    """The layer's weights in the kernels' layouts, matrices [out, in] in
    the compute dtype and fp32 vectors (``cached_pack`` on the layer). Order
    and offsets are those of ``csrc/two_way_layer.cu``."""
    return cached_pack(lp, "_kernel_pack", list(lp.parameters()), device, dtype,
                       lambda: _make_pack(lp, device, dtype))


T2I_CHUNK_ORDER = PROJ_Q_CHUNK_ORDER  # q, k, v: the t2i pass's chunks (csrc/twl_t2i.cu)


def _make_pack(lp, device, dtype) -> dict:
    sa, t2i, i2t, mlp = lp.self_attn, lp.cross_attn_t2i, lp.cross_attn_i2t, lp.mlp
    mat = lambda *ts: torch.cat([t.detach().reshape(-1).to(device, dtype) for t in ts])  # noqa: E731
    f32 = lambda *ts: torch.cat([t.detach().reshape(-1).to(device, torch.float32) for t in ts])  # noqa: E731
    w_img = mat(t2i.k_proj.w, t2i.v_proj.w, i2t.q_proj.w).reshape(3 * INTERNAL, C_DIM)
    wo_i = mat(i2t.out_proj.w).reshape(C_DIM, INTERNAL)
    bf16 = dtype == torch.bfloat16
    return {
        "wtok": mat(sa.q_proj.w, sa.k_proj.w, sa.v_proj.w, sa.out_proj.w, t2i.q_proj.w,
                   t2i.out_proj.w, mlp.lin1.w, mlp.lin2.w, i2t.k_proj.w, i2t.v_proj.w),
        "btok": f32(sa.q_proj.b, sa.k_proj.b, sa.v_proj.b, sa.out_proj.b,
                    lp.norm1.scale, lp.norm1.bias, t2i.q_proj.b, t2i.out_proj.b,
                    lp.norm2.scale, lp.norm2.bias, mlp.lin1.b, mlp.lin2.b,
                    lp.norm3.scale, lp.norm3.bias, i2t.k_proj.b, i2t.v_proj.b),
        "w_img": w_img,
        "b_img": f32(t2i.k_proj.b, t2i.v_proj.b, i2t.q_proj.b),
        "wo_i": wo_i,
        "bo_ln4": f32(i2t.out_proj.b, lp.norm4.scale, lp.norm4.bias),
        # bf16: the image passes' weights as their rings' blocks (fp32 splits
        # the weights as it streams them)
        "w_img_blocks": ring_blocks(w_img, 64, T2I_CHUNK_ORDER) if bf16 else None,
        "wo_i_blocks": ring_blocks(wo_i, I2T_BLOCK) if bf16 else None,
    }


def _check_geometry(lp, tokens, qpe_tok, keys, kpe, qpe_img, idx, scale) -> torch.dtype:
    """The compute dtype (bf16 or fp32), or raise on what the kernels do
    not take."""
    sa, t2i = lp.self_attn, lp.cross_attn_t2i
    n, T, C = tokens.shape
    N = keys.shape[1]
    if (C, sa.num_heads, t2i.q_proj.w.shape[0], lp.mlp.lin1.w.shape[0]) != (
            C_DIM, HEADS, INTERNAL, MLP_DIM) or T not in LAYER_TOKENS:
        raise ValueError(
            f"two_way_layer kernel takes the SAM geometry (C {C_DIM}, {LAYER_TOKENS[0]} to "
            f"{LAYER_TOKENS[-1]} tokens, {HEADS} heads, internal {INTERNAL}, MLP {MLP_DIM}); got "
            f"C {C}, {T} tokens, {sa.num_heads} heads, internal {t2i.q_proj.w.shape[0]}, MLP "
            f"{lp.mlp.lin1.w.shape[0]}")
    dt = operand_dtype("two_way_layer", tokens, qpe_tok, kpe, qpe_img,
                       None if scale is not None else keys)
    if keys.dim() != 3 or keys.shape[2] != C or N % ROW_TILE or N == 0:
        raise ValueError(f"two_way_layer kernel takes rows [*, N, {C}] with N % {ROW_TILE} == 0, "
                         f"got {tuple(keys.shape)}")
    if scale is not None:
        if keys.dtype != torch.int8 or idx is None or scale.dtype != torch.float32:
            raise TypeError("an int8 store takes idx and fp32 scales")
        if scale.shape != (keys.shape[0],):
            raise ValueError(f"scales {tuple(scale.shape)} for a store of {keys.shape[0]} rows")
    if idx is None and keys.shape[0] != n:
        raise ValueError(f"{keys.shape[0]} row blocks for {n} candidates")
    if idx is not None and (idx.dtype != torch.int32 or idx.shape != (n,)):
        raise ValueError(f"idx must be int32 [{n}], got {idx.dtype} {tuple(idx.shape)}")
    if kpe.shape != (N, INTERNAL) or qpe_img.shape != (N, INTERNAL):
        raise ValueError("kpe and qpe_img must be [N, 128]")
    for name, t in (("tokens", tokens), ("qpe_tok", qpe_tok), ("keys", keys), ("kpe", kpe),
                    ("qpe_img", qpe_img), ("idx", idx), ("scale", scale)):
        if t is not None and (t.device != tokens.device or not t.is_contiguous()):
            raise ValueError(f"two_way_layer kernel: {name} must be contiguous on {tokens.device}")
    if n > 65535:
        raise ValueError(f"two_way_layer kernel: {n} candidates in one call (at most 65535)")
    return dt


def two_way_layer(
    lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe: bool, eps: float = 1e-5,
    idx: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [n, T, C], qpe_tok [n, T, C], keys [n, N, C] (or a store
    [S, N, C] with ``idx`` int32 [n], int8 with ``scale`` fp32 [S]),
    kpe / qpe_img [N, I] -> (tokens' [n, T, C], rows' [n, N, C])."""
    return _layer(two_way_layer, lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, eps, idx,
                  scale)


def two_way_layer_dma(
    lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe: bool, eps: float = 1e-5,
    idx: Optional[torch.Tensor] = None, scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-dma: ``two_way_layer``'s function and arguments, on K1's token
    stages and K1's Hopper image passes with the rows moved by the kernels'
    own asynchronous copies: the t2i pass's row tiles by the TMA, the i2t
    pass's tiles by bulk copies and its new rows by bulk stores
    (``csrc/two_way_layer_dma.cu``; replaces ``cor_tpu/ops/pallas/
    two_way_layer.py:two_way_layer_dma``, its ``pallas_call`` at line 610).
    On the card its outputs are K1's bit for bit; on the CPU it is K1's plain
    version, ``two_way_layer_plain``. Four launches a call, counted on
    ``two_way_layer_dma``."""
    return _layer(two_way_layer_dma, lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, eps, idx,
                  scale)


def _layer(fn, lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, eps, idx, scale):
    """K1 (``fn`` two_way_layer) or K1-dma (two_way_layer_dma): K1's token
    stages around K1's or K1-dma's image passes."""
    name = fn.__name__
    if tokens.device.type == "cpu":
        refuse_grad(name, tokens, qpe_tok, keys, kpe, qpe_img, *lp.parameters())
        return two_way_layer_plain(lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, eps,
                                   idx, scale)
    if tokens.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tokens.device}")
    launches, outs, dt = layer_launches(fn, lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe,
                                        eps, idx, scale)
    with torch.cuda.device(tokens.device):
        for _, launch in launches:
            launch()
    count_launch(fn, dt, LAUNCHES)
    return outs


def layer_launches(fn, lp, tokens, qpe_tok, keys, kpe, qpe_img, skip_pe, eps=1e-5, idx=None,
                   scale=None):
    """The card's launches of one layer of ``fn`` (two_way_layer or
    two_way_layer_dma), checked, packed and allocated but not run: ([(name,
    launch), ...] in order, (tokens', rows'), the compute dtype). Each
    ``launch()`` runs one kernel on the current stream and raises if it was
    refused; ``tools/kernel_bits.py`` times them one by one. Counts nothing."""
    name = fn.__name__
    dt = _check_geometry(lp, tokens, qpe_tok, keys, kpe, qpe_img, idx, scale)
    refuse_grad(name, tokens, qpe_tok, keys, kpe, qpe_img, *lp.parameters())
    n, T = tokens.shape[0], tokens.shape[1]
    S, N = keys.shape[0], keys.shape[1]
    dev = tokens.device
    pk = _pack(lp, dev, dt)
    tiles = N // ROW_TILE
    f32 = dict(device=dev, dtype=torch.float32)
    cd = dict(device=dev, dtype=dt)  # the compute dtype
    x_mid = torch.empty((n, T, C_DIM), **f32)
    qt = torch.empty((n, T, INTERNAL), **cd)
    q_img = torch.empty((n, N, INTERNAL), **cd)
    part_m = torch.empty((n, tiles, HEADS * T), **f32)
    part_l = torch.empty((n, tiles, HEADS * T), **f32)
    part_acc = torch.empty((n, tiles, HEADS * T, INTERNAL // HEADS), **f32)
    tokens_out = torch.empty((n, T, C_DIM), **cd)
    k_i = torch.empty((n, T, INTERNAL), **cd)
    v_i = torch.empty((n, T, INTERNAL), **cd)
    keys_out = torch.empty((n, N, C_DIM), **cd)
    idx_p = 0 if idx is None else idx.data_ptr()
    scale_p = 0 if scale is None else scale.data_ptr()
    int8 = int(scale is not None)
    is_f32 = int(dt == torch.float32)
    lib = library()
    dma = fn is two_way_layer_dma
    image_t2i = lib.cor_twl_dma_image_t2i if dma else lib.cor_twl_t2i
    image_i2t = lib.cor_twl_dma_image_i2t if dma else lib.cor_twl_i2t

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def tokens_in():
        check(lib.cor_twl_tokens_in_cluster(
            tokens.data_ptr(), qpe_tok.data_ptr(), pk["wtok"].data_ptr(), pk["btok"].data_ptr(),
            int(skip_pe), SELF_SCALE, CROSS_SCALE, eps, n, T,
            x_mid.data_ptr(), qt.data_ptr(), is_f32, stream()), f"{name} tokens_in")

    # bf16: the weights laid out as the image passes' ring blocks (fp32: none)
    w_blocks, wo_blocks = (0 if pk[k] is None else pk[k].data_ptr()
                           for k in ("w_img_blocks", "wo_i_blocks"))

    def t2i():
        check(image_t2i(
            keys.data_ptr(), int8, idx_p, scale_p, S, n, T, N,
            pk["w_img"].data_ptr(), w_blocks, pk["b_img"].data_ptr(), kpe.data_ptr(),
            qpe_img.data_ptr(), qt.data_ptr(), q_img.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), is_f32, stream()),
            f"{name} image t2i")

    def tokens_mid():
        check(lib.cor_twl_tokens_mid_cluster(
            x_mid.data_ptr(), qpe_tok.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), tiles, pk["wtok"].data_ptr(), pk["btok"].data_ptr(), eps, n, T,
            tokens_out.data_ptr(), k_i.data_ptr(), v_i.data_ptr(), is_f32, stream()),
            f"{name} tokens_mid")

    def i2t():
        check(image_i2t(
            keys.data_ptr(), int8, idx_p, scale_p, S, n, T, N, q_img.data_ptr(),
            k_i.data_ptr(), v_i.data_ptr(), pk["wo_i"].data_ptr(), wo_blocks,
            pk["bo_ln4"].data_ptr(), eps, CROSS_SCALE, keys_out.data_ptr(), is_f32, stream()),
            f"{name} image i2t")

    launches = [("tokens_in", tokens_in), ("image_t2i", t2i), ("tokens_mid", tokens_mid),
                ("image_i2t", i2t)]
    return launches, (tokens_out, keys_out), dt


# K1's image passes redesigned for Hopper (csrc/twl_t2i.cu, twl_i2t.cu): a
# persistent grid of one CTA an SM, each walking work items of consecutive
# 64-row tiles of a candidate, one tile per consumer warpgroup
_T2I_TILES = {torch.bfloat16: 2, torch.float32: 1}  # tiles an item (consumer warpgroups)
_I2T_TILES = 2


def image_pass_smem(dtype: torch.dtype, T: int) -> dict:
    """The dynamic shared memory of K1's two image passes at T tokens, as
    the sources lay it out (``T2iSmem`` and ``I2tSmem``): {"t2i": bytes,
    "i2t": bytes}."""
    bf16 = dtype == torch.bfloat16
    el = 2 if bf16 else 4
    ld_i = INTERNAL + (8 if bf16 else 4)  # k and v rows: Elem<T>::kLdI
    groups = _T2I_TILES[dtype]
    stages, stage = (3, INTERNAL * 64 * 2) if bf16 else (4, INTERNAL * 16 * 8)
    rows = ROW_TILE * C_DIM * 2 if bf16 else ROW_TILE * (C_DIM + 4) * 4
    group = rows + 2 * ROW_TILE * ld_i * el + HEADS * T * (ROW_TILE + 4) * 4 + T * INTERNAL * 4
    t2i = stages * stage + groups * group + 3 * INTERNAL * 4 + (2 * stages + 2 * groups) * 8
    return {"t2i": t2i, "i2t": i2t_smem(dtype, T)}


def dma_pass_smem(dtype: torch.dtype, T: int) -> dict:
    """The dynamic shared memory of K1-dma's two image passes at T tokens
    (``csrc/two_way_layer_dma.cu``: ``T2iSmem<T, true, false, true>`` and
    ``I2tSmem<T, false, true>``), the same from rows, a store and an int8
    store (an int8 store's raw tiles lie inside the row tiles): {"t2i":
    bytes, "i2t": bytes}. The t2i pass is K1's with an mbarrier per consumer
    warpgroup for the raw tiles; the i2t pass is K1's in bf16, and in fp32
    writes the attention output over the q_img tile and stages the new rows
    in one [64][260] tile that both warpgroups take in turn."""
    t2i = image_pass_smem(dtype, T)["t2i"] + 8 * _T2I_TILES[dtype]
    if dtype == torch.bfloat16:
        return {"t2i": t2i, "i2t": i2t_smem(dtype, T)}
    av = ROW_TILE * (INTERNAL + 4) * 4  # the attention output's own tile in K1's fp32 pass
    rows = ROW_TILE * (C_DIM + 4) * 4
    return {"t2i": t2i, "i2t": i2t_smem(dtype, T) - 2 * av + rows}


def image_pass_grid(dtype: torch.dtype, n: int, N: int, sms: int) -> dict:
    """The launch geometry of K1's image passes for n candidates of N rows on
    a card of ``sms`` SMs: {pass: (work items, CTAs, threads a CTA)}; every
    CTA walks items blockIdx.x, + CTAs, ..."""
    tiles = N // ROW_TILE
    out = {}
    for name, per, threads in (("t2i", _T2I_TILES[dtype], _T2I_TILES[dtype] * 128 + 128),
                               ("i2t", _I2T_TILES, _I2T_TILES * 128 + 128)):
        items = n * -(-tiles // per)
        out[name] = (items, min(items, sms), threads)
    return out


LAUNCHES = 4  # kernel launches per call on the card, for K1 and K1-dma
SELF_SCALE = 1.0 / math.sqrt(C_DIM // HEADS)
CROSS_SCALE = 1.0 / math.sqrt(INTERNAL // HEADS)
two_way_layer.launches = two_way_layer.launches_fp32 = 0
two_way_layer_dma.launches = two_way_layer_dma.launches_fp32 = 0
