"""The whole depth-2 two-way transformer of the SAM mask decoder as one
kernel: K1-stack and K1-grid (``csrc/two_way_stack.cuh``), and their plain
PyTorch version.

Replaces ``cor_tpu/ops/pallas/two_way_layer.py``'s

- ``two_way_stack_fused`` (its ``pallas_call``s at lines 1236 and 1250):
  both TwoWayAttentionBlocks, the final token -> image attention, its
  out-projection, residual and ``norm_final``, the token state kept fp32 from
  the first layer through ``norm_final``;
- ``two_way_grid_fused`` (lines 1135 and 1148): the same function with the
  token state rounded to the compute dtype between the two layers, and kept
  fp32 from the second layer into the final attention.

Both take ``cor_tpu``'s arguments: the transformer ``p`` (a
``TwoWayTransformer``), the point embeddings ``tokens`` [n, T, C] (also the
token PE ``qpe_tok``), the image rows ``keys`` [n, N, C] or a store [S, N, C]
with ``idx`` int32 [n] (bf16 or fp32: like ``cor_tpu``'s, they take no int8
store), and the bias-free projections of the image PE [N, I]: by each
layer's t2i.k_proj (``kpe_layers``) and i2t.q_proj (``qpe_img_layers``) and
by the final attention's k_proj (``kpe_final``). They return (queries
[n, T, C], keys [n, N, C]) in the compute dtype, ``two_way_transformer``'s
contract after ``norm_final``.

On the card each is one launch (``launches`` adds 1 per call, fp32 apart in
``launches_fp32``) of the same persistent kernel, one 384-thread CTA an SM
(a producer warpgroup, two consumer warpgroups): K1-stack as a cooperative
grid of the co-resident CTAs with a grid barrier between its ten stages,
K1-grid as a thread-block cluster per candidate with a cluster barrier. Its
image stages are K1's and K2's passes redesigned for Hopper (``wgmma``
behind TMA-fed weight rings: ``csrc/twl_t2i.cuh``, ``csrc/twl_i2t.cuh``),
and each candidate's token stages are split over a cluster of CTAs through
distributed shared memory, in K1's sums; so K1-grid's keys are two K1
launches' bit for bit, and K1-stack's tokens between the layers are not
rounded, so its keys after the second layer are its own. In bf16 the image
passes read the weights laid out as their rings' blocks: each layer's from
K1's pack (``two_way_layer._pack``) and the final ``[k | v]``'s from this
module's ``_final_pack`` (K2's layout), all through ``cached_pack``. The
kernels take the SAM geometry of K1 (C 256, 8 heads, I 128, MLP 2048, 5 to
8 tokens, N a multiple of 64); any other CUDA input raises before any
launch, a CPU tensor takes the plain version, and with autograd recording
they raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from cor_tpu_torch.ops.common import layer_norm
from cor_tpu_torch.ops.diff import refuse_grad
from cor_tpu_torch.ops.kernels._build import check, count_launch, library
from cor_tpu_torch.ops.kernels.t2i_flash import (
    C_DIM,
    FINAL_CHUNK_ORDER,
    HEADS,
    INTERNAL,
    ROW_TILE,
    cached_pack,
    ring_blocks,
    t2i_flash_kv_plain,
)
from cor_tpu_torch.ops.kernels.two_way_layer import (
    CROSS_SCALE,
    MLP_DIM,
    SELF_SCALE,
    _check_geometry,
    _lin,
    _pack,
    gather_rows,
    image_pass_smem,
    layer_math,
)


def two_way_stack_plain(
    p, tokens, qpe_tok, keys, kpe_layers: Sequence[torch.Tensor],
    qpe_img_layers: Sequence[torch.Tensor], kpe_final, idx=None, eps: float = 1e-5,
    round_between_layers: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of both kernels: (queries [n, T, C], keys
    [n, N, C]) in the tokens' dtype. The token state is fp32 from the first
    layer to ``norm_final``, rounded to the compute dtype once between the
    layers with ``round_between_layers`` (K1-grid) and not without
    (K1-stack); each product operand is rounded as in K1 and K2."""
    dt = tokens.dtype
    r = lambda v: v.to(dt).float()  # noqa: E731 -- round to the compute dtype
    rows = gather_rows(keys, idx, None, dt)
    x, qpe = tokens.float(), qpe_tok.float()
    for i, lp in enumerate(p.layers):
        if i and round_between_layers:
            x = r(x)
        x, rows = layer_math(lp, x, qpe, rows, kpe_layers[i], qpe_img_layers[i], i == 0, eps, dt)
    fa = p.final_attn_t2i
    av = t2i_flash_kv_plain(rows, fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b, kpe_final,
                            _lin(r(x + qpe), fa.q_proj), fa.num_heads)
    x = layer_norm(x + _lin(av.float(), fa.out_proj), p.norm_final.scale, p.norm_final.bias, eps)
    return x.to(dt), rows


def two_way_stack_fused(
    p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final,
    idx: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-stack: the token state fp32 throughout (``_stack_kernel``)."""
    return _fused(two_way_stack_fused, p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers,
                  kpe_final, idx, eps, grid=False)


def two_way_grid_fused(
    p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final,
    idx: Optional[torch.Tensor] = None, eps: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1-grid: the tokens rounded after the first layer (``_grid_kernel``)."""
    return _fused(two_way_grid_fused, p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers,
                  kpe_final, idx, eps, grid=True)


def _final_pack(p, device, dtype) -> dict:
    """The final attention's weights in the kernel's layouts (``cached_pack``
    on the transformer): [k | v] [2 I, C] and [q_proj [I, C] | out_proj
    [C, I]] in the compute dtype, their fp32 biases and norm_final's, and in
    bf16 [k | v] laid out as the final pass's ring blocks (K2's, ``None`` in
    fp32, which splits the weight as it streams it)."""
    fa, nf = p.final_attn_t2i, p.norm_final
    tensors = [*fa.parameters(), *nf.parameters()]

    def make():
        mat = lambda *ts: torch.cat([t.detach().reshape(-1).to(device, dtype) for t in ts])  # noqa: E731
        f32 = lambda *ts: torch.cat([t.detach().reshape(-1).to(device, torch.float32) for t in ts])  # noqa: E731
        wkv = mat(fa.k_proj.w, fa.v_proj.w)
        blocks = (ring_blocks(wkv.reshape(2 * INTERNAL, C_DIM), 64, FINAL_CHUNK_ORDER)
                  if dtype == torch.bfloat16 else None)
        return {"wkv": wkv, "bkv": f32(fa.k_proj.b, fa.v_proj.b),
                "wfin": mat(fa.q_proj.w, fa.out_proj.w),
                "bfin": f32(fa.q_proj.b, fa.out_proj.b, nf.scale, nf.bias),
                "wkv_blocks": blocks}

    return cached_pack(p, "_fused_final_pack", tensors, device, dtype, make)


def fused_smem(dtype: torch.dtype, T: int) -> dict:
    """The dynamic shared memory of the kernel's stages at T tokens, as
    ``csrc/two_way_stack.cuh`` lays each out from offset 0 (``smem_fused``):
    {stage: bytes, ..., "kernel": the largest, the launch's}. The image
    stages are K1's passes and the t2i pass without the q chunk's bias; the
    token stages' fp32 buffers are K1's token bodies'."""
    img = image_pass_smem(dtype, T)
    out = {"t2i": img["t2i"], "t2i_final": img["t2i"] - INTERNAL * 4, "i2t": img["i2t"],
           "tokens_in": 4 * (7 * T * C_DIM + HEADS * T * T),
           "tokens_mid": 4 * (4 * T * C_DIM + T * MLP_DIM),
           "final_tokens": 4 * 3 * T * C_DIM}
    out["kernel"] = max(out.values())
    return out


def _check(p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final, idx) -> torch.dtype:
    """The compute dtype, or raise on what the kernel does not take (each
    layer as K1 takes it; no int8 store; depth 2; the final attention's
    geometry)."""
    if len(p.layers) != 2 or len(kpe_layers) != 2 or len(qpe_img_layers) != 2:
        raise ValueError(f"the fused transformer kernel takes depth 2, got {len(p.layers)} "
                         f"layers and {len(kpe_layers)} / {len(qpe_img_layers)} PE projections")
    if keys.dtype == torch.int8:
        raise TypeError("the fused transformer kernel takes no int8 store (as cor_tpu's stack "
                        "and grid kernels); its decode runs the per-layer kernels")
    dt = _check_geometry(p.layers[0], tokens, qpe_tok, keys, kpe_layers[0], qpe_img_layers[0],
                        idx, None)
    _check_geometry(p.layers[1], tokens, qpe_tok, keys, kpe_layers[1], qpe_img_layers[1], idx,
                   None)
    fa = p.final_attn_t2i
    N = keys.shape[1]
    if (fa.q_proj.w.shape != (INTERNAL, C_DIM) or fa.num_heads != HEADS
            or kpe_final.shape != (N, INTERNAL) or kpe_final.dtype != dt
            or kpe_final.device != tokens.device or not kpe_final.is_contiguous()):
        raise ValueError(f"the fused transformer kernel takes the final attention of C {C_DIM}, "
                         f"{HEADS} heads, I {INTERNAL} and kpe_final [N, {INTERNAL}] of the "
                         f"compute dtype on {tokens.device}")
    return dt


def launch_pointers(p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final, idx,
                    dt) -> list:
    """The kernel's 55 operands in ``cor_two_way_fused``'s order (tensors,
    ``None`` for a null pointer), its buffers allocated on the tokens'
    device: the inputs, each layer's packs, the final attention's pack, the
    per-stage buffers, the outputs (keys at 48, tokens at 49), then the bf16
    ring blocks of each layer's image passes and of the final [k | v] (the
    first 50 are the entry's first version's, which reads no more)."""
    n, T = tokens.shape[0], tokens.shape[1]
    N = keys.shape[1]
    dev = tokens.device
    tiles = N // ROW_TILE
    f32 = dict(device=dev, dtype=torch.float32)
    cd = dict(device=dev, dtype=dt)
    packs = [_pack(lp, dev, dt) for lp in p.layers]
    fin = _final_pack(p, dev, dt)
    # every stage's buffer its own (csrc/two_way_stack.cuh: no SM reads a
    # line before its write)
    tok = lambda k, **kw: [torch.empty((n, T, k), **kw) for _ in range(2)]  # noqa: E731
    x_mid, x_state = tok(C_DIM, **f32), tok(C_DIM, **f32)
    qt = tok(INTERNAL, **cd) + [torch.empty((n, T, INTERNAL), **cd)]
    q_img = [torch.empty((n, N, INTERNAL), **cd) for _ in range(2)]
    part = lambda *s: [torch.empty((n, tiles, HEADS * T, *s), **f32) for _ in range(3)]  # noqa: E731
    part_m, part_l, part_acc = part(), part(), part(INTERNAL // HEADS)
    k_i, v_i = tok(INTERNAL, **cd), tok(INTERNAL, **cd)
    keys1 = torch.empty((n, N, C_DIM), **cd)
    keys_out = torch.empty((n, N, C_DIM), **cd)
    tokens_out = torch.empty((n, T, C_DIM), **cd)
    ptrs = [tokens, qpe_tok, keys, idx]
    for pk, kpe, qpe in zip(packs, kpe_layers, qpe_img_layers):
        ptrs += [pk["wtok"], pk["btok"], pk["w_img"], pk["b_img"], pk["wo_i"], pk["bo_ln4"], kpe,
                 qpe]
    ptrs += [kpe_final, fin["wkv"], fin["bkv"], fin["wfin"], fin["bfin"], *x_mid, *x_state, *qt,
             *q_img, *part_m, *part_l, *part_acc, *k_i, *v_i, keys1, keys_out, tokens_out]
    for pk in packs:
        ptrs += [pk["w_img_blocks"], pk["wo_i_blocks"]]
    ptrs.append(fin["wkv_blocks"])
    return ptrs


def _fused(fn, p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final, idx, eps,
           grid: bool):
    name = fn.__name__
    leaves = (tokens, qpe_tok, keys, *kpe_layers, *qpe_img_layers, kpe_final, *p.parameters())
    if tokens.device.type == "cpu":
        refuse_grad(name, *leaves)
        return two_way_stack_plain(p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers,
                                   kpe_final, idx, eps, round_between_layers=grid)
    if tokens.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {tokens.device}")
    dt = _check(p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final, idx)
    refuse_grad(name, *leaves)
    n, T = tokens.shape[0], tokens.shape[1]
    S, N = keys.shape[0], keys.shape[1]
    dev = tokens.device
    ptrs = launch_pointers(p, tokens, qpe_tok, keys, kpe_layers, qpe_img_layers, kpe_final, idx,
                           dt)
    tokens_out, keys_out = ptrs[49], ptrs[48]
    arr = (ctypes.c_void_p * len(ptrs))(*[0 if t is None else t.data_ptr() for t in ptrs])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        check(library().cor_two_way_fused(
            int(grid) | CLUSTER_SIZE[name] << 8, S, n, T, N, ctypes.addressof(arr), SELF_SCALE,
            CROSS_SCALE, eps, int(dt == torch.float32), stream), name)
    count_launch(fn, dt, 1)
    return tokens_out, keys_out


def launch_team(fn, n: int, T: int, N: int, dtype: torch.dtype) -> Tuple[int, int]:
    """The launch ``fn`` (two_way_stack_fused or two_way_grid_fused) makes on
    the current card for n candidates, T tokens and N rows, without making
    it: (the CTAs of a candidate's token stages, the CTAs of the grid)."""
    team = (ctypes.c_int * 2)()
    grid = int(fn is two_way_grid_fused) | CLUSTER_SIZE[fn.__name__] << 8
    check(library().cor_two_way_fused_team(grid, n, T, N, int(dtype == torch.float32),
                                           ctypes.addressof(team)), f"{fn.__name__} team")
    return team[0], team[1]


# the CTAs a candidate's token stages take, by wrapper: 0, the kernel's own
# choice (csrc/two_way_stack.cuh choose_cluster); 1, 2, 4 or 8 to measure
# another (tools/cluster_sweep.py)
CLUSTER_SIZE = {"two_way_stack_fused": 0, "two_way_grid_fused": 0}
two_way_stack_fused.launches = two_way_stack_fused.launches_fp32 = 0
two_way_grid_fused.launches = two_way_grid_fused.launches_fp32 = 0
