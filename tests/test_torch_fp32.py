"""cor_tpu_torch at compute_dtype float32: the entry points' dtype policy, the
kernel wrappers' dtype checks and their weight packs, on the CPU.

The fp32 kernels themselves run only on the card (``gpu``-marked tests in
test_torch_kernels.py, and chip_smoke.py phases 29-32); their plain
versions are held against cor_tpu's fp32 kernels in test_torch_kernels.py,
test_torch_decoder.py and test_torch_large.py (head dims 72 and 80). Here
the wrappers' checks are run directly on CPU tensors: they take bf16 and
fp32 and refuse a mix of the two before anything launches.
"""

import dataclasses

import pytest
import torch

from cor_tpu_torch.config import EvalConfig, TrainConfig
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.ops.kernels import decoder_tail as ktail
from cor_tpu_torch.ops.kernels import seq_attention as kseq
from cor_tpu_torch.ops.kernels import t2i_flash as kt2i
from cor_tpu_torch.ops.kernels import two_way_layer as ktwl
from cor_tpu_torch.ops.kernels import vit_attention as kvit
from cor_tpu_torch.ops.kernels._build import count_launch, operand_dtype

DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


# ---------------------------------------------------------------------------
# the entry points' dtype policy (check_kernel_dtype)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,freeze,want", [
    ("float32", True, None),      # cli.serve, cli.index, RetrievalServer
    ("float32", False, None),     # serving with an unfrozen training config
    ("float32", True, None),      # frozen cli.train / Trainer
    ("float32", False, None),     # unfrozen training: K6b takes fp32
    ("bfloat16", False, None),
    ("float16", True, "@fp16"),
    ("float16", False, "@fp16"),
], ids=["serve-fp32", "serve-fp32-unfrozen-config", "train-fp32-frozen",
        "train-fp32-unfrozen", "train-bf16-unfrozen", "serve-fp16", "train-fp16"])
def test_check_kernel_dtype_on_the_card(dtype, freeze, want):
    """The card takes bf16 and fp32 on every path, training with unfrozen
    towers included; fp16 is refused naming its ROADMAP row. The check
    is the same for every entry point."""
    cfg = dataclasses.replace(EvalConfig().core_config(), compute_dtype=dtype,
                              freeze_towers=freeze)
    if want is None:
        pcore.check_kernel_dtype(cfg, "cuda")
    else:
        with pytest.raises(ValueError, match=f"ROADMAP Queue 2, {want}") as e:
            pcore.check_kernel_dtype(cfg, "cuda")
        assert "--device cpu" in str(e.value)
    pcore.check_kernel_dtype(cfg, "cpu")  # the CPU takes any float dtype


def test_shipped_configs_read_fp32():
    """compute_dtype is a key of both shipped configs; float32 reads
    through to the core config the entry points check."""
    assert dataclasses.replace(EvalConfig(), compute_dtype="float32").core_config().dtype == \
        torch.float32
    tc = dataclasses.replace(TrainConfig(), compute_dtype="float32")
    assert tc.core_config().compute_dtype == "float32" and tc.core_config().freeze_towers


# ---------------------------------------------------------------------------
# the wrappers' dtype checks, on CPU tensors
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sam_decoder():
    return pcore.init_mask_decoder(pcore.CoreConfig(), 1).eval()


def check_calls(sam_decoder, dt, mixed: bool):
    """Each wrapper's check on CPU tensors of dtype ``dt`` at its kernel's
    geometry; ``mixed``: one operand of each in the other dtype."""
    other = torch.float32 if dt == torch.bfloat16 else torch.bfloat16
    z = lambda *s, d=dt: torch.zeros(*s, dtype=d)  # noqa: E731
    m = other if mixed else dt
    lp = sam_decoder.transformer.layers[0]
    fa = sam_decoder.transformer.final_attn_t2i
    up = sam_decoder.output_upscaling
    N = 64
    return {
        "attention_seq_qkv": lambda: kseq._check_operands("attention_seq_qkv", z(2, 8, 3 * 128)),
        "attention_seq": lambda: kseq._check_operands(
            "attention_seq", z(1, 2, 8, 72), z(1, 2, 8, 72), z(1, 2, 8, 72, d=m)),
        "vit_attention_relpos": lambda: kvit._check(
            z(2, 16, 3 * 128), z(2, 2, 16, 4), z(2, 2, 16, 4, d=m), 2, (4, 4),
            "vit_attention_relpos")[1],
        "vit_attention_relpos_windows": lambda: kvit._check(
            z(1, 64, 3 * 160), z(1, 2, 64, 4, d=m), z(1, 2, 64, 4), 2, (8, 8),
            "vit_attention_relpos_windows", sides=(4, 4))[1],
        "two_way_layer": lambda: ktwl._check_geometry(
            lp, z(2, 6, 256), z(2, 6, 256), z(2, N, 256), z(N, 128), z(N, 128, d=m), None, None),
        "two_way_layer int8 store": lambda: ktwl._check_geometry(
            lp, z(2, 6, 256), z(2, 6, 256, d=m), torch.zeros(3, N, 256, dtype=torch.int8),
            z(N, 128), z(N, 128), torch.zeros(2, dtype=torch.int32), torch.ones(3)),
        "t2i_flash_kv": lambda: kt2i._check(z(2, N, 256), fa.k_proj.w, fa.v_proj.w, z(N, 128),
                                            z(2, 6, 128, d=m), 8),
        "decoder_tail": lambda: ktail._check(z(2, 2, 64, 256), up.convt1.w, up.convt2.w,
                                             z(2, 1, 32, d=m)),
    }


KERNELS = ["attention_seq_qkv", "attention_seq", "vit_attention_relpos",
           "vit_attention_relpos_windows", "two_way_layer", "two_way_layer int8 store",
           "t2i_flash_kv", "decoder_tail"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_checks_take_bf16_and_fp32(sam_decoder, kernel, dtype):
    dt = DTYPES[dtype]
    assert check_calls(sam_decoder, dt, mixed=False)[kernel]() == dt


@pytest.mark.parametrize("kernel", [k for k in KERNELS if k != "attention_seq_qkv"])
def test_wrapper_checks_refuse_mixed_dtypes(sam_decoder, kernel):
    """A mix of bf16 and fp32 operands is refused before anything launches
    (the check comes before the launch in every wrapper)."""
    for dt in DTYPES.values():
        with pytest.raises(TypeError, match="bf16 or fp32 operands, all of one dtype"):
            check_calls(sam_decoder, dt, mixed=True)[kernel]()


def test_operand_dtype_refuses_other_dtypes():
    for other in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="bf16 or fp32") as e:
            operand_dtype("k", torch.zeros(1, dtype=other))
        assert ("@fp16" in str(e.value)) == (other == torch.float16)
    assert operand_dtype("k", torch.zeros(1), None, torch.zeros(2)) == torch.float32


def test_launches_are_counted_by_dtype():
    def fn():
        pass

    fn.launches = fn.launches_fp32 = 0
    count_launch(fn, torch.bfloat16)
    count_launch(fn, torch.float32, 4)
    assert (fn.launches, fn.launches_fp32) == (1, 4)


# ---------------------------------------------------------------------------
# the weight packs follow the compute dtype
# ---------------------------------------------------------------------------


def packs(sam_decoder, dt):
    """Each decoder kernel's pack in ``dt``: {name: (matrices, fp32 vectors)}."""
    lp = sam_decoder.transformer.layers[0]
    fa = sam_decoder.transformer.final_attn_t2i
    up = sam_decoder.output_upscaling
    pk = ktwl._pack(lp, torch.device("cpu"), dt)
    w_kv, b_kv = kt2i._pack(fa.k_proj.w, fa.k_proj.b, fa.v_proj.w, fa.v_proj.b,
                            torch.device("cpu"), dt)
    w1t, w2t, vec = ktail._pack(up.convt1.w, up.convt1.b, up.ln.scale, up.ln.bias, up.convt2.w,
                                up.convt2.b, torch.device("cpu"), dt)
    return {
        "two_way_layer": ((pk["wtok"], pk["w_img"], pk["wo_i"]),
                          (pk["btok"], pk["b_img"], pk["bo_ln4"])),
        "t2i_flash_kv": ((w_kv,), (b_kv,)),
        "decoder_tail": ((w1t, w2t), (vec,)),
    }


@pytest.mark.parametrize("kernel", ["two_way_layer", "t2i_flash_kv", "decoder_tail"])
def test_packs_are_keyed_by_dtype(sam_decoder, kernel):
    """A pack made for one compute dtype is never handed to a call of the
    other: bf16, then fp32, then bf16 again each get matrices of their own
    dtype (the fp32 pack holds the weights exactly), the vectors stay fp32,
    and a repeated call of one dtype reuses its pack."""
    seen = {}
    for dtype in ("bf16", "fp32", "bf16"):
        dt = DTYPES[dtype]
        mats, vecs = packs(sam_decoder, dt)[kernel]
        assert all(m.dtype == dt for m in mats) and all(v.dtype == torch.float32 for v in vecs)
        seen.setdefault(dtype, []).append(mats)
    assert all(not torch.equal(m, m.to(torch.bfloat16).float()) for m in seen["fp32"][0])
    again = packs(sam_decoder, torch.bfloat16)[kernel][0]
    assert all(a is b for a, b in zip(again, seen["bf16"][1]))


# ---------------------------------------------------------------------------
# fp32 convolutions in full fp32 (ROADMAP Queue 3, P6)
# ---------------------------------------------------------------------------


def tiny_fp32_config():
    """A tiny CORE config at compute_dtype float32 whose every convolution
    runs: the SAM neck (1x1, 3x3), the mask adapter's convs, the decoder's
    upscale, the prompt encoder's mask convs."""
    from cor_tpu_torch.models import pooling, prompt_encoder, sam_decoder, siglip, support_branch

    towers = siglip.SigLIPConfig(siglip.SigLIPVisionConfig(32, 16, 128, 1, 2),
                                 siglip.SigLIPTextConfig(8, 64, 128, 1, 2))
    sup = support_branch.SupportBranchConfig(
        prompt_dim=16, proj_hidden=24, siglip_override=towers,
        adapter_override=pooling.MaskAdapterConfig(128, 16, 8, 16, 4))
    dec = sam_decoder.MaskDecoderConfig(
        transformer_dim=16, iou_head_hidden_dim=16,
        transformer=sam_decoder.TwoWayTransformerConfig(2, 16, 2, 32))
    enc = pcore.SamEncoderConfig(64, 16, embed_dim=32, depth=2, num_heads=2, out_chans=16,
                                 window_size=3, global_attn_indexes=(1,))
    return pcore.CoreConfig(compute_dtype="float32", freeze_towers=False, encoder_override=enc,
                            support_override=sup, decoder_override=dec,
                            prompt_override=prompt_encoder.PromptEncoderConfig(16, (4, 4),
                                                                               (64, 64)))


@pytest.fixture
def conv_flags():
    """Every aten convolution, forward and backward (whoever calls it: the
    port's helpers, autograd), run from here on, as (kind, input dtype,
    cuDNN allow_tf32 at the call)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    aten = torch.ops.aten
    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is aten.convolution.default:
                kind = "conv_transpose2d" if args[6] else "conv2d"
                calls.append((kind, args[0].dtype, torch.backends.cudnn.allow_tf32))
            elif func is aten.convolution_backward.default:
                calls.append(("backward", args[1].dtype, torch.backends.cudnn.allow_tf32))
            return func(*args, **(kwargs or {}))

    with Record():
        yield calls


@pytest.mark.parametrize("default", [True, False], ids=["tf32-allowed", "tf32-off"])
def test_fp32_convolutions_run_with_tf32_off(conv_flags, monkeypatch, default):
    """P6: under either global cuDNN setting, an fp32 encode, a fused=False
    decode, a prompt encode with a mask prompt and an unfrozen fp32 train
    step run every convolution, forward and backward, with TF32 off; bf16
    convolutions run under the global flag as found; the flag is left as it
    was."""
    from cor_tpu_torch.models import prompt_encoder as ppe
    from cor_tpu_torch.models import sam_decoder as psd
    from cor_tpu_torch.ops.common import conv2d, conv_transpose_2x
    from cor_tpu_torch.train import optim as poptim
    from cor_tpu_torch.train.step import TrainState, make_train_step

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", default)
    cfg = tiny_fp32_config()
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        emb = pcore.init_image_encoder(cfg, 2)(torch.randn(2, 64, 64, 3, generator=g))
        dec = pcore.init_mask_decoder(cfg, 1)
        pe = torch.randn(1, 4, 4, 16, generator=g)
        masks, _, _ = psd.mask_decoder(dec, emb, pe, torch.randn(2, 1, 16, generator=g), emb,
                                       False, fused=False)
        penc = ppe.init_full_prompt_encoder(cfg.prompt, 0)
        _, dense = ppe.full_prompt_encoder(penc, cfg.prompt,
                                           masks=torch.randn(2, 16, 16, 1, generator=g))
    assert masks.dtype == dense.dtype == torch.float32
    model = pcore.init_core_model(cfg, 0)
    opt, _ = poptim.make_optimizer(model, "AdamW", lr=1e-3, freeze_towers=False)
    qm = torch.zeros(2, 64, 64, 1)
    qm[:, 8:30, 10:40] = 1.0
    batch = {"query_img": torch.randn(2, 64, 64, 3, generator=g),
             "support_img": torch.randn(2, 32, 32, 3, generator=g),
             "text": torch.randint(2, 64, (2, 8), generator=g, dtype=torch.int32),
             "support_mask": (torch.rand(2, 32, 32, 1, generator=g) > 0.5).float(),
             "query_mask": qm, "valid": torch.ones(2)}
    m = make_train_step(cfg, seed=0)(TrainState(model, opt), batch, 1e-3)
    assert torch.isfinite(m["total_loss"])
    kinds = {k for k, dt, _ in conv_flags if dt == torch.float32}
    assert kinds == {"conv2d", "conv_transpose2d", "backward"}, kinds
    assert not [c for c in conv_flags if c[1] != torch.float32 or c[2]], conv_flags
    # bf16 is left to torch: each call sees the global flag as it was
    conv_flags.clear()
    x = torch.randn(1, 4, 4, 16, generator=g).bfloat16()
    conv2d(x, torch.randn(8, 16, 3, 3, generator=g), padding=1)
    conv_transpose_2x(x, torch.randn(16, 2, 2, 8, generator=g), torch.zeros(8))
    psd._conv_transpose_2x(dec.output_upscaling.convt1, x)
    assert conv_flags == [("conv2d", torch.bfloat16, default),
                          ("conv_transpose2d", torch.bfloat16, default),
                          ("conv_transpose2d", torch.bfloat16, default)]
    assert torch.backends.cudnn.allow_tf32 == default
