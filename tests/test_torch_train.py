"""cor_tpu_torch's training slice against cor_tpu's, on the CPU in fp32.

One train step of both packages on the same weights (cor_tpu's init, carried
over by the weight bridge) and the same numpy-made batch, in the
deterministic form of ``tests/helpers.py``'s tiny config (``proj_dropout=0``,
``fusion="add"``: no dropout draw anywhere): the loss and its parts,
``grad_norm``, every trainable gradient and the parameters after one AdamW
update; then three steps' losses. cor_tpu's step is taken as its
``make_train_step`` composes it (``value_and_grad`` of ``core_forward`` and
``core_total_loss``, ``_write_lr``, the masked optax update), as its own
``tests/test_train_step.py`` takes a hand-rolled step, so that each mode
compiles one JAX graph. Frozen, and unfrozen with the kernel-active
SAM encoder of ``tests/test_kernel_vjp.py`` (img 96, embed 128, 2 heads of
64, window 4, block 1 global), where cor_tpu runs K6 and its backward K6b
(Pallas interpret mode) and the port K6's autograd Function with the plain
versions of both. Then the pieces: the 2-D attention's and the encoder's
gradients, grad accumulation, the eval step, the losses, the metrics, the
schedules, the trainable mask, checkpoints and resume, the config reader,
and ``cli.train`` on the CPU.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cor_tpu.ops.attention as jatt
from cor_tpu.models import sam_encoder as jsam
from cor_tpu.models.prompt_encoder import PromptEncoderConfig as JPromptConfig
from cor_tpu.train import checkpoint as jckpt
from cor_tpu.train import losses as jlosses
from cor_tpu.train import metrics as jmetrics
from cor_tpu.train import optim as joptim
from cor_tpu.train.step import _write_lr
from cor_tpu.train.step import make_eval_step as j_make_eval_step
from cor_tpu_torch.cli import train as pcli
from cor_tpu_torch.config import TrainConfig, load_train_config, read_flat_yaml
from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.models import prompt_encoder as ppe
from cor_tpu_torch.models import sam_encoder as psam
from cor_tpu_torch.ops import attention as patt
from cor_tpu_torch.train import checkpoint as pckpt
from cor_tpu_torch.train import losses as plosses
from cor_tpu_torch.train import metrics as pmetrics
from cor_tpu_torch.train import optim as poptim
from cor_tpu_torch.train.step import (
    TrainState,
    make_eval_step,
    make_predict_step,
    make_train_step,
)
from cor_tpu_torch.utils.weights import (
    flatten_tree,
    load_cor_tpu_params,
    to_cor_tpu_layout,
    to_cor_tpu_tree,
)
from tests.helpers import TINY_SUPPORT
from tests.test_torch_encoder import fill
from tests.test_torch_serve import decode_core_configs

LR = 1e-3
# the kernel-active encoder of cor_tpu's tests/test_kernel_vjp.py, its neck
# at the tiny decoder's width
KENC = dict(img_size=96, patch_size=16, embed_dim=128, depth=2, num_heads=2, out_chans=16,
            window_size=4, global_attn_indexes=(1,))
GTOL = dict(atol=2e-5, rtol=2e-4)  # cor_tpu's tolerance on the unfrozen encoder's grads


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def configs(freeze: bool, **jkw):
    """cor_tpu's tiny config in its deterministic form and the port's twin;
    unfrozen with the kernel-active encoder."""
    jsup = dataclasses.replace(TINY_SUPPORT, proj_dropout=0.0, fusion="add")
    jc, pc = decode_core_configs()
    psup = dataclasses.replace(pc.support_override, proj_dropout=0.0, fusion="add")
    jc = dataclasses.replace(jc, support_override=jsup, freeze_towers=freeze, **jkw)
    pc = dataclasses.replace(pc, support_override=psup, freeze_towers=freeze, **jkw)
    if not freeze:
        enc = jsam.SamEncoderConfig(**KENC)
        jc = dataclasses.replace(jc, encoder_override=enc,
                                 prompt_override=JPromptConfig(16, (6, 6), (96, 96)))
        pc = dataclasses.replace(pc, encoder_override=psam.SamEncoderConfig(**KENC),
                                 prompt_override=ppe.PromptEncoderConfig(16, (6, 6), (96, 96)))
    return jc, pc


def make_batch(rng, n: int, img: int, valid=None):
    qm = np.zeros((n, img, img, 1), np.float32)
    for i in range(n):  # a non-empty foreground and background in every row
        r0, c0 = rng.integers(0, img // 2, 2)
        qm[i, r0:r0 + img // 3, c0:c0 + img // 2] = 1.0
    return {
        "query_img": rng.standard_normal((n, img, img, 3), dtype=np.float32),
        "support_img": rng.standard_normal((n, 32, 32, 3), dtype=np.float32),
        "text": rng.integers(2, 64, (n, 8)).astype(np.int32),
        "support_mask": (rng.random((n, 32, 32, 1)) > 0.5).astype(np.float32),
        "query_mask": qm,
        "valid": np.ones(n, np.float32) if valid is None else np.asarray(valid, np.float32),
    }


def tree_for(pc, seed: int):
    """A cor_tpu parameter tree from the port's seeded init (cor_tpu's
    shapes and distributions; no JAX init to compile), the encoder's rel-pos
    tables and pos_embed filled."""
    tree = to_cor_tpu_tree(pcore.init_core_model(pc, seed))
    tree["image_encoder"] = fill(tree["image_encoder"], np.random.default_rng(seed + 10))
    return tree


def port_model(pc, tree):
    return load_cor_tpu_params(pcore.init_core_model(pc, 0), tree)


def j_loss_fn(jc):
    from cor_tpu.models.core_model import core_forward

    def loss(p, b):
        pred, qemb, sfeat = core_forward(p, b["query_img"], b["support_img"], b["text"],
                                         b["support_mask"], jc, train=True)
        return jlosses.core_total_loss(jnp.transpose(pred, (0, 2, 3, 1)), b["query_mask"],
                                       qemb, sfeat, valid=b.get("valid"))
    return loss


_J_GRAD = {}


def j_grad(freeze: bool):
    """cor_tpu's jitted value_and_grad of the loss, one per mode (the
    batches share one shape: 2 rows with ``valid``)."""
    if freeze not in _J_GRAD:
        _J_GRAD[freeze] = jax.jit(jax.value_and_grad(j_loss_fn(configs(freeze)[0]), has_aux=True))
    return _J_GRAD[freeze]


_J_UPDATE = {}


def j_update(freeze: bool, params):
    """cor_tpu's optimizer for the mode (AdamW, lr 1e-3) and the rest of its
    step, jitted once per mode: the learning rate into the masked chain, the
    update, its application. Returns (init, update)."""
    import optax

    if freeze not in _J_UPDATE:
        tx, _ = joptim.make_optimizer(params, "AdamW", lr=LR, freeze_towers=freeze)

        def update(params, opt_state, grads):
            updates, opt_state = tx.update(grads, _write_lr(opt_state, jnp.float32(LR)), params)
            return optax.apply_updates(params, updates), opt_state

        _J_UPDATE[freeze] = (jax.jit(tx.init), jax.jit(update))
    return _J_UPDATE[freeze]


def global_norm(tree) -> float:
    """optax.global_norm, in numpy (no eager JAX op to compile per leaf)."""
    return float(np.sqrt(sum(np.sum(np.square(np.asarray(x, np.float64)))
                             for x in jax.tree.leaves(tree))))


def assert_update_matches(got_tree, want_tree, before_tree, grad_tree):
    """Parameters after one AdamW step from the same start. Where |grad| >=
    1e-5 the step is lr * sign(grad) (clamped, decayed) in both: they agree
    to 1e-6 + 1e-3 lr. Near a zero gradient the step lr * g / (|g| + eps)
    amplifies the last digits in which the two packages' gradients differ,
    so there only |step difference| <= 2 lr holds."""
    got, want = flatten_tree(got_tree), flatten_tree(want_tree)
    before, grads = flatten_tree(before_tree), flatten_tree(grad_tree)
    assert got.keys() == want.keys()
    for name in want:
        big = np.abs(grads[name]) >= 1e-5
        diff = np.abs((got[name] - before[name]) - (want[name] - before[name]))
        assert diff[big].max(initial=0.0) <= 1e-6 + 1e-3 * LR, name
        assert diff.max(initial=0.0) <= 2 * LR, name


@pytest.fixture(scope="module", params=[True, False], ids=["frozen", "unfrozen"])
def stepped(request):
    """Both packages through one AdamW step (then two more), and the
    gradients of the first, on the same weights and batches."""
    freeze = request.param
    jc, pc = configs(freeze)
    tree = tree_for(pc, 3)
    rng = np.random.default_rng(5)
    batches = [make_batch(rng, 2, jc.encoder.img_size) for _ in range(3)]

    jparams = jax.tree.map(jnp.asarray, tree)
    init, update = j_update(freeze, jparams)
    opt_state = init(jparams)
    j_metrics, j_after, j_grads = [], None, None
    for i, b in enumerate(batches):
        (_, aux), g = j_grad(freeze)(jparams, jax.tree.map(jnp.asarray, b))
        j_metrics.append({k: float(v) for k, v in aux.items()})
        j_metrics[-1]["grad_norm"] = global_norm(g)
        jparams, opt_state = update(jparams, opt_state, g)
        if i == 0:
            j_grads, j_after = g, jax.tree.map(np.asarray, jparams)

    model = port_model(pc, tree)
    opt, _ = poptim.make_optimizer(model, "AdamW", lr=LR, freeze_towers=freeze)
    tb = [{k: t(v) for k, v in b.items()} for b in batches]
    state = TrainState(model, opt)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    pe_before = model.prompt_encoder.pe_layer.gaussian_matrix.clone()
    # the gradients of the first step, before its clamp and update
    grads_model = port_model(pc, tree)
    poptim.make_optimizer(grads_model, "AdamW", lr=LR, freeze_towers=freeze)
    from cor_tpu_torch.train.step import train_loss

    p_total, _ = train_loss(pc, grads_model, tb[0], None)
    p_total.backward()
    p_grads = {n: p.grad for n, p in grads_model.named_parameters() if p.grad is not None}
    step = make_train_step(pc, seed=0)
    p_metrics, p_after = [], None
    for i, b in enumerate(tb):
        m = step(state, b, LR)
        p_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            p_after = to_cor_tpu_tree(model)
    return dict(freeze=freeze, tree=tree, j_grads=jax.tree.map(np.asarray, j_grads),
                j_metrics=j_metrics, j_after=j_after, p_grads=p_grads,
                p_metrics=p_metrics, p_after=p_after, model=model, before=before,
                pe_before=pe_before, state=state)


def test_train_step_loss_and_grad_norm_match_cor_tpu(stepped):
    for k in ("seg_loss", "fg_loss", "bg_loss", "total_loss"):
        np.testing.assert_allclose(stepped["p_metrics"][0][k], stepped["j_metrics"][0][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(stepped["p_metrics"][0]["grad_norm"],
                               stepped["j_metrics"][0]["grad_norm"], rtol=1e-4)


def test_train_step_gradients_match_cor_tpu(stepped):
    """Every trainable leaf's gradient (in cor_tpu's layout). Where the port
    has none (a frozen leaf; or one this config does not use: CirFuse under
    "add", the hypernetworks of the unselected mask tokens) cor_tpu's is 0."""
    j_flat = flatten_tree(stepped["j_grads"])
    mask = poptim.trainable_mask(stepped["model"], stepped["freeze"])
    got = stepped["p_grads"]
    assert all(mask[n] for n in got)
    assert any(n.startswith("image_encoder.") for n in got) == (not stepped["freeze"])
    owner = stepped["model"]
    for name, want in j_flat.items():
        if name not in got:
            assert not np.any(want), name
            continue
        g = to_cor_tpu_layout(owner, name, got[name].numpy())
        # the whole model's forward agrees to ~1e-4 (the encoder's 3e-4, test_
        # torch_encoder.py), and a weight's gradient sums it over the batch
        # and the grid: atol 5e-5 of the leaf's largest gradient (>= 1)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g, want, atol=5e-5 * scale, rtol=GTOL["rtol"], err_msg=name)


def test_train_step_update_matches_cor_tpu(stepped):
    """The parameters after one AdamW update (clamp 0.5, lr 1e-3)."""
    assert_update_matches(stepped["p_after"], stepped["j_after"], stepped["tree"],
                          stepped["j_grads"])


def test_three_steps_losses_match_cor_tpu(stepped):
    for p, j in zip(stepped["p_metrics"], stepped["j_metrics"]):
        np.testing.assert_allclose(p["total_loss"], j["total_loss"], rtol=1e-4)
    assert stepped["state"].step == 3


def test_frozen_leaves_stay_bit_identical(stepped):
    """Frozen leaves (the towers and the IoU head when frozen) are
    bit-identical after three steps, the PE matrix in both modes; a leaf of
    each trainable part moved."""
    model, mask = stepped["model"], poptim.trainable_mask(stepped["model"], stepped["freeze"])
    for name, p in model.named_parameters():
        if not mask[name]:
            assert torch.equal(p, stepped["before"][name]), name
    assert torch.equal(model.prompt_encoder.pe_layer.gaussian_matrix, stepped["pe_before"])
    moved = lambda prefix: any(  # noqa: E731
        not torch.equal(p, stepped["before"][n]) for n, p in model.named_parameters()
        if n.startswith(prefix))
    assert moved("mask_decoder.transformer") and moved("support_branch.dim_proj")
    assert moved("image_encoder.blocks.1.attn.rel_pos_h") == (not stepped["freeze"])
    assert moved("support_branch.siglip") == (not stepped["freeze"])


def test_training_keeps_fp32_masters_in_bf16():
    """compute_dtype bf16 on fp32 masters: the step computes on copies, the
    masters stay fp32 and receive fp32 gradients, nothing is cast in place."""
    jc, pc = configs(False, compute_dtype="bfloat16")
    model = port_model(pc, tree_for(pc, 4))
    opt, _ = poptim.make_optimizer(model, "AdamW", lr=LR, freeze_towers=False)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    b = {k: t(v) for k, v in make_batch(np.random.default_rng(1), 2, 96).items()}
    m = make_train_step(pc, seed=0)(TrainState(model, opt), b, LR)
    assert np.isfinite(float(m["total_loss"])) and float(m["grad_norm"]) > 0
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is None or p.grad.dtype == torch.float32, name
    assert not torch.equal(model.image_encoder.blocks[1].attn.rel_pos_h,
                           before["image_encoder.blocks.1.attn.rel_pos_h"])
    assert model.prompt_encoder.pe_layer.gaussian_matrix.dtype == torch.float32


# ---------------------------------------------------------------------------
# the attention and the encoder, differentiated
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 4], ids=["global", "windowed"])
def test_attention_2d_fused_grad_matches_cor_tpu(rng, window):
    """The port's attention_2d_fused (K6 and K6b's plain versions) against
    jax.grad of cor_tpu's (K6 and K6b in interpret mode), for the parameters
    and the input: an 8 x 8 grid, or a 10 x 10 grid in windows of 4."""
    side = 8 if window == 0 else 4
    jp = jatt.init_attention_2d(jax.random.PRNGKey(1), 128, 2, use_rel_pos=True,
                                input_size=(side, side))
    jp = jax.tree.map(np.asarray, jp)
    for k in ("rel_pos_h", "rel_pos_w"):
        jp[k] = (0.3 * rng.standard_normal(jp[k].shape)).astype(np.float32)
    hw = 8 if window == 0 else 10
    x = (0.3 * rng.standard_normal((2, hw, hw, 128))).astype(np.float32)

    def j_loss(p, x):
        if window:
            xw, pad = jatt.window_partition(x, window)
            y = jatt.window_unpartition(jatt.attention_2d_fused(p, xw, 2), window, pad, (hw, hw))
        else:
            y = jatt.attention_2d_fused(p, x, 2)
        return jnp.mean(y**2)

    jg = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    pp = load_cor_tpu_params(patt.Attention2d(128, 2, (side, side)), jp)
    xt = t(x).requires_grad_()
    if window:
        xw, pad = patt.window_partition(xt, window)
        y = patt.window_unpartition(patt.attention_2d_fused(pp, xw, 2), window, pad, (hw, hw))
    else:
        y = patt.attention_2d_fused(pp, xt, 2)
    (y**2).mean().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[1]), atol=1e-5, rtol=1e-4)
    got = {n: to_cor_tpu_layout(pp, n, p.grad.numpy()) for n, p in pp.named_parameters()}
    for name, want in flatten_tree(jax.tree.map(np.asarray, jg[0])).items():
        np.testing.assert_allclose(got[name], want, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("D", [64, 80])
@pytest.mark.parametrize("hw", [10, 8], ids=["padded10", "exact8"])
def test_attention_2d_fused_windows_grad_matches_cor_tpu(rng, hw, D):
    """K7's route (``attention_2d_fused(..., window=4)``: its plain VJP
    recomputed in the backward) against jax.grad of cor_tpu's (K7 at head_dim
    64 in interpret mode, through its oracle VJP; the partition fallback at
    80), for the parameters and the input: a 10 x 10 grid padded to 12 x 12
    and an exact 8 x 8, 2 heads of D, at cor_tpu's tolerance for K7's
    gradient (tests/test_kernel_vjp.py)."""
    C = 2 * D
    jp = jax.tree.map(np.asarray, jatt.init_attention_2d(
        jax.random.PRNGKey(5), C, 2, use_rel_pos=True, input_size=(4, 4)))
    for k in ("rel_pos_h", "rel_pos_w"):
        jp[k] = (0.3 * rng.standard_normal(jp[k].shape)).astype(np.float32)
    x = (0.3 * rng.standard_normal((1, hw, hw, C))).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p, x: jnp.mean(jatt.attention_2d_fused(p, x, 2, window=4) ** 2),
                          argnums=(0, 1)))(jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    pp = load_cor_tpu_params(patt.Attention2d(C, 2, (4, 4)), jp)
    xt = t(x).requires_grad_()
    (patt.attention_2d_fused(pp, xt, 2, window=4) ** 2).mean().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg[1]), atol=1e-5, rtol=1e-4)
    got = {n: to_cor_tpu_layout(pp, n, p.grad.numpy()) for n, p in pp.named_parameters()}
    for name, want in flatten_tree(jax.tree.map(np.asarray, jg[0])).items():
        np.testing.assert_allclose(got[name], want, atol=1e-5, rtol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def encoder_grads():
    """The kernel-active encoder (the port's seeded init, rel-pos tables and
    pos_embed filled) and jax.grad of cor_tpu's, remat on (its default)."""
    jcfg = jsam.SamEncoderConfig(**KENC)
    params = fill(to_cor_tpu_tree(psam.SamEncoder(psam.SamEncoderConfig(**KENC))),
                  np.random.default_rng(8))
    x = np.random.default_rng(9).standard_normal((1, 96, 96, 3)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda p: jnp.mean(jsam.sam_encoder(p, jnp.asarray(x), jcfg) ** 2)))(
        jax.tree.map(jnp.asarray, params))
    return params, x, flatten_tree(jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_unfrozen_encoder_grad_matches_cor_tpu(encoder_grads, remat):
    """The kernel-active encoder's parameter gradients against jax.grad of
    cor_tpu's, with the port's remat on and off."""
    params, x, want = encoder_grads
    port = load_cor_tpu_params(psam.SamEncoder(psam.SamEncoderConfig(**KENC,
                                                                     remat_blocks=remat)), params)
    (port(t(x)) ** 2).mean().backward()
    assert want.keys() == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        g = to_cor_tpu_layout(port, name, p.grad.numpy())
        np.testing.assert_allclose(g, want[name], **GTOL, err_msg=name)


# ---------------------------------------------------------------------------
# accumulation and the eval step
# ---------------------------------------------------------------------------


def test_grad_accum_matches_cor_tpu():
    """grad_accum=2 on a batch of 4, its last row padding (valid 0): loss,
    grad_norm and the updated parameters as cor_tpu's accumulation (its
    microbatch gradients weighted by their valid counts, one update)."""
    jc, pc = configs(True)
    tree = tree_for(pc, 6)
    rng = np.random.default_rng(2)
    micro = [make_batch(rng, 2, 64), make_batch(rng, 2, 64, valid=[1, 0])]
    jparams = jax.tree.map(jnp.asarray, tree)
    g_acc, aux_acc = None, {}
    for mb in micro:
        (_, aux), g = j_grad(True)(jparams, jax.tree.map(jnp.asarray, mb))
        w = float(mb["valid"].sum())
        g = jax.tree.map(lambda x: w * np.asarray(x), g)
        g_acc = g if g_acc is None else jax.tree.map(np.add, g_acc, g)
        aux_acc = {k: aux_acc.get(k, 0.0) + w * float(v) for k, v in aux.items()}
    g_acc = jax.tree.map(lambda a: a / 3.0, g_acc)
    init, update = j_update(True, jparams)
    jafter, _ = update(jparams, init(jparams), g_acc)

    model = port_model(pc, tree)
    opt, _ = poptim.make_optimizer(model, "AdamW", lr=LR)
    batch = {k: t(np.concatenate([micro[0][k], micro[1][k]])) for k in micro[0]}
    pm = make_train_step(pc, seed=0, grad_accum=2)(TrainState(model, opt), batch, LR)
    for k in ("seg_loss", "fg_loss", "bg_loss", "total_loss"):
        np.testing.assert_allclose(float(pm[k]), aux_acc[k] / 3.0, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(pm["grad_norm"]), global_norm(g_acc), rtol=1e-4)
    assert_update_matches(to_cor_tpu_tree(model), jax.tree.map(np.asarray, jafter), tree,
                          jax.tree.map(np.asarray, g_acc))


def test_eval_step_matches_cor_tpu_with_padding():
    """The (sums, count) of a batch with a padded row, through the fused
    inference path: the padded row drops out of both."""
    jc, pc = configs(True)
    tree = tree_for(pc, 7)
    b = make_batch(np.random.default_rng(3), 3, 64, valid=[1, 1, 0])
    j_sums, j_n = j_make_eval_step(jc)(jax.tree.map(jnp.asarray, tree),
                                       jax.tree.map(jnp.asarray, b))
    model, tb = port_model(pc, tree), {k: t(v) for k, v in b.items()}
    p_sums, p_n = make_eval_step(pc)(model, tb)
    assert float(p_n) == float(j_n) == 2.0
    for k in j_sums:
        np.testing.assert_allclose(float(p_sums[k]), float(j_sums[k]), rtol=1e-4, err_msg=k)
    prob = make_predict_step(pc)(model, tb)  # the low-res map the validator upsamples
    assert prob.shape == (3, 16, 16, 1) and prob.min() == 0.0 and prob.max() <= 1.0


# ---------------------------------------------------------------------------
# losses, metrics, schedules, the mask
# ---------------------------------------------------------------------------


def test_losses_match_cor_tpu_with_padding_and_the_bg_quirk(rng):
    """Each term and the total on a batch whose last row is padding, one row
    with an empty mask (out of fg) and one full (out of bg); the bg term's
    cross-sample broadcast holds, and a zero support channel too."""
    n = 4
    pred = rng.standard_normal((n, 16, 16, 1)).astype(np.float32) * 3
    qm = (rng.random((n, 64, 64, 1)) > 0.6).astype(np.float32)
    qm[1], qm[2] = 0.0, 1.0
    emb = rng.standard_normal((n, 8, 8, 12)).astype(np.float32)
    sup = rng.standard_normal((n, 1, 12)).astype(np.float32)
    sup[:, :, 3] = 0.0
    valid = np.array([1, 1, 1, 0], np.float32)
    j_total = jax.jit(jlosses.core_total_loss)  # one graph each: no eager op to compile
    for v in (None, valid):
        want = j_total(*map(jnp.asarray, (pred, qm, emb, sup)),
                       valid=None if v is None else jnp.asarray(v))
        got = plosses.core_total_loss(*map(t, (pred, qm, emb, sup)),
                                      valid=None if v is None else t(v))
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5)
        for k in want[1]:
            np.testing.assert_allclose(float(got[1][k]), float(want[1][k]), rtol=1e-5, atol=1e-7)
    # the gradient of the bg term with its zero channel, as cor_tpu's
    jg = jax.jit(jax.grad(lambda s: jlosses.bg_feat_similarity_loss(
        jnp.asarray(emb), s, jnp.asarray(qm), jnp.asarray(valid))))(jnp.asarray(sup))
    st = t(sup).requires_grad_()
    plosses.bg_feat_similarity_loss(t(emb), st, t(qm), t(valid)).backward()
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(jg), atol=1e-6, rtol=1e-5)


def test_metrics_match_cor_tpu(rng):
    logits = rng.standard_normal((3, 20, 20, 1)).astype(np.float32) * 4
    gt = (rng.random((3, 20, 20, 1)) > 0.5).astype(np.float32)
    gt[2] = 0.0
    jp = jax.jit(jmetrics.normalize_prediction)(jnp.asarray(logits))
    pp = pmetrics.normalize_prediction(t(logits))
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), atol=1e-6)
    want = jax.jit(lambda p, g: {**jmetrics.all_soft_metrics(p, g),
                                 **jmetrics.binarized_dice_iou(p, g)})(jp, jnp.asarray(gt))
    got = pmetrics.all_soft_metrics(pp, t(gt))
    got.update(pmetrics.binarized_dice_iou(pp, t(gt)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["CosineAnnealingLR", "CosineAnnealingWarmRestarts",
                                  "CosineLRScheduler", "ExponentialLR", "StepLR", "None"])
def test_schedules_match_cor_tpu(name):
    kw = dict(lr_decay_rate=0.5, lr_decay_epoch=4)
    want = joptim.make_lr_schedule(name, 1e-4, 15, **kw)
    got = poptim.make_lr_schedule(name, 1e-4, 15, **kw)
    for epoch in range(1, 16):
        np.testing.assert_allclose(got(epoch), float(want(epoch)), rtol=2e-6, err_msg=str(epoch))


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "unfrozen"])
def test_trainable_mask_counts_match_cor_tpu(freeze):
    _, pc = configs(True)
    tree = tree_for(pc, 1)
    model = port_model(pc, tree)
    jmask = joptim.trainable_mask(tree, freeze)
    pmask = poptim.trainable_mask(model, freeze)
    assert pmask == {k: bool(v) for k, v in flatten_tree(jmask).items()}
    assert poptim.count_params(model) == joptim.count_params(tree)
    assert poptim.count_params(model, pmask) == joptim.count_params(tree, jmask)


# ---------------------------------------------------------------------------
# checkpoints, resume, the config reader, the CLI
# ---------------------------------------------------------------------------


class _Log:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(("info", msg))

    def warning(self, msg):
        self.lines.append(("warning", msg))


def test_latest_epoch_checkpoint_matches_cor_tpu(tmp_path):
    assert pckpt.latest_epoch_checkpoint(tmp_path / "none") is None
    cases = [["checkpoint_epoch_5", "checkpoint_epoch_10"],
             ["checkpoint_epoch_5", "interrupted_checkpoint_epoch_7"],
             ["checkpoint_epoch_6", "interrupted_checkpoint_epoch_7"],
             ["interrupted_checkpoint_epoch_3", "checkpoint_epoch_bad", "best_model"]]
    for i, names in enumerate(cases):
        d = tmp_path / str(i)
        for n in names:
            (d / n).mkdir(parents=True)
        (d / "checkpoint_epoch_99").touch()  # a file, not a checkpoint
        assert pckpt.latest_epoch_checkpoint(d) == jckpt.latest_epoch_checkpoint(d)
    assert pckpt.latest_epoch_checkpoint(tmp_path / "1") == "interrupted_checkpoint_epoch_7"


def test_resolve_resume_rules(tmp_path):
    """Periodic (next epoch), interrupted (the same epoch), best-tracker state
    carried, an explicit path that is missing, an unreadable auto-resume."""
    jc, pc = configs(True)
    model = pcore.init_core_model(pc, 0)
    opt, _ = poptim.make_optimizer(model, "AdamW", lr=LR)
    state = TrainState(model, opt, step=4)
    payload = dict(params=model.state_dict(), opt_state=opt.state_dict(), step=4, epoch=3,
                   best_score=1.25, best_epoch=2, loss=0.5)
    cfg = TrainConfig(train_model_save_path=str(tmp_path))
    pckpt.save_checkpoint(tmp_path, "checkpoint_epoch_3", payload)
    fresh = TrainState(pcore.init_core_model(pc, 1), poptim.make_optimizer(
        pcore.init_core_model(pc, 1), "AdamW")[0])
    got, start, best = pckpt.resolve_resume(cfg, fresh, _Log())
    assert (start, best, got.step) == (4, {"best_score": 1.25, "best_epoch": 2}, 4)
    for (n, a), b in zip(got.model.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), n
    pckpt.save_checkpoint(tmp_path, "interrupted_checkpoint_epoch_4", dict(payload, epoch=4))
    assert pckpt.resolve_resume(cfg, state, _Log())[1] == 4
    with pytest.raises(FileNotFoundError, match="not_there"):
        pckpt.resolve_resume(dataclasses.replace(cfg, load_checkpoint_path="not_there"), state,
                             _Log())
    (tmp_path / "checkpoint_epoch_9").mkdir()  # no state.pt: unreadable
    log = _Log()
    assert pckpt.resolve_resume(cfg, state, log)[1:] == (1, None)
    assert log.lines[-1][0] == "warning" and "RESTARTS FROM SCRATCH" in log.lines[-1][1]
    with pytest.raises(RuntimeError, match="could not be restored"):
        pckpt.resolve_resume(dataclasses.replace(cfg, load_checkpoint_path="checkpoint_epoch_9"),
                             state, _Log())


def test_train_config_mirrors_cor_tpu():
    """TrainConfig field for field with cor_tpu's defaults; encoder_remat
    reaches the encoder config."""
    from cor_tpu.config import TrainConfig as JTrainConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
    for remat in (True, False):
        got = TrainConfig(encoder_remat=remat, freeze_towers=False).core_config()
        want = JTrainConfig(encoder_remat=remat, freeze_towers=False).core_config()
        assert got.encoder.remat_blocks is want.encoder.remat_blocks is remat
        assert (got.freeze_towers, got.compute_dtype) == (want.freeze_towers, want.compute_dtype)
    assert TrainConfig().core_config().encoder.remat_blocks


def test_flat_yaml_reader_matches_pyyaml(tmp_path):
    import yaml

    for name in ("train_config_m3.yaml", "vaild_config.yaml"):
        text = (Path(__file__).resolve().parents[1] / "configs" / name).read_text()
        assert read_flat_yaml(text) == yaml.safe_load(text), name
    odd = "a: 1.0e-4\nb: 1e-4\nc: 'x # y'  # z\nd: ~\ne: true\nf: -3\ng: \"None\"\n"
    assert read_flat_yaml(odd) == yaml.safe_load(odd)
    with pytest.raises(ValueError, match="key: value"):
        read_flat_yaml("a:\n  - 1\n")
    cfg = tmp_path / "c.yaml"
    cfg.write_text("epoch: 2\nbogus_key: 1\n")
    with pytest.raises(ValueError, match="bogus_key"):
        load_train_config(cfg)


@pytest.fixture
def tiny_train(monkeypatch, tmp_path):
    """cli.train's model keys -> the unfrozen kernel-active tiny config."""
    _, pc = configs(False)
    monkeypatch.setattr(TrainConfig, "core_config",
                        lambda self: dataclasses.replace(pc, freeze_towers=self.freeze_towers))
    cfg = tmp_path / "train.yaml"
    cfg.write_text(f"epoch: 1\nbatch_size: 2\nnum_workers: 2\nfreeze_towers: false\n"
                   f"train_model_save_epoch: 1\ntrain_model_save_path: {tmp_path / 'ck'}\n")
    return cfg


def test_cli_train_runs_an_epoch_and_resumes_on_the_cpu(tiny_train, tmp_path):
    trainer = pcli.main(["--config", str(tiny_train), "--synthetic", "--device", "cpu"])
    ck = tmp_path / "ck"
    assert trainer.state.step == 4 and trainer.best.best_epoch == 1
    assert set(trainer.best.best_metrics) == {"dice", "mae", "iou", "mdice", "miou"}
    for name in ("best_model", "best_model_full", "checkpoint_epoch_1"):
        assert (ck / name / "state.pt").is_file(), name
    assert set(pckpt.restore_checkpoint(ck, "best_model")) == {"params"}
    assert pckpt.restore_checkpoint(ck, "best_model_full")["step"] == 4
    assert list((ck / "tb").glob("events.out.tfevents.*"))
    tiny_train.write_text(tiny_train.read_text().replace("epoch: 1", "epoch: 2"))
    again = pcli.main(["--config", str(tiny_train), "--synthetic", "--device", "cpu"])
    assert again.state.step == 8  # epoch 2 only: resumed from checkpoint_epoch_1
    log = "\n".join(p.read_text() for p in (ck / "logs").glob("*.log"))
    assert "Resumed from checkpoint_epoch_1 at epoch 2" in log


@pytest.mark.parametrize("case", ["manifest", "checkpoint", "mesh", "async", "no_card",
                                  "fp32_on_the_card", "fp32_frozen_on_the_card",
                                  "fp16_on_the_card"])
def test_cli_train_refuses(tiny_train, capsys, monkeypatch, case):
    argv = ["--config", str(tiny_train), "--synthetic"]
    want = "--device cpu"
    extra = {"checkpoint": "load_sam_pretrained_checkpoint: /ckpt/sam.pth\n",
             "mesh": "mesh_data: 2\n", "async": "async_checkpoint: true\n"}.get(case)
    if case == "manifest":
        argv, want = argv[:2], "item 10"
    elif extra:
        tiny_train.write_text(tiny_train.read_text() + extra)
        want = {"checkpoint": "item 5", "mesh": "item 9", "async": "item 11"}[case]
    else:
        # without a card: fp16 (no kernels) is refused first, naming its
        # ROADMAP row, before the card is looked for; bf16, and tiny_train's
        # fp32 model with unfrozen towers or frozen, get as far as looking
        # for the card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        fp32 = TrainConfig.core_config
        if case == "fp32_on_the_card":
            want = "no CUDA card is available"
        elif case == "fp32_frozen_on_the_card":
            tiny_train.write_text(tiny_train.read_text().replace("freeze_towers: false",
                                                                 "freeze_towers: true"))
            want = "no CUDA card is available"
        else:
            dt = "bfloat16" if case == "no_card" else "float16"
            want = "no CUDA card is available" if case == "no_card" else "ROADMAP Queue 2, @fp16"
            monkeypatch.setattr(TrainConfig, "core_config", lambda self: dataclasses.replace(
                fp32(self), compute_dtype=dt))
    with pytest.raises(SystemExit) as e:
        pcli.main(argv + (["--device", "cpu"] if case in ("manifest", "checkpoint", "mesh",
                                                          "async") else []))
    assert e.value.code == 2
    assert want in capsys.readouterr().err


def test_trainer_takes_fp32_and_refuses_fp16_on_the_card():
    """The Trainer takes fp32 training on the card with unfrozen towers (K6b
    takes fp32) and with frozen ones, and refuses fp16 (no kernels: ROADMAP
    Queue 2's @fp16 row) before it builds its steps; it takes any of them on
    the CPU."""
    from cor_tpu_torch.train.trainer import Trainer

    _, pc = configs(False)
    assert pc.compute_dtype == "float32" and not pc.freeze_towers
    assert Trainer(TrainConfig(), pc, None, lambda e: LR, None, "cuda").device.type == "cuda"
    with pytest.raises(ValueError, match="ROADMAP Queue 2, @fp16"):
        Trainer(TrainConfig(), dataclasses.replace(pc, compute_dtype="float16", freeze_towers=True),
                None, lambda e: LR, None, "cuda")
    frozen = dataclasses.replace(pc, freeze_towers=True)
    assert Trainer(TrainConfig(), frozen, None, lambda e: LR, None, "cuda").device.type == "cuda"
    assert Trainer(TrainConfig(), pc, None, lambda e: LR, None, "cpu").device.type == "cpu"


def test_weight_bridge_round_trips_a_training_tree():
    """A cor_tpu tree loads as fp32 masters (the PE buffer too) and comes back
    unchanged (that cor_tpu's own init tree loads: test_torch_encoder.py)."""
    _, pc = configs(False)
    tree = tree_for(pc, 1)
    model = port_model(pc, tree)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    back = flatten_tree(to_cor_tpu_tree(model))
    want = flatten_tree(tree)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert json.dumps(sorted(back)) == json.dumps(sorted(want))
