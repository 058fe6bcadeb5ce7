"""The port's training from files against cor_tpu's (and Pillow's), on the
CPU.

- The ``preproc`` library's colour jitter equals Pillow's ``ImageEnhance``
  chain and ``cor_tpu.native.color_enhance_u8``, and its rotation equals
  Pillow's ``rotate(BICUBIC)``, bit for bit: RGB and L images, odd and even
  sizes, every angle the augmentation draws (-15..14).
- ``train_augment`` (the port's, on numpy arrays) equals cor_tpu's (on
  Pillow images) sample for sample and leaves its generator in the same
  state; ``CORDataset(train=True)``'s samples equal cor_tpu's over epochs 0
  and 1; ``get_train_loader``'s shuffled batches and the dataset's epoch
  equal cor_tpu's.
- ``CheckpointWriter``: an async save holds the values taken before an
  in-place update, saves are serialised, and an error in the writer thread
  surfaces on the next ``wait`` (and ``save``).
- ``cli.train`` on a manifest (``async_checkpoint: true``) takes cor_tpu's
  ``cli.train`` losses on the same tree, weights and seed within
  tests/test_torch_train.py's tolerance (rtol 1e-4), and its validation
  over manifest batches gives cor_tpu's metrics; a second run resumes.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance

from cor_tpu_torch.data import augment as paug
from cor_tpu_torch.data import pipeline as ppipe
from cor_tpu_torch.native import preproc as pnat
from cor_tpu_torch.train import checkpoint as pckpt

LOSS_RTOL = 1e-4  # tests/test_torch_train.py's three-step losses
LOG = logging.getLogger("test_torch_train_data")


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_train_data.py: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the preproc library's colour jitter and rotation
# ---------------------------------------------------------------------------


def pillow_enhance(img: np.ndarray, fb, fc, fcol, fs) -> np.ndarray:
    im = Image.fromarray(img, "RGB")
    im = ImageEnhance.Brightness(im).enhance(fb)
    im = ImageEnhance.Contrast(im).enhance(fc)
    im = ImageEnhance.Color(im).enhance(fcol)
    return np.asarray(ImageEnhance.Sharpness(im).enhance(fs))


@pytest.mark.parametrize("hw", [(13, 17), (2, 2), (64, 47)])
def test_color_enhance_equals_pillow_and_cor_tpu(hw):
    from cor_tpu.native import color_enhance_u8 as j_enhance

    rng = np.random.default_rng(hw[1])
    img = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
    draws = [(int(rng.integers(5, 16)) / 10, int(rng.integers(5, 16)) / 10,
              int(rng.integers(0, 21)) / 10, int(rng.integers(0, 31)) / 10) for _ in range(8)]
    for f in draws + [(0.5, 1.5, 0.0, 3.0), (1.0, 1.0, 1.0, 1.0), (1.5, 0.5, 2.0, 0.0)]:
        got = pnat.color_enhance_u8(img, *f)
        np.testing.assert_array_equal(got, pillow_enhance(img, *f), err_msg=str(f))
        np.testing.assert_array_equal(got, j_enhance(img, *f), err_msg=str(f))


@pytest.mark.parametrize("mode,hw", [("RGB", (13, 17)), ("RGB", (16, 24)), ("L", (15, 15)),
                                     ("L", (12, 21))])
def test_rotation_equals_pillow_at_every_angle(mode, hw):
    """Every angle random_rotation draws, bit for bit (no pixel differs)."""
    rng = np.random.default_rng(hw[0] * hw[1])
    shape = (*hw, 3) if mode == "RGB" else hw
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    pil = Image.fromarray(img, mode)
    for angle in range(-15, 15):
        want = np.asarray(pil.rotate(angle, Image.BICUBIC))
        np.testing.assert_array_equal(pnat.rotate_bicubic_u8(img, angle), want,
                                      err_msg=f"{mode} {hw} {angle}")


def test_rotation_copies_at_zero_and_refuses_the_rest():
    img = np.arange(60, dtype=np.uint8).reshape(4, 5, 3)
    for angle in (0, 360, -360):
        out = pnat.rotate_bicubic_u8(img, angle)
        assert out is not img and np.array_equal(out, img)
    for bad in (np.zeros((4, 5, 2), np.uint8), np.zeros((4, 5), np.float32),
                np.zeros((0, 5), np.uint8)):
        with pytest.raises(ValueError, match="rotate_bicubic_u8"):
            pnat.rotate_bicubic_u8(bad, 3)
    with pytest.raises(ValueError, match="transposes"):
        pnat.rotate_bicubic_u8(img, 90)
    with pytest.raises(ValueError, match="color_enhance_u8"):
        pnat.color_enhance_u8(np.zeros((4, 5), np.uint8), 1, 1, 1, 1)


# ---------------------------------------------------------------------------
# the augmentation and the training dataset
# ---------------------------------------------------------------------------


def test_train_augment_equals_cor_tpu():
    """The chain on arrays against cor_tpu's on Pillow images, seed by seed:
    the same image and mask and the same generator state after; both
    branches of the rotation; and random_gaussian (not in the chain)."""
    from cor_tpu.data import augment as jaug

    rng = np.random.default_rng(0)
    rotated = 0
    for seed in range(24):
        h, w = int(rng.integers(40, 80)), int(rng.integers(40, 80))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        gt = ((rng.random((h, w)) > 0.6) * 255).astype(np.uint8)
        r_port, r_ref = np.random.default_rng((seed, 1)), np.random.default_rng((seed, 1))
        probe = np.random.default_rng((seed, 1))
        probe.integers(w - 30, w), probe.integers(h - 30, h)
        rotated += probe.random() > 0.8
        got_img, got_gt = paug.train_augment(img, gt, r_port)
        want_img, want_gt = jaug.train_augment(Image.fromarray(img, "RGB"),
                                               Image.fromarray(gt, "L"), r_ref)
        np.testing.assert_array_equal(got_img, np.asarray(want_img), err_msg=str(seed))
        np.testing.assert_array_equal(got_gt, np.asarray(want_gt), err_msg=str(seed))
        assert r_port.random() == r_ref.random()
    assert 0 < rotated < 24, rotated
    g1, g2 = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(paug.random_gaussian(img, g1),
                                  np.asarray(jaug.random_gaussian(Image.fromarray(img), g2)))


# Id, Compose, Dataset, Target, Query_img, Query_mask, Support_img,
# Support_mask, Text; the native (h, w) of each query
TRAIN_ROWS = [
    (1, 0, "coco", "007", "q1.png", "qm1.png", "s1.png", "sm1.png", "a red car", (48, 64)),
    (2, 0, "coco", "007", "q2.png", "qm2.png", "s2.png", "sm2.png", "", (64, 64)),
    (3, 1, "coco", "12", "q3.png", "qm3.png", "s3.png", "sm3.png", "dropped", (50, 50)),
    (4, 0, "lvis", "12", "q4.png", "qm4.png", "s4.png", "sm4.png", "a cat", (72, 48)),
    (5, 0, "lvis", "3", "q5.png", "qm5.png", "s5.png", "sm5.png", "the dog", (45, 81)),
    (6, 0, "lvis", "3", "q6.png", "qm6.png", "s6.png", "sm6.png", "NA", (70, 52)),
]
MASK_KIND = {"qm2.png": "RGB", "qm4.png": "P"}  # every other mask is gray
SIZES = dict(query_img_size=64, support_img_size=32, context_length=8)


def write_train_set(root: Path, rows, name: str, rng) -> Path:
    for (pid, _, ds, target, qi, qm, si, sm, _, (h, w)) in rows:
        base = root / ds
        for d in (base / "image", base / "mask" / str(int(target)), base / "mask" / "sup"):
            d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(base / "image" / qi)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = (((yy - h * rng.uniform(0.3, 0.7)) ** 2 + (xx - w * rng.uniform(0.3, 0.7)) ** 2)
                < (0.3 * min(h, w)) ** 2).astype(np.uint8) * 255
        mask = Image.fromarray(blob, "L")
        kind = MASK_KIND.get(qm)
        (mask.convert(kind) if kind else mask).save(base / "mask" / str(int(target)) / qm)
        s = 30 + pid
        Image.fromarray(rng.integers(0, 256, (s, s + 3, 3), dtype=np.uint8)).save(
            base / "image" / si)
        Image.fromarray((rng.random((s, s)) > 0.5).astype(np.uint8) * 255, "L").save(
            base / "mask" / "sup" / sm)
    path = root / name
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["Id", "Compose", "Dataset", "Target", "Query_img", "Query_mask",
                     "Support_img", "Support_mask", "Text"])
        wr.writerows(r[:9] for r in rows)
    return path


@pytest.fixture(scope="module")
def train_set(tmp_path_factory):
    """A training split (5 triplets with Compose 0) and a validation split
    (2) of PNGs under one root."""
    root = tmp_path_factory.mktemp("cor_train")
    rng = np.random.default_rng(0)
    train = write_train_set(root, TRAIN_ROWS, "Train.csv", rng)
    val_rows = [(10 + i, 0, "coco", "9", f"vq{i}.png", f"vqm{i}.png", f"vs{i}.png",
                 f"vsm{i}.png", f"val text {i}", hw) for i, hw in enumerate([(40, 56), (66, 50)])]
    val = write_train_set(root, val_rows, "Val.csv", rng)
    return root, train, val


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), k


def test_train_dataset_equals_cor_tpu(train_set):
    """Every sample of CORDataset(train=True), key for key and bit for bit,
    over epochs 0 and 1: the augmentation draws from (seed, epoch, idx), so
    the epochs differ; native_hw is the mask's size before the crop."""
    from cor_tpu.data.pipeline import CORDataset as JDataset

    root, train, _ = train_set
    ours = ppipe.CORDataset(str(train), str(root), train=True, seed=7, **SIZES)
    theirs = JDataset(str(train), str(root), train=True, seed=7, **SIZES)
    assert len(ours) == len(theirs) == 5
    native = [r[-1] for r in TRAIN_ROWS if r[1] == 0]
    by_epoch = []
    for epoch in (0, 1):
        ours.epoch = theirs.epoch = epoch
        samples = [ours[i] for i in range(len(ours))]
        for i, s in enumerate(samples):
            assert_samples_equal(s, theirs[i])
            assert tuple(s["native_hw"]) == native[i]
        by_epoch.append(samples)
    assert not np.array_equal(by_epoch[0][0]["query_img"], by_epoch[1][0]["query_img"])
    plain = ppipe.CORDataset(str(train), str(root), **SIZES)[0]
    assert not np.array_equal(plain["query_img"], by_epoch[0][0]["query_img"])
    np.testing.assert_array_equal(plain["support_img"], by_epoch[0][0]["support_img"])


def test_train_loader_order_and_epoch_equal_cor_tpu(train_set):
    """get_train_loader of both packages on one config: the same shuffled
    batches (pair ids and pixels; the short last batch dropped) epoch by
    epoch, the dataset's epoch set to the loader's at each pass, and
    set_epoch pinning a resumed run's order."""
    from cor_tpu.data.pipeline import get_train_loader as j_loader

    root, train, _ = train_set
    cfg = types.SimpleNamespace(train_csv=str(train), dataset_path=str(root), seed=3,
                                batch_size=2, num_workers=2, tokenizer_path=None)
    ours, theirs = ppipe.get_train_loader(cfg), j_loader(cfg)
    assert len(ours) == len(theirs) == 2
    for epoch in range(3):
        if epoch == 2:
            ours.set_epoch(5)
            theirs.set_epoch(5)
        got, want = list(ours), list(theirs)
        assert ours.dataset.epoch == theirs.dataset.epoch == (5 if epoch == 2 else epoch)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert list(g["pair_id"]) == list(w["pair_id"])
            for k in ("query_img", "query_mask", "text", "native_hw"):
                assert np.array_equal(g[k], w[k]), (epoch, k)


# ---------------------------------------------------------------------------
# the async checkpoint writer
# ---------------------------------------------------------------------------


def small_state():
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    return model, opt


def test_async_save_holds_the_values_before_an_in_place_update(tmp_path, monkeypatch):
    """The write is held back until training has changed the parameters
    and the optimizer's moments in place: the checkpoint holds the values
    at the save."""
    model, opt = small_state()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moment = opt.state_dict()["state"][0]["exp_avg"].clone()
    go = threading.Event()
    real = pckpt.save_checkpoint

    def held(*a, **kw):
        go.wait(10)
        return real(*a, **kw)

    monkeypatch.setattr(pckpt, "save_checkpoint", held)
    writer = pckpt.CheckpointWriter(async_save=True)
    path = writer.save(tmp_path, "ck", {"params": model.state_dict(),
                                        "opt_state": opt.state_dict(), "step": 1})
    assert not path.exists()  # the write is still held
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    model(torch.randn(2, 4)).sum().backward()
    opt.step()
    go.set()
    writer.wait()
    restored = pckpt.restore_checkpoint(tmp_path, "ck")
    for k, v in before.items():
        assert torch.equal(restored["params"][k], v), k
    assert torch.equal(restored["opt_state"]["state"][0]["exp_avg"], moment)
    assert not torch.equal(opt.state_dict()["state"][0]["exp_avg"], moment)
    assert restored["step"] == 1


def test_async_saves_are_serialised(tmp_path, monkeypatch):
    """A second save waits for the first write, so the writes never overlap
    and both land."""
    spans = []
    real = pckpt.save_checkpoint

    def slow(directory, name, payload):
        t0 = time.perf_counter()
        time.sleep(0.2)
        out = real(directory, name, payload)
        spans.append((name, t0, time.perf_counter()))
        return out

    monkeypatch.setattr(pckpt, "save_checkpoint", slow)
    writer = pckpt.CheckpointWriter(async_save=True)
    writer.save(tmp_path, "a", {"v": torch.ones(3)})
    writer.save(tmp_path, "a", {"v": torch.full((3,), 2.0)})  # the same name: replaced in turn
    returned = time.perf_counter()
    writer.save(tmp_path, "b", {"v": torch.zeros(3)})
    writer.wait()
    assert [s[0] for s in spans] == ["a", "a", "b"]
    assert spans[0][2] <= spans[1][1] and spans[1][2] <= spans[2][1]
    assert returned >= spans[0][2]  # the second save returned after the first write ended
    assert torch.equal(pckpt.restore_checkpoint(tmp_path, "a")["v"], torch.full((3,), 2.0))
    assert torch.equal(pckpt.restore_checkpoint(tmp_path, "b")["v"], torch.zeros(3))


def test_async_write_error_surfaces_on_wait(tmp_path, monkeypatch):
    def broken(directory, name, payload):
        raise OSError("No space left on device")

    monkeypatch.setattr(pckpt, "save_checkpoint", broken)
    writer = pckpt.CheckpointWriter(async_save=True)
    writer.save(tmp_path, "ck", {"v": torch.ones(2)})
    with pytest.raises(RuntimeError, match="No space left") as e:
        writer.wait()
    assert isinstance(e.value.__cause__, OSError)
    writer.wait()  # raised once, then drained
    writer.save(tmp_path, "ck", {"v": torch.ones(2)})
    with pytest.raises(RuntimeError, match="background write"):
        writer.save(tmp_path, "ck2", {"v": torch.ones(2)})  # the next save raises it too


# ---------------------------------------------------------------------------
# the slice: cli.train on a manifest against cor_tpu's cli.train
# ---------------------------------------------------------------------------


class NullWriter:
    def __init__(self, *a, **kw):
        pass

    def add_scalar(self, *a, **kw):
        pass

    def flush(self):
        pass

    def close(self):
        pass


def test_cli_train_on_a_manifest_matches_cor_tpu(train_set, tmp_path, monkeypatch):
    """Both packages' cli.train on the same PNG tree and config (epoch 1,
    batch 2: two steps over the shuffled, augmented training split, then
    validation over the manifest's batches), from the same weights (the
    port's seeded init, carried to cor_tpu by the weight bridge), in
    tests/test_torch_train.py's deterministic frozen tiny config. The
    port's losses are cor_tpu's within rtol 1e-4, its validation metrics
    too; it saved through the async writer and a second run resumes."""
    import jax
    import jax.numpy as jnp

    import cor_tpu.cli.train as jcli
    import cor_tpu.config as jconfig
    import cor_tpu.data.pipeline as jpipe
    import cor_tpu.models.core_model as jcore
    import cor_tpu.train.trainer as jtrainer
    import cor_tpu.utils.observability as jobs
    from cor_tpu.data.tokenizer import get_tokenizer
    from cor_tpu.parallel import make_mesh
    from cor_tpu_torch.cli import train as pcli
    from cor_tpu_torch.config import TrainConfig
    from cor_tpu_torch.models import core_model as pcore
    from cor_tpu_torch.train import trainer as ptrainer
    from cor_tpu_torch.utils.weights import to_cor_tpu_tree
    from tests.test_torch_train import configs

    root, train, val = train_set
    jc, pc = configs(True)
    cfg = tmp_path / "train.yaml"
    cfg.write_text(f"epoch: 1\nbatch_size: 2\nnum_workers: 2\nseed: 11\nlr: 0.001\n"
                   f"freeze_towers: true\n"
                   f"dataset_path: {root}\ntrain_csv: {train}\nval_csv: {val}\n"
                   f"train_model_save_epoch: 1\nasync_checkpoint: true\n"
                   f"train_model_save_path: {tmp_path / 'port'}\n")
    jcfg = tmp_path / "jtrain.yaml"
    jcfg.write_text(cfg.read_text().replace(str(tmp_path / "port"), str(tmp_path / "ref")))

    def recorder(module, log):
        real = module.make_train_step

        def make(*a, **kw):
            step = real(*a, **kw)

            def recorded(*sa, **skw):
                out = step(*sa, **skw)
                if isinstance(out, tuple):  # cor_tpu: (state, metrics)
                    log.append(float(out[1]["total_loss"]))
                else:
                    log.append(float(out["total_loss"]))
                return out
            return recorded
        monkeypatch.setattr(module, "make_train_step", make)

    def val_recorder(cls, log):
        real = cls.val_epoch

        def val_epoch(self, loader, epoch):
            metrics = real(self, loader, epoch)
            log.append({k: float(v) for k, v in metrics.items()})
            return metrics
        monkeypatch.setattr(cls, "val_epoch", val_epoch)

    p_loss, j_loss, p_val, j_val = [], [], [], []
    recorder(ptrainer, p_loss)
    recorder(jtrainer, j_loss)
    val_recorder(ptrainer.Trainer, p_val)
    val_recorder(jtrainer.Trainer, j_val)

    # the port: the tiny config under the train config's keys
    monkeypatch.setattr(TrainConfig, "core_config",
                        lambda self: dataclasses.replace(pc, freeze_towers=self.freeze_towers))
    trainer = pcli.main(["--config", str(cfg), "--device", "cpu"])

    # cor_tpu: the same config, the port's seeded weights, samples at the
    # tiny model's sizes (its hash tokenizer at the tiny vocabulary), one device
    tree = to_cor_tpu_tree(pcore.init_core_model(pc, 11))

    class JDataset(jpipe.CORDataset):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, **SIZES})
            self.tokenizer = get_tokenizer(None, 8, 64)

    monkeypatch.setattr(jconfig.TrainConfig, "core_config",
                        lambda self: dataclasses.replace(jc, freeze_towers=self.freeze_towers))
    monkeypatch.setattr(jcore, "init_core_model",
                        lambda key, c: jax.tree.map(jnp.asarray, tree))
    monkeypatch.setattr(jpipe, "CORDataset", JDataset)
    monkeypatch.setattr(jtrainer, "make_mesh", lambda **kw: make_mesh(jax.devices()[:1]))
    # its scalars are not compared, and its writer imports tensorflow (~20 s)
    monkeypatch.setattr(jobs, "SummaryWriter", NullWriter)
    jcli.main(["--config", str(jcfg)])

    assert len(p_loss) == len(j_loss) == 2 and trainer.state.step == 2
    np.testing.assert_allclose(p_loss, j_loss, rtol=LOSS_RTOL)
    assert len(p_val) == len(j_val) == 1
    for k, v in j_val[0].items():
        np.testing.assert_allclose(p_val[0][k], v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    ck = tmp_path / "port"
    for name in ("checkpoint_epoch_1", "best_model", "best_model_full"):
        assert (ck / name / "state.pt").is_file(), name
    assert trainer.ckpt.async_save and set(trainer.save_seconds) == {
        "checkpoint_epoch_1", "best_model", "best_model_full"}
    cfg.write_text(cfg.read_text().replace("epoch: 1\n", "epoch: 2\n"))
    again = pcli.main(["--config", str(cfg), "--device", "cpu"])
    assert again.state.step == 4
    log = "\n".join(p.read_text() for p in (ck / "logs").glob("*.log"))
    assert "Resumed from checkpoint_epoch_1 at epoch 2" in log
