"""The port's evaluation from files against cor_tpu's (and Pillow's and
OpenCV's), on the CPU.

- The PNG reader: equal to Pillow's ``convert("RGB")`` and ``convert("L")``
  on files Pillow writes in L, LA, RGB, RGBA, P (8 and 4 bits) and 1, and
  on files written with each filter type 0-4 forced, through the
  ``preproc`` library's unfilter and the plain Python one; interlaced and
  16-bit files refused by name; JPEG through Pillow where it is installed
  and refused without it.
- The ``preproc`` library: equal, bit for bit, to
  ``cor_tpu.native.resize_normalize_f32`` and to Pillow's
  ``resize(BILINEAR)``, up and down, odd sizes, 1 and 3 channels.
- ``CORDataset``: samples equal to cor_tpu's on a small on-disk PNG
  dataset (every key, the images bit for bit, the same token ids), with a
  zero-padded ``Target``, an empty ``Text``, a ``Compose = 1`` row, a
  ``"NA"`` text, ``capitalized_dirs`` and ``limit``.
- The validator: fixed probabilities through both ``run_eval_split``s:
  masks pixel-equal except where the resized value lies within 1e-6 of 0.5
  (hard) or its x255 within 255e-6 of an integer (soft: the truncation's
  edge), CSV rows equal (metadata as text, metrics within 1e-6), the resize
  within 1e-6 of cv2's; a bad sample skipped and counted; ``val_metric``
  and ``save_{hard,soft}_pred_masks`` as ``run_eval_split``; the comparison
  panels (``visualize_n``) cor_tpu's canvases, pixel for pixel above the
  caption band, which holds the port's own bitmap text.
- The slice: cor_tpu's ``make_predict_step`` + ``run_eval_split`` against
  the port's ``cli.eval --visualize 2`` on the tiny model (tests/helpers.py)
  in fp32 with weights from one ``.pth``: summary metrics within 1e-3
  (``SUMMARY_TOL``), hard masks and the panels' prediction with IoU >= 0.99
  (``MASK_IOU_MIN``), the panels' other pixels above the caption equal.
- ``cli.index`` and ``cli.retrieve`` on a manifest and a ``.pth``: the
  index's rows within 1e-6 of cor_tpu's build over its ``CORDataset``
  (tests/test_torch_encoder.py's tolerance), its recalls cor_tpu's
  protocol's.
- Serving's file requests: read as cor_tpu's server reads them, bit for
  bit.
"""

from __future__ import annotations

import csv
import io
import json
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cor_tpu_torch.config import EvalConfig
from cor_tpu_torch.data import pipeline as ppipe
from cor_tpu_torch.eval import validator as pval
from cor_tpu_torch.eval import visualize as pvis
from cor_tpu_torch.native import preproc as pnat
from cor_tpu_torch.utils import png as ppng
from tests.test_torch_retrieve import port_config

SUMMARY_TOL = 1e-3  # the slice's metric means, cor_tpu against the port (fp32)
MASK_IOU_MIN = 0.99  # the slice's hard masks, file by file
META_TOL = 1e-6  # the validator's metrics on the same probabilities
LOG = logging.getLogger("test_torch_eval")


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_eval.py: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the PNG reader
# ---------------------------------------------------------------------------


def pil_png(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "PNG", **kw)
    return buf.getvalue()


def pil_convert(data: bytes, mode: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert(mode))


def pil_files(rng) -> dict:
    arr = lambda *s: rng.integers(0, 256, s, dtype=np.uint8)  # noqa: E731
    rgb = Image.fromarray(arr(37, 53, 3))
    return {
        "L": pil_png(Image.fromarray(arr(37, 53), "L")),
        "LA": pil_png(Image.fromarray(arr(37, 53, 2), "LA")),
        "RGB": pil_png(rgb),
        "RGBA": pil_png(Image.fromarray(arr(37, 53, 4), "RGBA")),
        "P": pil_png(rgb.convert("P", palette=Image.ADAPTIVE, colors=200)),
        "P4": pil_png(rgb.convert("P", palette=Image.ADAPTIVE, colors=12), bits=4),
        "1": pil_png(Image.fromarray(arr(37, 53) > 127)),
    }


@pytest.mark.parametrize("kind", ["L", "LA", "RGB", "RGBA", "P", "P4", "1"])
def test_png_reader_equals_pillow_on_pillows_files(kind):
    data = pil_files(np.random.default_rng(0))[kind]
    for mode in ("RGB", "L"):
        want = pil_convert(data, mode)
        np.testing.assert_array_equal(ppng.png_decode(data, mode), want)
        np.testing.assert_array_equal(ppng.png_decode(data, mode, ppng.png_unfilter_plain), want)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_reader_equals_pillow_with_each_filter_forced(filter_type):
    """Every scanline written with one filter type (gray, RGB, RGBA, and a
    palette image): the library's unfilter and the plain one give Pillow's
    pixels (and the image written)."""
    rng = np.random.default_rng(filter_type)
    for img in (rng.integers(0, 256, (29, 31), dtype=np.uint8),
                rng.integers(0, 256, (29, 31, 3), dtype=np.uint8),
                rng.integers(0, 256, (6, 1, 4), dtype=np.uint8)):
        data = ppng.png_encode(img, filter_type=filter_type)
        for mode in ("RGB", "L"):
            want = pil_convert(data, mode)
            np.testing.assert_array_equal(ppng.png_decode(data, mode), want)
            np.testing.assert_array_equal(ppng.png_decode(data, mode, ppng.png_unfilter_plain),
                                          want)
        if img.ndim == 3 and img.shape[2] == 3:
            np.testing.assert_array_equal(ppng.png_decode(data, "RGB"), img)
    palette = rng.integers(0, 256, (7, 3), dtype=np.uint8)
    data = ppng.png_encode(rng.integers(0, 7, (13, 9), dtype=np.uint8),
                           filter_type=filter_type, palette=palette)
    assert Image.open(io.BytesIO(data)).mode == "P"
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(ppng.png_decode(data, mode), pil_convert(data, mode))


def test_png_reader_refusals(tmp_path, monkeypatch):
    """Interlaced and 16-bit files are refused by name; a JPEG goes to
    Pillow, and without Pillow it is refused saying so."""
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="interlaced"):
        ppng.png_decode(interlace_flag(pil_png(img)), "RGB")
    sixteen = pil_png(Image.fromarray(rng.integers(0, 65535, (8, 8), dtype=np.uint16)))
    with pytest.raises(ValueError, match="16-bit"):
        ppng.png_decode(sixteen, "L")
    img.save(tmp_path / "x.jpg", "JPEG")
    np.testing.assert_array_equal(ppng.read_image(tmp_path / "x.jpg", "RGB"),
                                  np.asarray(Image.open(tmp_path / "x.jpg").convert("RGB")))
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match="JPEG needs Pillow"):
        ppng.read_image(tmp_path / "x.jpg", "RGB")


def interlace_flag(data: bytes) -> bytes:
    """A PNG with IHDR's interlace byte set and its CRC made again (Pillow
    writes no interlaced PNG)."""
    import struct
    import zlib

    i = data.index(b"IHDR")
    body = bytearray(data[i + 4:i + 17])
    body[12] = 1
    crc = struct.pack(">I", zlib.crc32(bytes(body), zlib.crc32(b"IHDR")) & 0xFFFFFFFF)
    return data[:i + 4] + bytes(body) + crc + data[i + 21:]


# ---------------------------------------------------------------------------
# the preproc library
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,out_hw", [
    ((37, 53, 3), (64, 64)), ((64, 64, 3), (32, 32)), ((101, 77, 3), (40, 91)),
    ((48, 40), (1024, 1024)), ((33, 17), (16, 9)), ((5, 1200, 3), (384, 384)),
])
def test_preproc_equals_cor_tpu_and_pillow(shape, out_hw):
    from cor_tpu.native import native_available, resize_normalize_f32

    assert native_available()
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    oh, ow = out_hw
    mean, std = ppipe.IMAGENET_MEAN[:img.ndim], ppipe.IMAGENET_STD[:img.ndim]
    if img.ndim == 2:
        mean, std = None, None
    got = pnat.resize_normalize_f32(img, oh, ow, mean, std)
    want = resize_normalize_f32(img, oh, ow, mean, std)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    pil = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(pnat.resize_bilinear_u8(img, oh, ow).reshape(pil.shape), pil)


def test_preproc_builds_once_under_concurrent_first_use(tmp_path, monkeypatch):
    """The loader's threads asking for the library at once, before it is
    built: one build, every thread gets the same library."""
    import concurrent.futures as cf

    monkeypatch.setattr(pnat, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnat, "_LIB", [])
    img = np.arange(48, dtype=np.uint8).reshape(4, 4, 3)
    with cf.ThreadPoolExecutor(8) as pool:
        outs = list(pool.map(lambda _: pnat.resize_bilinear_u8(img, 2, 3), range(8)))
    assert all(np.array_equal(o, outs[0]) for o in outs)
    assert [p.name for p in tmp_path.iterdir()] == [pnat.library_path().name]


def test_preproc_refuses_bad_inputs():
    with pytest.raises(ValueError, match="uint8"):
        pnat.resize_bilinear_u8(np.zeros((4, 4), np.float32), 2, 2)
    with pytest.raises(ValueError, match="positive"):
        pnat.resize_bilinear_u8(np.zeros((4, 4), np.uint8), 0, 2)
    with pytest.raises(ValueError, match="one value a channel"):
        pnat.resize_normalize_f32(np.zeros((4, 4, 3), np.uint8), 2, 2, np.zeros(2), np.ones(3))
    with pytest.raises(ValueError, match="filter type 7"):
        pnat.png_unfilter(bytes([7, 1, 2]), 1, 2, 1)


# ---------------------------------------------------------------------------
# the dataset
# ---------------------------------------------------------------------------

# Id, Compose, Dataset, Target, Query_img, Query_mask, Support_img,
# Support_mask, Text, query_cat; the native (h, w) of each query
ROWS = [
    (1, 0, "coco", "007", "q1.png", "qm1.png", "s1.png", "sm1.png", "a red car", "vehicle",
     (40, 56)),
    (2, 0, "coco", "007", "q2.png", "qm2.png", "s2.png", "sm2.png", "", "animal", (64, 64)),
    (3, 1, "coco", "12", "q3.png", "qm3.png", "s3.png", "sm3.png", "dropped", "x", (30, 50)),
    (4, 0, "lvis", "12", "q4.png", "qm4.png", "s4.png", "sm4.png", "NA", "", (72, 48)),
    (5, 0, "lvis", "3", "q5.png", "qm5.png", "s5.png", "sm5.png", "the dog, jumping!", "animal",
     (50, 30)),
]
MASK_KIND = {"qm2.png": "RGB", "qm4.png": "P"}  # every other mask is gray


def write_dataset(root: Path, rng, capitalized: bool = False) -> Path:
    """A manifest and its PNGs (Pillow-written images and masks, one RGB and
    one palette query mask); returns the CSV's path."""
    img_dir, mask_dir = ("Image", "Mask") if capitalized else ("image", "mask")
    for (pid, _, ds, target, qi, qm, si, sm, *_, (h, w)) in ROWS:
        base = root / ds
        for d in (base / img_dir, base / mask_dir / str(int(target)), base / mask_dir / "sup"):
            d.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(base / img_dir / qi)
        yy, xx = np.mgrid[0:h, 0:w]
        blob = (((yy - h * rng.uniform(0.3, 0.7)) ** 2 + (xx - w * rng.uniform(0.3, 0.7)) ** 2)
                < (0.3 * min(h, w)) ** 2).astype(np.uint8) * 255
        mask = Image.fromarray(blob, "L")
        kind = MASK_KIND.get(qm)
        mask = mask.convert(kind) if kind else mask
        mask.save(base / mask_dir / str(int(target)) / qm)
        s = 20 + pid
        Image.fromarray(rng.integers(0, 256, (s, s + 3, 3), dtype=np.uint8)).save(
            base / img_dir / si)
        Image.fromarray((rng.random((s, s)) > 0.5).astype(np.uint8) * 255, "L").save(
            base / mask_dir / "sup" / sm)
    path = root / "Test_1.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Id", "Compose", "Dataset", "Target", "Query_img", "Query_mask",
                    "Support_img", "Support_mask", "Text", "query_cat"])
        w.writerows(r[:10] for r in ROWS)
    return path


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cor_ds")
    return root, write_dataset(root, np.random.default_rng(0))


SIZES = dict(query_img_size=64, support_img_size=32, context_length=8)


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("case", ["plain", "capitalized", "limit"])
def test_cor_dataset_equals_cor_tpu(dataset, tmp_path, case):
    """Every sample key for key (the images bit for bit, the token ids) and
    the manifest's typed cells as pandas types them: Compose = 1 dropped,
    Target 007 read as 7 (its folder), an empty Text and "NA" as NaN."""
    from cor_tpu.data.pipeline import CORDataset as JDataset

    root, csv_path = dataset
    kw = dict(SIZES)
    if case == "capitalized":
        root = tmp_path
        csv_path = write_dataset(root, np.random.default_rng(0), capitalized=True)
        kw["capitalized_dirs"] = True
    if case == "limit":
        kw["limit"] = 2
    ours = ppipe.CORDataset(str(csv_path), str(root), **kw)
    theirs = JDataset(str(csv_path), str(root), **kw)
    assert len(ours) == len(theirs) == (2 if case == "limit" else 4)
    assert ours.df.columns == list(theirs.df.columns)
    for j, row in enumerate(ours.df.rows):
        for c in ours.df.columns:
            assert str(row[c]) == str(theirs.df.iloc[j][c]), (j, c)
    assert [r["Target"] for r in ours.df.rows][:2] == [7, 7]
    assert str(ours.df.rows[1]["Text"]) == "nan"
    for i in range(len(ours)):
        assert_samples_equal(ours[i], theirs[i])
    mask_dir = "Mask" if case == "capitalized" else "mask"
    assert ours[0]["query_mask_path"].endswith(str(Path("coco", mask_dir, "7", "qm1.png")))


def test_cor_dataset_refusals(dataset):
    root, csv_path = dataset
    for bad in (0, -1):
        with pytest.raises(ValueError, match="positive row count"):
            ppipe.CORDataset(str(csv_path), str(root), limit=bad)
    # train=True is taken (the augmentation: tests/test_torch_train_data.py)
    assert len(ppipe.CORDataset(str(csv_path), str(root), train=True)) == 4


# ---------------------------------------------------------------------------
# the validator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hw", [(40, 56), (8, 8), (100, 73), (16, 16)])
def test_resize_within_1e6_of_cv2(hw):
    import cv2

    x = np.random.default_rng(hw[0]).random((16, 16), dtype=np.float32)
    want = cv2.resize(x, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(pval.resize_bilinear_f32(x, hw), want, atol=1e-6, rtol=0)


class TinyModel(torch.nn.Module):
    """Stands for the model in ``predict_stream`` (it reads the device)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))


PANEL = 256  # the panels' side, cor_tpu's default target_size
PAD = 10


def assert_panels_match(ours, theirs, pred_iou_min=None):
    """The port's panel PNGs against cor_tpu's: the same names and canvas
    sizes, every pixel above the caption band equal (with ``pred_iou_min``
    the prediction panel is held by the IoU of its white pixels instead),
    and the caption band white but for the port's black text."""
    assert [p.name for p in ours] == [q.name for q in theirs]
    band = PANEL + 2 * PAD
    for p, q in zip(ours, theirs):
        got, want = ppng.read_image(p, "RGB").copy(), np.array(Image.open(q).convert("RGB"))
        assert got.shape == want.shape == (got.shape[0], 5 * PANEL + 6 * PAD, 3), p.name
        if pred_iou_min is None:
            np.testing.assert_array_equal(got[:band], want[:band], err_msg=p.name)
        else:
            x = PAD + 2 * (PANEL + PAD)  # the third panel: the prediction
            pred = np.s_[PAD:PAD + PANEL, x:x + PANEL]
            a, b = got[pred][..., 0] > 127, want[pred][..., 0] > 127
            assert (a & b).sum() / max((a | b).sum(), 1) >= pred_iou_min, p.name
            got[pred], want[pred] = 0, 0
            np.testing.assert_array_equal(got[:band], want[:band], err_msg=p.name)
        caption = got[band:]
        assert set(np.unique(caption)) == {0, 255} and (caption == 255).all(axis=2).mean() > 0.5


def read_csv_rows(path):
    with open(path, newline="") as f:
        r = csv.DictReader(f)
        return r.fieldnames, list(r)


def test_run_eval_split_matches_cor_tpu(dataset, tmp_path):
    """Fixed probabilities through both validators: the hard and soft masks
    (except at the thresholds' edges), the CSV (metadata text, metrics
    within 1e-6) and the means; a sample whose pair id is bad is skipped and
    counted, the rest written."""
    import cv2

    from cor_tpu.data.pipeline import load_manifest as j_manifest
    from cor_tpu.eval.validator import run_eval_split as j_run

    root, csv_path = dataset
    ds = ppipe.CORDataset(str(csv_path), str(root), **SIZES)
    batches = list(ppipe.DataLoader(ds, 3, num_workers=2))
    rng = np.random.default_rng(3)
    probs = [rng.random((len(b["pair_id"]), 16, 16, 1), dtype=np.float32) for b in batches]
    names = [str(v) for v in ds.df.column("Query_mask")]

    def fixed(to_tensor: bool):
        it = iter(probs)
        return lambda *_: torch.from_numpy(next(it)) if to_tensor else next(it)

    ours = pval.run_eval_split(fixed(True), TinyModel(), batches, tmp_path / "p", ds.df,
                               names, soft=True)
    theirs = j_run(fixed(False), None, batches, tmp_path / "j", j_manifest(csv_path), names,
                   soft=True)
    assert ours["skipped"] == 0 and len(ours["hard"]) == len(ours["soft"]) == 4
    assert [p.name for p in ours["hard"]] == [p.name for p in theirs["hard"]]
    k = 0
    for b, p in zip(batches, probs):
        for i in range(p.shape[0]):
            h, w = (int(v) for v in b["native_hw"][i])
            r = cv2.resize(p[i, :, :, 0], (w, h), interpolation=cv2.INTER_LINEAR)
            hard_ok = np.abs(r - 0.5) >= 1e-6
            v255 = r * 255.0
            soft_ok = np.abs(v255 - np.round(v255)) >= 255e-6
            for kind, ok, dirn in (("hard", hard_ok, "pred_masks"),
                                   ("soft", soft_ok, "soft_pred_masks")):
                name = ours[kind][k].name
                got = ppng.read_image(tmp_path / "p" / dirn / name, "L")
                want = np.asarray(Image.open(tmp_path / "j" / dirn / name))
                assert got.shape == want.shape == (h, w)
                np.testing.assert_array_equal(got[ok], want[ok], err_msg=f"{kind} {name}")
            k += 1
    (fo, ro), (ft, rt) = (read_csv_rows(tmp_path / d / "val_metric.csv") for d in ("p", "j"))
    assert fo == ft and len(ro) == len(rt) == 4
    for a, b in zip(ro, rt):
        for c in fo:
            if c in pval.METRIC_KEYS:
                assert abs(float(a[c]) - float(b[c])) <= META_TOL, (c, a[c], b[c])
            else:
                assert a[c] == b[c], (c, a[c], b[c])
    for m in pval.METRIC_KEYS:
        assert abs(ours["summary"][m] - theirs["summary"][m]) <= META_TOL
    # the single-consumer entries give what run_eval_split gave
    assert pval.val_metric(fixed(True), TinyModel(), batches, tmp_path / "vm.csv",
                           ds.df) == ours["summary"]
    assert read_csv_rows(tmp_path / "vm.csv") == (fo, ro)
    for save, sub in ((pval.save_hard_pred_masks, "pred_masks"),
                      (pval.save_soft_pred_masks, "soft_pred_masks")):
        paths = save(fixed(True), TinyModel(), batches, tmp_path / "s", mask_names=names)
        assert [p.name for p in paths] == [p.name for p in ours["hard"]]
        for p in paths:
            assert p.read_bytes() == (tmp_path / "p" / sub / p.name).read_bytes(), p.name
    bad = [dict(b) for b in batches]
    bad[0]["pair_id"] = np.array([None, *bad[0]["pair_id"][1:]], object)
    res = pval.run_eval_split(fixed(True), TinyModel(), bad, tmp_path / "b", ds.df, names)
    assert res["skipped"] == 1 and len(res["hard"]) == 3
    # the comparison panels of the first 3 samples: cor_tpu's canvases
    ours = pval.run_eval_split(fixed(True), TinyModel(), batches, tmp_path / "pv", ds.df, names,
                               visualize_n=3)
    theirs = j_run(fixed(False), None, batches, tmp_path / "jv", j_manifest(csv_path), names,
                   visualize_n=3)
    assert ours["skipped"] == 0 and len(ours["panels"]) == 3
    assert_panels_match(ours["panels"], theirs["panels"])
    # the panels alone (val_visual_for_compare): the same files
    alone = pvis.val_visual_for_compare(fixed(True), TinyModel(), batches, tmp_path / "va",
                                        manifest=ds.df, max_samples=3)
    assert [p.read_bytes() for p in alone] == [p.read_bytes() for p in ours["panels"]]


# ---------------------------------------------------------------------------
# the slice: cli.eval against cor_tpu's eval, and the CLIs on a manifest
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(dataset, tmp_path_factory):
    """A trained-CORE .pth of the port's seeded tiny model (cor_tpu's
    exporter) and an eval config naming it and the dataset's two splits."""
    from cor_tpu.utils.export import save_core_checkpoint
    from cor_tpu_torch.models import core_model as pcore
    from cor_tpu_torch.utils.weights import to_cor_tpu_tree

    root, csv_path = dataset
    d = tmp_path_factory.mktemp("trained")
    tree = to_cor_tpu_tree(pcore.init_core_model(port_config(), 11))
    save_core_checkpoint(str(d / "core.pth"), tree, epoch=1)
    split_b = d / "Test_2.csv"
    lines = Path(csv_path).read_text().splitlines()
    # the rows in another order (whole batches of 2: cor_tpu compiles one shape)
    split_b.write_text("\n".join([lines[0], lines[5], lines[4], lines[2], lines[1]]) + "\n")
    cfg = d / "eval.yaml"
    cfg.write_text(f"batch_size: 2\ndataset_path: {root}\nval_csv_A: {csv_path}\n"
                   f"val_csv_B: {split_b}\nvaild_model_save_path: {d / 'out'}\n"
                   f"load_checkpoint_path: {d / 'core.pth'}\ncompute_dtype: float32\n"
                   "num_workers: 2\n")
    return dict(root=root, pth=d / "core.pth", cfg=cfg, out=d / "out", tree=tree,
                splits={"Test_1": csv_path, "Test_2": split_b})


@pytest.fixture
def tiny_cli(monkeypatch):
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: port_config())


def j_dataset(csv_path, root, limit=None):
    """cor_tpu's CORDataset at the tiny model's sizes (its hash tokenizer
    at the tiny vocabulary)."""
    from cor_tpu.data.pipeline import CORDataset
    from cor_tpu.data.tokenizer import get_tokenizer

    ds = CORDataset(str(csv_path), str(root), limit=limit, **SIZES)
    ds.tokenizer = get_tokenizer(None, 8, 64)
    return ds


def test_cli_eval_matches_cor_tpu_eval(trained, tiny_cli, tmp_path):
    """cli.eval --soft on both splits (batches of 2) against
    cor_tpu's make_predict_step + run_eval_split on the same .pth."""
    import jax

    from cor_tpu.data.pipeline import DataLoader as JLoader
    from cor_tpu.eval.validator import run_eval_split as j_run
    from cor_tpu.train.step import make_predict_step
    from cor_tpu.utils.convert import load_trained_params as j_load
    from cor_tpu_torch.cli import eval as pcli_eval
    from tests.helpers import tiny_core_config

    results = pcli_eval.main(["--config", str(trained["cfg"]), "--soft", "--visualize", "2",
                              "--device", "cpu"])
    jc = tiny_core_config()
    params = jax.tree.map(np.asarray, j_load(trained["pth"], jc, None, LOG))
    predict = make_predict_step(jc)
    for split, csv_path in trained["splits"].items():
        ds = j_dataset(csv_path, trained["root"])
        want = j_run(predict, params, JLoader(ds, 2, num_workers=2), tmp_path / split,
                     manifest=ds.df, mask_names=list(ds.df["Query_mask"].astype(str)), soft=True,
                     visualize_n=2)
        got = results[split]
        assert len(got["panels"]) == 2
        assert all(p.parent == trained["out"] / split / "visualizations" for p in got["panels"])
        assert_panels_match(got["panels"], want["panels"], pred_iou_min=MASK_IOU_MIN)
        assert got["skipped"] == 0 and len(got["hard"]) == len(got["soft"]) == len(ds)
        for m in pval.METRIC_KEYS:
            assert abs(got["summary"][m] - want["summary"][m]) <= SUMMARY_TOL, (split, m)
        for p, q in zip(got["hard"], want["hard"]):
            assert p.name == q.name and p.parent == trained["out"] / split / "pred_masks"
            a, b = ppng.read_image(p, "L") > 127, np.asarray(Image.open(q)) > 127
            iou = (a & b).sum() / max((a | b).sum(), 1)
            assert iou >= MASK_IOU_MIN, (p.name, iou)
        (fo, ro), (ft, rt) = (read_csv_rows(d / "val_metric.csv")
                              for d in (trained["out"] / split, tmp_path / split))
        assert fo == ft and [r["Id"] for r in ro] == [r["Id"] for r in rt]
        assert [r["Text"] for r in ro] == [r["Text"] for r in rt]


def test_cli_eval_refusals(trained, tiny_cli, tmp_path, capsys, monkeypatch):
    from cor_tpu_torch.cli import eval as pcli_eval

    cfg = tmp_path / "eval.yaml"
    for text, argv, want in (
            ("load_checkpoint_path: /ckpt/none.pth\n", [], "load_checkpoint_path=/ckpt/none.pth"),
            ("val_csv_A: /data/absent.csv\n", [], "manifest not found"),
            ("batch_size: 2\n", [], "no CUDA card")):
        cfg.write_text(text)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit) as e:
            pcli_eval.main(["--config", str(cfg), *argv])
        assert e.value.code == 2 and want in capsys.readouterr().err


def test_cli_index_and_retrieve_on_a_manifest(trained, tiny_cli, tmp_path, capsys,
                                              monkeypatch):
    """cli.index on the manifest with the .pth: rows within 1e-6 of
    cor_tpu's build_gallery over its CORDataset with the same weights, ids
    in manifest order; cli.retrieve on the same manifest: the recalls of
    cor_tpu's evaluate_retrieval (one-device mesh) on its CORDataset,
    Recall@4 of the 4 triplets 1, and the index route's recalls."""
    import jax

    import cor_tpu.retrieval.index as jindex
    import cor_tpu.retrieval.protocol as jprot
    from cor_tpu.data.pipeline import DataLoader as JLoader
    from cor_tpu.parallel import make_mesh
    from cor_tpu.utils.convert import load_trained_params as j_load
    from cor_tpu_torch.cli import index as pcli_index
    from cor_tpu_torch.cli import retrieve as pcli_retrieve
    from cor_tpu_torch.retrieval.index import load_gallery_index
    from tests.helpers import tiny_core_config
    from tests.test_torch_retrieve import memoized

    # one jitted candidate encoder for cor_tpu's build and its protocol
    encoder = memoized(jindex.make_candidate_encoder)
    monkeypatch.setattr(jindex, "make_candidate_encoder", encoder)
    monkeypatch.setattr(jprot, "make_candidate_encoder", encoder)
    out = pcli_index.main(["--config", str(trained["cfg"]), "--out", str(tmp_path / "idx"),
                           "--batch-size", "2", "--device", "cpu"])
    assert out["rows"] == 4
    idx = load_gallery_index(tmp_path / "idx")
    jc = tiny_core_config()
    params = jax.tree.map(np.asarray, j_load(trained["pth"], jc, None, LOG))
    ds = j_dataset(trained["splits"]["Test_1"], trained["root"])
    emb, ids, _ = jindex.build_gallery(jc, params, JLoader(ds, 2, num_workers=2))
    np.testing.assert_array_equal(idx["pair_ids"], ids)
    np.testing.assert_allclose(idx["embeddings"], emb, atol=1e-6, rtol=0)
    capsys.readouterr()
    base = ["--config", str(trained["cfg"]), "--k", "4", "--batch-size", "2", "--device", "cpu"]
    rec = pcli_retrieve.main(base)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["gallery_size"] == 4 and rec["recall@4"] == 1.0
    want = jprot.evaluate_retrieval(jc, params, JLoader(ds, 2, num_workers=2),
                                    make_mesh(jax.devices()[:1]), ks=(1, 4))
    assert rec == {k: (round(v, 4) if isinstance(v, float) else v) for k, v in want.items()}
    assert pcli_retrieve.main([*base, "--gallery-index", str(tmp_path / "idx")]) == rec
    one = pcli_retrieve.main([*base, "--limit", "2"])
    assert one["gallery_size"] == 2


def test_server_reads_request_files_as_cor_tpu(dataset):
    """A serving request that names PNG files: the port's reader and the
    preproc library give cor_tpu's server inputs bit for bit (cor_tpu reads
    them with Pillow and its native resize)."""
    from types import SimpleNamespace

    from cor_tpu.data.tokenizer import get_tokenizer as j_tokenizer
    from cor_tpu.retrieval.serve import RetrievalServer as JServer
    from cor_tpu_torch.data.tokenizer import get_tokenizer
    from cor_tpu_torch.retrieval.serve import RetrievalServer
    from tests.helpers import tiny_core_config

    root, _ = dataset
    for s, m in (("s1.png", "sm1.png"), ("s2.png", "sm2.png")):
        req = {"support_img": str(root / "coco" / "image" / s),
               "support_mask": str(root / "coco" / "mask" / "sup" / m), "text": "a red car"}
        ours = RetrievalServer._file_query(
            SimpleNamespace(cfg=port_config(), tokenizer=get_tokenizer(None, 8, 64)), req)
        theirs = JServer._file_query(
            SimpleNamespace(cfg=tiny_core_config(), tokenizer=j_tokenizer(None, 8, 64)), req)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
