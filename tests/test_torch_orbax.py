"""cor_tpu's Orbax checkpoints in the port, on the CPU: ``utils/orbax.py``
(the format read and written through tensorstore, without orbax or jax)
against cor_tpu's own Orbax saves.

- A checkpoint that cor_tpu's trainer writes (``save_checkpoint`` of a full
  training state, and of ``best_model``'s params-only payload) loads into
  the port's model bit for bit through ``load_trained_params`` (the weight
  bridge, audited), and ``cli.export`` turns it into a reference ``.pth``
  with its epoch and loss that cor_tpu reads back bit for bit.
- The reader keeps the tree's structure: sequences as lists, ``None``
  leaves, scalars 0-d; the reader and writer import no jax.
- Without tensorstore (the card's machine) an Orbax directory is refused,
  naming the package, by ``load_trained_params`` and by ``cli.export``
  reading one or writing one (``--to-orbax``).
"""

from __future__ import annotations

import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cor_tpu_torch.models import core_model as pcore
from cor_tpu_torch.utils import convert as pconv
from cor_tpu_torch.utils import orbax as porbax
from cor_tpu_torch.utils.weights import to_cor_tpu_tree
from tests.test_torch_checkpoint_io import _jax_tiny_config, assert_trees_equal
from tests.test_torch_retrieve import port_config

LOG = logging.getLogger("test_torch_orbax")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def file_time(request):
    """The file's own seconds, written to the terminal at its end."""
    t0 = time.perf_counter()
    yield
    rep = request.config.pluginmanager.get_plugin("terminalreporter")
    if rep is not None:
        rep.write_line(f"tests/test_torch_orbax.py: {time.perf_counter() - t0:.1f} s")


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """cor_tpu's Orbax saves of the port's seeded tiny model (seed 3): a full
    training state (an optimizer state with a None leaf and a sequence) and
    best_model's params-only payload."""
    from cor_tpu.train.checkpoint import save_checkpoint

    d = tmp_path_factory.mktemp("orbax")
    tree = to_cor_tpu_tree(pcore.init_core_model(port_config(), 3))
    mu = {"mask_decoder": tree["mask_decoder"]}
    save_checkpoint(d, "checkpoint_epoch_4", {
        "params": tree, "opt_state": ({"mu": mu}, None, [np.int32(12)]), "step": np.int32(12),
        "epoch": np.int32(4), "loss": np.float32(0.375), "best_score": np.float32(1.25),
        "best_epoch": np.int32(3)})
    save_checkpoint(d, "best_model", {"params": tree})
    return d, tree


@pytest.mark.parametrize("name", ["checkpoint_epoch_4", "best_model"])
def test_cor_tpu_orbax_checkpoint_loads_into_the_port_bit_for_bit(saved, name, caplog):
    d, tree = saved
    assert porbax.is_orbax_checkpoint(d / name)
    model = pcore.init_core_model(port_config(), 8)
    with caplog.at_level(logging.INFO, logger=LOG.name):
        pconv.load_trained_params(d / name, port_config(), model, LOG)
    assert "Loaded Orbax checkpoint" in caplog.text and "[ckpt audit]" not in caplog.text
    assert_trees_equal(to_cor_tpu_tree(model), tree)
    assert_trees_equal(porbax.read_params(d / name), tree)


def test_orbax_reader_keeps_the_tree(saved):
    d, tree = saved
    full = porbax.read_tree(d / "checkpoint_epoch_4")
    assert set(full) == {"params", "opt_state", "step", "epoch", "loss", "best_score",
                         "best_epoch"}
    mu, none, count = full["opt_state"]
    assert none is None and isinstance(count, list) and count[0].shape == ()
    assert int(count[0]) == int(full["step"]) == 12 and full["loss"].dtype == np.float32
    assert isinstance(full["params"]["image_encoder"]["blocks"], list)
    assert_trees_equal(mu["mu"], {"mask_decoder": tree["mask_decoder"]})
    assert set(porbax.read_tree(d / "checkpoint_epoch_4", ("epoch", "absent"))) == {"epoch"}
    with pytest.raises(ValueError, match="not an Orbax checkpoint"):
        porbax.read_tree(d)


def test_cli_export_turns_a_cor_tpu_orbax_checkpoint_into_a_pth(saved, tmp_path, monkeypatch,
                                                               capsys):
    from cor_tpu.utils.convert import load_trained_params as j_load
    from cor_tpu_torch.cli import export as pexport_cli
    from cor_tpu_torch.config import EvalConfig

    d, tree = saved
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: port_config())
    cfg = tmp_path / "eval.yaml"
    cfg.write_text("batch_size: 2\n")
    out = pexport_cli.main(["--checkpoint", str(d / "checkpoint_epoch_4"), "--config", str(cfg),
                            "--out", str(tmp_path / "e4.pth")])
    assert (out["epoch"], out["loss"]) == (4, 0.375) and "exported" in capsys.readouterr().out
    raw = torch.load(tmp_path / "e4.pth", weights_only=True)
    assert (raw["epoch"], raw["loss"]) == (4, 0.375)
    assert_trees_equal(j_load(tmp_path / "e4.pth", _jax_tiny_config(), None, LOG), tree)


def test_orbax_is_refused_without_tensorstore(saved, tmp_path, monkeypatch, capsys):
    from cor_tpu_torch.cli import export as pexport_cli
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.train.checkpoint import save_checkpoint

    d, _ = saved
    pc = port_config()
    monkeypatch.setattr(EvalConfig, "core_config", lambda self: pc)
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # the import now fails
    model = pcore.init_core_model(pc, 1)
    with pytest.raises(ImportError, match="'tensorstore'"):
        pconv.load_trained_params(d / "best_model", pc, model, LOG)
    save_checkpoint(tmp_path, "best_model", {"params": model.state_dict()})
    for argv in (["--checkpoint", str(d / "best_model"), "--out", str(tmp_path / "x.pth")],
                 ["--checkpoint", str(tmp_path / "best_model"), "--out", str(tmp_path / "o"),
                  "--to-orbax"]):
        with pytest.raises(SystemExit) as e:
            pexport_cli.main(argv)
        assert e.value.code == 2 and "'tensorstore'" in capsys.readouterr().err


def test_orbax_module_imports_no_jax(saved, tmp_path):
    """Read cor_tpu's checkpoint and write one in a process where jax,
    cor_tpu and orbax cannot be imported."""
    d, _ = saved
    script = (
        "import sys\n"
        "for m in ('jax', 'cor_tpu', 'orbax'):\n"
        "    sys.modules[m] = None\n"
        "from cor_tpu_torch.utils import orbax\n"
        f"p = orbax.read_params({str(d / 'best_model')!r})\n"
        f"orbax.write_params({str(tmp_path / 'w')!r}, p)\n"
        f"q = orbax.read_params({str(tmp_path / 'w')!r})\n"
        "assert p['mask_decoder']['iou_token'].tobytes() == q['mask_decoder']['iou_token'].tobytes()\n"
        "assert not [k for k in sys.modules if k.startswith(('jax.', 'orbax.', 'cor_tpu.'))]\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
