"""Export entry point: a checkpoint the port wrote -> the reference's torch
CORE checkpoint, the counterpart of ``cor_tpu.cli.export``.

    python -m cor_tpu_torch.cli.export --checkpoint runs/ckpt/checkpoint_epoch_10 \\
        --out checkpoint_epoch_10.pth [--config configs/vaild_config.yaml]

Reads any checkpoint directory of ``train/checkpoint.py`` (epoch saves,
``best_model``, ``best_model_full``, interrupted saves): its ``params`` and
its epoch and loss. The model keys of ``--config`` (default: those of
``configs/vaild_config.yaml``) give the modules whose layouts the state
dict is read in; the model is built on the ``meta`` device, so no weight is
drawn. The ``.pth`` holds ``epoch``, ``model_state_dict``,
``optimizer_state_dict`` and ``loss``, as the reference's trainer writes
them, and ``utils/convert.load_trained_params`` of either package reads it
back. ``cor_tpu``'s Orbax directories are refused (``ORBAX_ITEM``).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def model_skeleton(core_cfg):
    """The ``CoreModel`` of ``core_cfg`` on the ``meta`` device: its modules'
    layouts, no weights."""
    import torch

    from cor_tpu_torch.models.core_model import CoreModel
    from cor_tpu_torch.models.prompt_encoder import PromptEncoder
    from cor_tpu_torch.models.sam_decoder import MaskDecoder
    from cor_tpu_torch.models.sam_encoder import SamEncoder
    from cor_tpu_torch.models.support_branch import SupportBranch

    with torch.device("meta"):
        return CoreModel(SamEncoder(core_cfg.encoder), SupportBranch(core_cfg.support),
                         PromptEncoder(core_cfg.prompt), MaskDecoder(core_cfg.decoder))


def export_checkpoint(checkpoint, out, core_cfg=None) -> dict:
    """Read the port's checkpoint directory and write the reference-format
    ``.pth``. Returns a summary (epoch, loss, n_keys, out)."""
    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.train.checkpoint import restore_checkpoint
    from cor_tpu_torch.utils.convert import ORBAX_ITEM, is_port_checkpoint
    from cor_tpu_torch.utils.export import export_core_state_dict, save_core_checkpoint
    from cor_tpu_torch.utils.weights import to_cor_tpu_tree

    ckpt = Path(checkpoint)
    if not ckpt.exists():
        raise FileNotFoundError(f"checkpoint directory not found: {ckpt}")
    if not is_port_checkpoint(ckpt):
        raise ValueError(f"{ckpt} is not a cor_tpu_torch checkpoint directory (no state.pt); "
                         f"cor_tpu's Orbax checkpoints need {ORBAX_ITEM}")
    payload = restore_checkpoint(ckpt.parent, ckpt.name)
    epoch = int(payload.get("epoch", 0))
    loss = payload.get("loss")
    loss = float(loss) if loss is not None else None
    skeleton = model_skeleton(core_cfg or EvalConfig().core_config())
    sd = export_core_state_dict(to_cor_tpu_tree(skeleton, payload["params"]))
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_core_checkpoint(str(out), epoch=epoch, loss=loss, state_dict=sd)
    return {"epoch": epoch, "loss": loss, "n_keys": len(sd), "out": str(out)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Export a cor_tpu_torch checkpoint to the reference torch CORE format")
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint directory (e.g. .../checkpoint_epoch_10, .../best_model)")
    parser.add_argument("--out", required=True, help="output .pth path")
    parser.add_argument("--config", default=None,
                        help="YAML whose model keys the checkpoint was trained with (eval or "
                             "train); default: configs/vaild_config.yaml's")
    args = parser.parse_args(argv)
    core_cfg = None
    if args.config:
        from cor_tpu_torch.config import load_any_config

        core_cfg = load_any_config(args.config).core_config()
    try:
        summary = export_checkpoint(args.checkpoint, args.out, core_cfg)
    except (FileNotFoundError, ValueError) as e:
        parser.error(str(e))
    print(f"exported {summary['n_keys']} parameters (epoch {summary['epoch']}, "
          f"loss {summary['loss']}) -> {summary['out']}")
    return summary


if __name__ == "__main__":
    main()
