"""Export entry point: a trained checkpoint -> the reference's torch CORE
checkpoint, or (``--to-orbax``) ``cor_tpu``'s Orbax format; the counterpart
of ``cor_tpu.cli.export``.

    python -m cor_tpu_torch.cli.export --checkpoint runs/ckpt/checkpoint_epoch_10 \\
        --out checkpoint_epoch_10.pth [--config configs/vaild_config.yaml]
    python -m cor_tpu_torch.cli.export --checkpoint runs/ckpt/best_model \\
        --out best_model_orbax --to-orbax

Reads any checkpoint directory of ``train/checkpoint.py`` (epoch saves,
``best_model``, ``best_model_full``, interrupted saves: its ``params`` and
its epoch and loss) or of ``cor_tpu``'s trainer (an Orbax directory: its
``params`` subtree, and its epoch and loss where it holds them; reading one
needs ``tensorstore``). The model keys of ``--config`` (default: those of
``configs/vaild_config.yaml``) give the modules whose layouts the
parameters are read in; the model is built on the ``meta`` device, so no
weight is drawn. The ``.pth`` holds ``epoch``, ``model_state_dict``,
``optimizer_state_dict`` and ``loss``, as the reference's trainer writes
them, and ``utils/convert.load_trained_params`` of either package reads it
back. ``--to-orbax`` writes ``--out`` as a parameters-only Orbax directory
(``{"params": ...}``, ``cor_tpu``'s ``best_model`` layout, through
``utils/orbax.write_params``), which ``cor_tpu``'s ``load_trained_params``
restores; the optimizer state is not carried over in either direction.
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


def read_trained(checkpoint, core_cfg=None):
    """(the parameters as a ``cor_tpu`` tree, epoch, loss) of a checkpoint
    directory of either package, its parameters held to the modules of
    ``core_cfg`` (missing, unexpected or reshaped leaves refused)."""
    import numpy as np

    from cor_tpu_torch.config import EvalConfig
    from cor_tpu_torch.train.checkpoint import restore_checkpoint
    from cor_tpu_torch.utils.convert import audit_params, expected_tree, is_port_checkpoint
    from cor_tpu_torch.utils.orbax import is_orbax_checkpoint, read_params, read_tree
    from cor_tpu_torch.utils.weights import to_cor_tpu_tree

    ckpt = Path(checkpoint)
    if not ckpt.exists():
        raise FileNotFoundError(f"checkpoint directory not found: {ckpt}")
    skeleton = model_skeleton(core_cfg or EvalConfig().core_config())
    if is_port_checkpoint(ckpt):
        payload = restore_checkpoint(ckpt.parent, ckpt.name)
        tree = to_cor_tpu_tree(skeleton, payload["params"])
    elif is_orbax_checkpoint(ckpt):
        payload = {k: np.asarray(v) for k, v in read_tree(ckpt, ("epoch", "loss")).items()}
        tree = read_params(ckpt)
        bad = {k: v for k, v in audit_params(expected_tree(skeleton), tree).items() if v}
        if bad:
            raise ValueError(f"{ckpt}: the parameters do not fit the config's model: "
                             + "; ".join(f"{k} {v[:5]}" for k, v in bad.items()))
    else:
        raise ValueError(f"{ckpt} is neither a cor_tpu_torch checkpoint directory (state.pt) "
                         f"nor an Orbax checkpoint directory")
    loss = payload.get("loss")
    return tree, int(payload.get("epoch", 0)), (float(loss) if loss is not None else None)


def export_checkpoint(checkpoint, out, core_cfg=None, to_orbax: bool = False) -> dict:
    """Read a checkpoint directory (``read_trained``) and write the
    reference-format ``.pth``, or with ``to_orbax`` a parameters-only Orbax
    directory. Returns a summary (epoch, loss, n_keys, out)."""
    from cor_tpu_torch.utils.export import export_core_state_dict, save_core_checkpoint
    from cor_tpu_torch.utils.orbax import write_params
    from cor_tpu_torch.utils.weights import flatten_tree

    tree, epoch, loss = read_trained(checkpoint, core_cfg)
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if to_orbax:
        write_params(out, tree)
        return {"epoch": epoch, "loss": loss, "n_keys": len(flatten_tree(tree)), "out": str(out)}
    sd = export_core_state_dict(tree)
    save_core_checkpoint(str(out), epoch=epoch, loss=loss, state_dict=sd)
    return {"epoch": epoch, "loss": loss, "n_keys": len(sd), "out": str(out)}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="Export a trained checkpoint to the reference torch CORE format or to "
                    "cor_tpu's Orbax format")
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint directory of either package (e.g. "
                             ".../checkpoint_epoch_10, .../best_model)")
    parser.add_argument("--out", required=True,
                        help="output .pth path (with --to-orbax: the Orbax directory)")
    parser.add_argument("--to-orbax", action="store_true",
                        help="write a parameters-only Orbax directory (needs tensorstore)")
    parser.add_argument("--config", default=None,
                        help="YAML whose model keys the checkpoint was trained with (eval or "
                             "train); default: configs/vaild_config.yaml's")
    args = parser.parse_args(argv)
    core_cfg = None
    if args.config:
        from cor_tpu_torch.config import load_any_config

        core_cfg = load_any_config(args.config).core_config()
    try:
        summary = export_checkpoint(args.checkpoint, args.out, core_cfg, args.to_orbax)
    except (FileNotFoundError, ValueError, ImportError) as e:
        parser.error(str(e))
    print(f"exported {summary['n_keys']} parameters (epoch {summary['epoch']}, "
          f"loss {summary['loss']}) -> {summary['out']}")
    return summary


if __name__ == "__main__":
    main()
