"""Evaluation/serving configuration, the PyTorch counterpart of
``cor_tpu.config.EvalConfig``.

The YAML files of ``configs/`` load directly, with unknown keys rejected.
PyYAML is imported only when a file is read, so the port runs without it when
no ``--config`` is given; the defaults below are the model keys of
``configs/vaild_config.yaml``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from cor_tpu_torch.models.core_model import CoreConfig


@dataclass
class EvalConfig:
    batch_size: int = 10
    sam_model_name: str = "sam_base"
    siglip_model_name: str = "ViT-B-16-SigLIP-384"
    mask_pooling: str = "MaskAdapterPooling"
    multimask_output: bool = False
    compute_dtype: str = "bfloat16"
    seed: int = 0

    dataset_path: str = ""
    train_csv: str = ""
    val_csv_A: str = ""
    val_csv_B: str = ""
    vaild_model_save_path: str = "./eval_out"
    load_checkpoint_path: Optional[str] = None
    load_sam_pretrained_checkpoint: Optional[str] = None
    load_siglip_pretrained_checkpoint: Optional[str] = None
    tokenizer_path: Optional[str] = None
    num_workers: int = 8

    def core_config(self) -> CoreConfig:
        return CoreConfig(
            sam_model=self.sam_model_name,
            siglip_model=self.siglip_model_name,
            mask_pooling=self.mask_pooling,
            multimask_output=self.multimask_output,
            compute_dtype=self.compute_dtype,
        )

    def checkpoint_keys(self) -> list:
        """The checkpoint keys this config sets (the port loads none yet)."""
        return [
            f.name for f in dataclasses.fields(self)
            if f.name.startswith("load_") and getattr(self, f.name)
        ]


def load_eval_config(path) -> EvalConfig:
    try:
        import yaml
    except ImportError as e:
        raise RuntimeError(
            f"reading {path} needs PyYAML; without --config the defaults of "
            "configs/vaild_config.yaml apply"
        ) from e
    raw = yaml.safe_load(Path(path).read_text()) or {}
    names = {f.name for f in dataclasses.fields(EvalConfig)}
    unknown = set(raw) - names
    if unknown:
        raise ValueError(f"Unknown config keys in {path}: {sorted(unknown)}")
    return EvalConfig(**raw)
