"""Training and evaluation/serving configuration, the PyTorch counterpart of
``cor_tpu.config`` (``TrainConfig``, ``EvalConfig``).

The YAML files of ``configs/`` load directly, with unknown keys rejected.
PyYAML reads them where it is installed; where it is not (the card's
machine), ``read_flat_yaml`` reads the flat ``key: value`` files ``configs/``
holds (scalars, ``null``, quoted strings, ``#`` comments), as
``yaml.safe_load`` does. ``EvalConfig``'s defaults are the model keys of
``configs/vaild_config.yaml``, ``TrainConfig``'s those of
``configs/train_config_m3.yaml``.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Dict, Optional

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
        """The checkpoint keys this config sets."""
        return [
            f.name for f in dataclasses.fields(self)
            if f.name.startswith("load_") and getattr(self, f.name)
        ]

    def missing_checkpoints(self) -> list:
        """``key=path`` of each checkpoint key whose file or directory does not
        exist (the entry points refuse them before building a model)."""
        return [f"{k}={getattr(self, k)}" for k in self.checkpoint_keys()
                if not Path(str(getattr(self, k))).exists()]


@dataclass
class TrainConfig:
    """cor_tpu ``TrainConfig``, field for field, with its defaults."""

    # experiment
    epoch: int = 15
    lr: float = 1.0e-4
    lr_scheduler: str = "None"
    batch_size: int = 10
    optimizer: str = "AdamW"
    lr_decay_rate: float = 0.1
    lr_decay_epoch: int = 50
    gradient_clip: float = 0.5
    train_model_save_epoch: int = 5
    batch_record_interval: int = 10
    multimask_output: bool = False
    seed: int = 42

    # model
    sam_model_name: str = "sam_base"
    siglip_model_name: str = "ViT-B-16-SigLIP-384"
    mask_pooling: str = "MaskAdapterPooling"

    # paths
    dataset_path: str = ""
    train_csv: str = ""
    val_csv: str = ""
    train_model_save_path: str = "./checkpoints"
    load_sam_pretrained_checkpoint: Optional[str] = None
    load_siglip_pretrained_checkpoint: Optional[str] = None
    load_checkpoint_path: Optional[str] = None
    tokenizer_path: Optional[str] = None

    # runtime
    compute_dtype: str = "bfloat16"
    freeze_towers: bool = True  # False: the towers and the IoU head train too
    encoder_remat: Optional[bool] = None  # None: the encoder's remat_blocks (on)
    num_workers: int = 8
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    mesh_stage: int = 1
    pp_microbatches: int = 4
    log_every: int = 10
    shard_optimizer_state: bool = False
    grad_accum: int = 1
    async_checkpoint: bool = False
    seq_shard: bool = False

    def core_config(self) -> CoreConfig:
        cfg = CoreConfig(
            sam_model=self.sam_model_name,
            siglip_model=self.siglip_model_name,
            mask_pooling=self.mask_pooling,
            multimask_output=self.multimask_output,
            compute_dtype=self.compute_dtype,
            freeze_towers=self.freeze_towers,
        )
        if self.encoder_remat is not None:
            cfg = replace(cfg, encoder_override=replace(cfg.encoder,
                                                        remat_blocks=self.encoder_remat))
        return cfg

    def checkpoint_keys(self) -> list:
        """The checkpoint keys this config sets."""
        return [f.name for f in dataclasses.fields(self)
                if f.name.startswith("load_") and getattr(self, f.name)]

    def missing_checkpoints(self) -> list:
        """``key=path`` of each pretrained-weights key whose file does not
        exist. ``load_checkpoint_path`` names a checkpoint under
        ``train_model_save_path``, which ``train/checkpoint.resolve_resume``
        checks."""
        return [f"{k}={getattr(self, k)}" for k in self.checkpoint_keys()
                if k != "load_checkpoint_path" and not Path(str(getattr(self, k))).exists()]


# PyYAML's (YAML 1.1) scalar forms that configs/ uses
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_BOOL = {"true": True, "yes": True, "on": True, "false": False, "no": False, "off": False}


def _scalar(text: str) -> Any:
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text.lower() in _BOOL and text in (text.lower(), text.title(), text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def read_flat_yaml(text: str) -> Dict[str, Any]:
    """The mapping of a flat YAML file of ``key: value`` lines, without
    PyYAML: scalars as ``yaml.safe_load`` types them (int, float with a dot,
    bool, null, quoted or bare strings), ``#`` comments outside quotes."""
    out: Dict[str, Any] = {}
    for n, line in enumerate(text.splitlines(), start=1):
        body, quote = [], None
        for ch in line:
            if quote is None and ch == "#" and (not body or body[-1].isspace()):
                break
            if ch in "'\"":
                quote = None if quote == ch else (quote or ch)
            body.append(ch)
        body = "".join(body).strip()
        if not body:
            continue
        key, sep, value = body.partition(":")
        if not sep or line[:1].isspace() or not key.strip():
            raise ValueError(f"line {n}: not a flat 'key: value' line: {line!r}")
        out[key.strip()] = _scalar(value.strip())
    return out


def _read_config(path) -> Dict[str, Any]:
    text = Path(path).read_text()
    try:
        import yaml
    except ImportError:
        return read_flat_yaml(text)
    return yaml.safe_load(text) or {}


def _load(cls, path):
    raw = _read_config(path)
    unknown = set(raw) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"Unknown config keys in {path}: {sorted(unknown)}")
    return cls(**raw)


def load_train_config(path) -> TrainConfig:
    return _load(TrainConfig, path)


def load_eval_config(path) -> EvalConfig:
    return _load(EvalConfig, path)


def load_any_config(path):
    """An eval YAML as ``EvalConfig``, else a train YAML as ``TrainConfig``
    (for what only needs the model keys)."""
    keys = set(_read_config(path))
    if keys <= {f.name for f in dataclasses.fields(EvalConfig)}:
        return _load(EvalConfig, path)
    return _load(TrainConfig, path)
