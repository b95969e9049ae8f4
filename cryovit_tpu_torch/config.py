"""Training configuration as dataclasses (port of ``cryovit_tpu/config.py``
and the YAML defaults the JAX package composes for
``compose("train_model", ["model=cryovit", "datamodule=file", ...])``).

The machine with the GPU has no pyyaml and the port reads nothing of the
JAX package, so the defaults of ``configs/train_model.yaml``,
``trainer/fit.yaml``, ``model/cryovit.yaml`` + ``model/default.yaml``,
``callbacks/stochastic_weight_average.yaml``, ``datamodule/file.yaml`` and
``datamodule/dataloader/default.yaml`` are written out here. Overrides are
``dataclasses.replace`` on the node.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from cryovit_tpu_torch.models import losses as _losses
from cryovit_tpu_torch.models import metrics as _metrics

__all__ = [
    "DataLoaderConfig",
    "LOSSES",
    "METRICS",
    "ModelConfig",
    "PRECISION_DTYPES",
    "SWAConfig",
    "TrainConfig",
    "TrainerConfig",
]

PRECISION_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}  # ``trainer/fit.yaml``: bf16 | f32

# config names → loss / metric factories (``model/losses/*.yaml``,
# ``model/metrics/*.yaml``)
LOSSES: dict[str, Callable] = {"dice_loss": _losses.DiceLoss, "focal_loss": _losses.FocalLoss}
METRICS: dict[str, Callable] = {"dice_metric": _metrics.DiceMetric, "f1_metric": _metrics.F1Metric}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """``model/cryovit.yaml`` over ``model/default.yaml``."""

    name: str = "CryoVIT"
    input_key: str = "dino_features"
    lr: float = 1e-4
    weight_decay: float = 1e-3
    losses: tuple[str, ...] = ("dice_loss",)
    metrics: tuple[str, ...] = ("dice_metric", "f1_metric")
    metric_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """``trainer/fit.yaml`` over the trainer schema (no mesh: one device)."""

    precision: str = "bf16"
    max_epochs: int = 50
    log_every_n_steps: int = 1
    enable_checkpointing: bool = False
    enable_model_summary: bool = True
    gradient_clip_val: float | None = None
    gradient_clip_algorithm: str = "norm"


@dataclasses.dataclass(frozen=True)
class SWAConfig:
    """``callbacks/stochastic_weight_average.yaml``. Its ``swa_lrs`` (the
    model's lr) and ``annealing_epochs`` (0) are what the port's SWA always
    does: a constant learning rate, no annealing."""

    swa_epoch_start: float = 0.8


@dataclasses.dataclass(frozen=True)
class DataLoaderConfig:
    """``datamodule/dataloader/default.yaml``."""

    num_workers: int = 8
    prefetch_factor: int = 1
    batch_size: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """``train_model.yaml`` with ``model=cryovit`` and ``datamodule=file``."""

    label_key: str
    name: str | None = None  # None: "file_any_cryovit_<label_key>"
    random_seed: int = 42
    model: ModelConfig = ModelConfig()
    trainer: TrainerConfig = TrainerConfig()
    swa: SWAConfig = SWAConfig()
    dataloader: DataLoaderConfig = DataLoaderConfig()

    @property
    def run_name(self) -> str:
        return self.name or f"file_any_cryovit_{self.label_key}"
