"""Run configurations as dataclasses (port of ``cryovit_tpu/config.py``
and the YAML defaults the JAX package composes for
``compose("train_model" | "eval_model" | "infer_model", ["model=cryovit"
| "model=unet3d", "datamodule=file", ...])``).

The machine with the GPU has no pyyaml and the port reads nothing of the
JAX package, so the defaults of ``configs/{train,eval,infer}_model.yaml``,
``trainer/{fit,eval}.yaml``, ``model/{cryovit,unet3d,sam2,medsam}.yaml`` +
``model/default.yaml`` (+ ``model/default_sam.yaml``), ``callbacks/{stochastic_weight_average,csv_writer,
test_pred_writer}.yaml``, ``datamodule/file.yaml`` and
``datamodule/dataloader/default.yaml`` are written out here. Overrides are
``dataclasses.replace`` on the node.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable

import torch

from cryovit_tpu_torch.models import losses as _losses
from cryovit_tpu_torch.models import metrics as _metrics

__all__ = [
    "DataLoaderConfig",
    "EvalConfig",
    "LOSSES",
    "METRICS",
    "MODELS",
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
    """``model/cryovit.yaml`` over ``model/default.yaml``; ``model_type`` is
    the config group's choice (``model=cryovit``)."""

    model_type: str = "cryovit"
    name: str = "CryoVIT"
    input_key: str = "dino_features"
    lr: float = 1e-4
    weight_decay: float = 1e-3
    losses: tuple[str, ...] = ("dice_loss",)
    metrics: tuple[str, ...] = ("dice_metric", "f1_metric")
    metric_threshold: float = 0.5
    custom_kwargs: tuple[tuple[str, object], ...] = ()  # the family's extras, as pairs


# ``model/default_sam.yaml``'s custom_kwargs
_SAM_KWARGS = (
    ("prompt_lr", 1e-4),
    ("num_init_cond_slices", (1, 1)),
    ("rand_init_cond_slices", (True, False)),
    ("use_cache_features", True),
)


# the ported model families' configs by ``ModelType`` value:
# ``model/{cryovit,unet3d}.yaml`` over ``default.yaml``, and
# ``model/{sam2,medsam}.yaml`` over ``default_sam.yaml``
MODELS: dict[str, ModelConfig] = {
    "cryovit": ModelConfig(),
    "unet3d": ModelConfig(model_type="unet3d", name="UNet3D", input_key="data", lr=3e-3),
    "sam2": ModelConfig(model_type="sam2", name="SAM2", input_key="data", lr=5e-5,
                        custom_kwargs=_SAM_KWARGS),
    "medsam": ModelConfig(model_type="medsam", name="MedSAM", input_key="data", lr=5e-5,
                          custom_kwargs=_SAM_KWARGS),
}


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
    """``train_model.yaml`` with ``model=cryovit`` (or another family:
    ``model=MODELS["unet3d"]``) and ``datamodule=file``. ``model_dir`` is
    ``paths.model_dir`` (where ``model_dir/<sam_name>`` holds a published
    SAM2 checkpoint; ``$CRYOVIT_MODEL_DIR`` by default)."""

    label_key: str
    name: str | None = None  # None: "file_any_<model type>_<label_key>"
    random_seed: int = 42
    model_dir: str | None = None
    sam_name: str = "SAM2"
    model: ModelConfig = ModelConfig()
    trainer: TrainerConfig = TrainerConfig()
    swa: SWAConfig = SWAConfig()
    dataloader: DataLoaderConfig = DataLoaderConfig()

    @property
    def run_name(self) -> str:
        return self.name or f"file_any_{self.model.model_type}_{self.label_key}"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """``eval_model.yaml`` (and ``infer_model.yaml``) with
    ``datamodule=file`` and ``trainer/eval.yaml``.

    The YAML's ``additional_keys: [data]`` (the raw volume riding along to
    the writers) is what the port's ``FileDataset`` always does outside
    training, so it is no field here. The callbacks are ``csv_writer`` (metrics
    under :meth:`csv_dir`) and, with ``visualize``, ``test_pred_writer``
    (HDF5s under :meth:`predictions_dir`); ``infer_model.yaml`` has
    neither. The trainer's precision is set from the device by the
    runners: bf16 on a GPU, f32 on the CPU, as the JAX package evaluates a
    loaded model in f32."""

    label_key: str
    name: str
    model: ModelConfig = ModelConfig()
    random_seed: int = 42
    visualize: bool = False
    trainer: TrainerConfig = TrainerConfig(enable_model_summary=False)
    dataloader: DataLoaderConfig = DataLoaderConfig()

    def csv_dir(self, results_dir: str | Path) -> Path:
        """``callbacks/csv_writer.yaml``: ``<results_dir>/results/<name>``."""
        return Path(results_dir) / "results" / self.name

    def predictions_dir(self, results_dir: str | Path) -> Path:
        """``callbacks/test_pred_writer.yaml``: ``<results_dir>/predictions/<name>``."""
        return Path(results_dir) / "predictions" / self.name
