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

The experiment mode (``python -m cryovit_tpu_torch.training.*``) composes
the port's own copy of that YAML tree instead (``configs/``, read by
:mod:`cryovit_tpu_torch.composer`), with the JAX ``config.py`` surface
below: ``samples``, ``tomogram_exts``, the six structured-config schemas
and their registrations, the validators and :func:`compose`. The trainer
schema is :class:`BaseTrainerConfig` here (registered as ``base_trainer``,
as the JAX ``TrainerConfig`` is), since :class:`TrainerConfig` is the CLI's
``trainer/fit.yaml`` recipe. ``tests/test_torch_composer.py`` holds the two
sources to each other.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any, Callable

import torch

from cryovit_tpu_torch.composer import (
    MISSING,
    ConfigError,
    DotDict,
    compose,
    expand_sweep,
    instantiate,
    missing_keys,
    register_schema,
)
from cryovit_tpu_torch.models import losses as _losses
from cryovit_tpu_torch.models import metrics as _metrics
from cryovit_tpu_torch.types import Sample

__all__ = [
    "BaseModelConfig",
    "BaseTrainerConfig",
    "ConfigError",
    "DataLoaderConfig",
    "DataModuleConfig",
    "DinoFeaturesConfig",
    "DotDict",
    "EvalConfig",
    "ExperimentConfig",
    "ExperimentPaths",
    "LOSSES",
    "METRICS",
    "MISSING",
    "MODELS",
    "ModelConfig",
    "PRECISION_DTYPES",
    "SWAConfig",
    "TRAINER_MODEL",
    "TrainConfig",
    "TrainerConfig",
    "compose",
    "expand_sweep",
    "instantiate",
    "samples",
    "tomogram_exts",
    "validate_dino_config",
    "validate_experiment_config",
]

logger = logging.getLogger(__name__)

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


# ``trainer_model/<model>.yaml``: the trainer settings a family brings
# (``optional trainer_model: ${model}`` in ``train_model.yaml``); only SAM2
# has one, so MedSAM trains unclipped, as in the JAX package
TRAINER_MODEL: dict[str, dict[str, object]] = {
    "sam2": {"gradient_clip_val": 1, "gradient_clip_algorithm": "norm"},
}


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

    @classmethod
    def for_model(cls, model_type: str, label_key: str, **fields) -> "TrainConfig":
        """The recipe of ``model=<model_type>``: its ``MODELS`` entry and
        the trainer with its ``trainer_model`` settings (SAM2 clips the
        gradients' global norm at 1)."""
        trainer = dataclasses.replace(TrainerConfig(), **TRAINER_MODEL.get(model_type, {}))
        return cls(label_key=label_key, model=MODELS[model_type], trainer=trainer, **fields)

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


# ---- the experiment mode's surface (port of ``cryovit_tpu/config.py``) ----

samples: list[str] = [s.name for s in Sample]
tomogram_exts: list[str] = [".hdf", ".mrc"]


@dataclasses.dataclass
class BaseModelConfig:
    """Model group schema (reference ``config.py:21-46``)."""

    _target_: str = MISSING
    name: str = MISSING
    input_key: str = MISSING
    model_dir: str | None = None
    lr: float = MISSING
    weight_decay: float = 1e-3
    losses: Any = MISSING
    metrics: Any = MISSING
    custom_kwargs: dict | None = None


@dataclasses.dataclass
class BaseTrainerConfig:
    """Trainer schema: the JAX package's ``TrainerConfig`` (its trainer,
    redesigned from the reference's Lightning one, ``config.py:49-77``).

    ``precision`` is the compute-dtype policy (bf16 | f32). ``mesh_shape``
    is the device mesh (``{axis: size}``, −1 fills): a mesh over the
    processes of a ``torchrun`` launch, one per GPU
    (``cryovit_tpu_torch.parallel.make_mesh``). ``donate_state`` (XLA buffer
    donation) has no torch counterpart and is accepted with no effect."""

    precision: str = "bf16"  # compute dtype policy: bf16 | f32
    max_epochs: int | None = None
    log_every_n_steps: int = 1
    enable_checkpointing: bool = False
    enable_model_summary: bool = True
    default_root_dir: str | None = None
    gradient_clip_val: float | None = None
    gradient_clip_algorithm: str = "norm"
    mesh_shape: dict | None = None
    donate_state: bool = True


@dataclasses.dataclass
class DataModuleConfig:
    """Datamodule group schema (reference ``config.py:80-103``)."""

    _target_: str = MISSING
    sample: Any = MISSING  # str or list[str]
    split_id: int | None = None
    split_key: str = "split_id"
    test_sample: Any = None


@dataclasses.dataclass
class ExperimentPaths:
    """Directory layout conventions (reference ``config.py:106-132``)."""

    model_dir: str = MISSING
    data_dir: str = MISSING
    exp_dir: str = MISSING
    results_dir: str = MISSING
    tomo_name: str = "tomograms"
    feature_name: str = "dino_features"
    dino_name: str = "DINOv2"
    sam_name: str = "SAM2"
    csv_name: str = "csv"
    split_name: str = "splits.csv"


@dataclasses.dataclass
class DinoFeaturesConfig:
    """Feature-extraction schema (reference ``config.py:135-156``)."""

    batch_size: int = 128
    model_dir: str = MISSING
    sample: Any = None
    export_features: bool = False


@dataclasses.dataclass
class ExperimentConfig:
    """Root experiment schema (reference ``config.py:159-189``)."""

    name: str = MISSING
    label_key: str = MISSING
    additional_keys: Any = dataclasses.field(default_factory=list)
    random_seed: int = 42
    ckpt_path: str | None = None
    resume_ckpt: bool = False


register_schema("base_model", BaseModelConfig)
register_schema("base_trainer", BaseTrainerConfig)
register_schema("base_datamodule", DataModuleConfig)
register_schema("base_env", ExperimentPaths)
register_schema("dino_features_config", DinoFeaturesConfig)
register_schema("base_experiment_config", ExperimentConfig)


def _check_missing(cfg: DotDict, error_msg: str) -> None:
    missing = missing_keys(cfg)
    if missing:
        for key in missing:
            logger.error("%s: %s", error_msg, key)
        raise ConfigError(f"{error_msg}: {missing}")


def _validate_samples(value: Any) -> None:
    names = value if isinstance(value, list) else [value]
    for name in names:
        if name is None:
            continue
        if isinstance(name, str) and name not in Sample.__members__:
            raise ConfigError(f"invalid sample {name!r}; valid samples: {samples}")


def validate_experiment_config(cfg: DotDict) -> DotDict:
    """Validate a train/eval experiment config (reference ``config.py:234-284``).

    Raises ConfigError on missing keys or unknown sample names (the
    reference logs and ``sys.exit(1)``; the entry points catch ConfigError
    and exit 1)."""
    _check_missing(cfg, "missing config key")
    dm = cfg.get("datamodule", {})
    if "sample" in dm:
        _validate_samples(dm.get("sample"))
    if dm.get("test_sample") is not None and not isinstance(dm.get("test_sample"), int):
        _validate_samples(dm.get("test_sample"))
    return cfg


def validate_dino_config(cfg: DotDict) -> DotDict:
    """Validate a dino/sam feature-extraction config (reference ``config.py:205-231``)."""
    _check_missing(cfg, "missing config key")
    if cfg.get("sample") is not None:
        _validate_samples(cfg.get("sample"))
    return cfg
