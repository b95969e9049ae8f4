"""Training runner (port of ``cryovit_tpu/run/train_model.py:run_training``).

Trains a model on explicit tomogram and label files and writes a
distributable ``.model`` artifact in the reference torch format, which
``cryovit-torch infer --fused``, the JAX package and the reference stack
all read. The JAX package composes a YAML config here; the port builds the
same recipe from :class:`cryovit_tpu_torch.config.TrainConfig`. The
experiment-mode ``run_trainer`` (splits CSV) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from pathlib import Path

import torch

from cryovit_tpu_torch.callbacks import TensorBoardLogger
from cryovit_tpu_torch.config import LOSSES, METRICS, PRECISION_DTYPES, TrainConfig
from cryovit_tpu_torch.data import DataLoader, FileDataModule, FileDataset
from cryovit_tpu_torch.models import CryoVIT
from cryovit_tpu_torch.train.checkpoint import load_model, save_model
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.train.swa import StochasticWeightAveraging
from cryovit_tpu_torch.types import ModelType

logger = logging.getLogger(__name__)

__all__ = ["build_file_datamodule", "build_model", "build_trainer", "run_training"]


def build_model(cfg: TrainConfig) -> CryoVIT:
    """The model family of ``cfg.model``, computing in the trainer's precision."""
    m = cfg.model
    return CryoVIT(
        name=m.name,
        input_key=m.input_key,
        lr=m.lr,
        weight_decay=m.weight_decay,
        losses={k: LOSSES[k]() for k in m.losses},
        metrics={k: METRICS[k](threshold=m.metric_threshold) for k in m.metrics},
        dtype=PRECISION_DTYPES[cfg.trainer.precision],
    )


def build_file_datamodule(
    cfg: TrainConfig,
    data_paths: list,
    data_labels: list | None = None,
    val_paths: list | None = None,
    val_labels: list | None = None,
    labels: list[str] | None = None,
    dataset_cls: type[FileDataset] = FileDataset,
) -> FileDataModule:
    """CLI-mode :class:`FileDataModule` (reference ``run/train_model.py:82-92``)."""
    dl = cfg.dataloader
    return FileDataModule(
        data_paths=data_paths,
        data_labels=data_labels,
        val_paths=val_paths,
        val_labels=val_labels,
        labels=labels,
        dataset_fn=functools.partial(
            dataset_cls, input_key=cfg.model.input_key, label_key=cfg.label_key
        ),
        dataloader_fn=functools.partial(
            DataLoader, batch_size=dl.batch_size, num_workers=dl.num_workers,
            prefetch_factor=dl.prefetch_factor,
        ),
        input_key=cfg.model.input_key,
    )


def build_trainer(
    cfg: TrainConfig,
    device: torch.device | str | None = None,
    root_dir: Path | None = None,
    log_training: bool = False,
) -> Trainer:
    """The Trainer with SWA and, with ``log_training``, a TensorBoard
    logger under ``root_dir``."""
    swa = StochasticWeightAveraging(swa_epoch_start=cfg.swa.swa_epoch_start)
    loggers = [TensorBoardLogger(root_dir or ".", cfg.run_name)] if log_training else []
    return Trainer(
        **dataclasses.asdict(cfg.trainer),
        default_root_dir=root_dir,
        callbacks=[swa],
        loggers=loggers,
        seed=cfg.random_seed,
        device=device,
    )


def _initial_weights(ckpt_path: Path) -> dict[str, torch.Tensor]:
    """A reference-format ``.model`` artifact's weights, or a torch state
    dict (``weights.pt``) with the reference's names."""
    if ckpt_path.suffix == ".model":
        module, *_ = load_model(ckpt_path, device="cpu")
        return module.state_dict()
    return torch.load(ckpt_path, map_location="cpu", weights_only=True)


def run_training(
    train_data: list[Path],
    train_labels: list[Path],
    labels: list[str],
    label_key: str,
    model_name: str,
    result_dir: Path,
    val_data: list[Path] | None = None,
    val_labels: list[Path] | None = None,
    model_type: str = "cryovit",
    num_epochs: int = 50,
    ckpt_path: Path | None = None,
    log_training: bool = False,
    export_torch: bool = False,
    device: torch.device | str | None = None,
    config: TrainConfig | None = None,
) -> Path:
    """Train on explicit file paths and write ``<result_dir>/<name>.model``
    (reference ``run/train_model.py:24-153``).

    ``ckpt_path`` fine-tunes from a ``.model`` or ``weights.pt``. The port's
    ``.model`` already is the reference torch format, so ``export_torch``
    writes the same artifact again as ``<name>.torch.model``, the file name
    the JAX package's ``--export-torch`` gives it. ``config`` overrides the
    recipe's defaults; ``num_epochs`` sets its ``max_epochs``.
    """
    if ModelType(model_type) != ModelType.CRYOVIT:
        raise NotImplementedError(f"{model_type} training is not yet ported (CryoVIT only)")
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    cfg = config or TrainConfig(label_key=label_key)
    cfg = dataclasses.replace(
        cfg, label_key=label_key, name=model_name,
        trainer=dataclasses.replace(cfg.trainer, max_epochs=num_epochs),
    )

    datamodule = build_file_datamodule(
        cfg, data_paths=train_data, data_labels=train_labels, val_paths=val_data,
        val_labels=val_labels, labels=labels,
    )
    variables = None
    if ckpt_path is not None:
        variables = _initial_weights(Path(ckpt_path))
        logger.info("fine-tuning from %s", ckpt_path)

    trainer = build_trainer(cfg, device, result_dir, log_training)
    module = trainer.fit(build_model(cfg), datamodule, variables=variables)

    out_path = save_model(model_name, label_key, module, result_dir / f"{model_name}.model")
    logger.info("saved model artifact to %s", out_path)
    if export_torch:
        torch_path = save_model(model_name, label_key, module, result_dir / f"{model_name}.torch.model")
        logger.info("saved reference-readable torch artifact to %s", torch_path)
    return out_path
