"""Training runners (port of ``cryovit_tpu/run/train_model.py``).

- :func:`run_training` — the file-path API of ``cryovit-torch train``;
- :func:`run_trainer` — the experiment mode (``python -m
  cryovit_tpu_torch.training.train_model``): a composed config, the splits
  CSV's datamodule, the experiment directory, ``weights.pt``, optional
  resume.

:func:`run_training` trains a model on explicit tomogram and label files and writes a
distributable ``.model`` artifact in the reference torch format, which
``cryovit-torch evaluate``/``infer``, the JAX package and the reference
stack all read: the CryoVIT decoder on DINOv2 features, the U-Net on raw
voxels, or SAM2 on raw voxels (its frozen Hiera-L encoder run live on every
step, LoRA decoder and prompt predictor trained; a published checkpoint
under ``model_dir/<sam_name>`` is laid over the initial weights, random
ones with a warning when there is none). MedSAM's Hiera-T is refused up
front (ROADMAP C2). The JAX package composes a YAML config here; the port
builds the same recipe from :class:`cryovit_tpu_torch.config.TrainConfig`.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
from pathlib import Path

import torch

from cryovit_tpu_torch import require_bf16_on_cuda, resolve_device
from cryovit_tpu_torch.callbacks import TensorBoardLogger
from cryovit_tpu_torch.composer import DotDict
from cryovit_tpu_torch.config import (
    LOSSES,
    METRICS,
    PRECISION_DTYPES,
    TrainConfig,
    validate_experiment_config,
)
from cryovit_tpu_torch.data import DataLoader, FileDataModule, FileDataset
from cryovit_tpu_torch.models import SAM2, BaseModel, CryoVIT, UNet3D
from cryovit_tpu_torch.models.cryovit import BF16_KERNELS
from cryovit_tpu_torch.run.dino_features import default_model_dir
from cryovit_tpu_torch.train.checkpoint import load_jax_weights, load_model, save_model
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.train.swa import StochasticWeightAveraging
from cryovit_tpu_torch.types import ModelType

logger = logging.getLogger(__name__)

__all__ = ["build_file_datamodule", "build_model", "build_trainer", "run_trainer", "run_training"]


_FAMILIES = {"cryovit": CryoVIT, "unet3d": UNet3D, "sam2": SAM2, "medsam": SAM2}


def build_model(cfg: TrainConfig) -> BaseModel:
    """The model family of ``cfg.model``, computing in the trainer's
    precision (SAM2 draws its cond slices from the run's seed)."""
    m = cfg.model
    custom = dict(m.custom_kwargs)
    if _FAMILIES[m.model_type] is SAM2:
        custom.setdefault("cond_seed", cfg.random_seed)
    return _FAMILIES[m.model_type](
        name=m.name,
        input_key=m.input_key,
        lr=m.lr,
        weight_decay=m.weight_decay,
        losses={k: LOSSES[k]() for k in m.losses},
        metrics={k: METRICS[k](threshold=m.metric_threshold) for k in m.metrics},
        custom_kwargs=custom,
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
    """CLI-mode :class:`FileDataModule` (reference ``run/train_model.py:82-92``)
    for a training or evaluation config."""
    dl = cfg.dataloader
    aux_keys = ("sam_features",) if dict(cfg.model.custom_kwargs).get("use_cache_features") else ()
    return FileDataModule(
        data_paths=data_paths,
        data_labels=data_labels,
        val_paths=val_paths,
        val_labels=val_labels,
        labels=labels,
        dataset_fn=functools.partial(
            dataset_cls, input_key=cfg.model.input_key, label_key=cfg.label_key,
            aux_keys=aux_keys,
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


def _initial_weights(ckpt_path: Path, model_type: ModelType | str) -> dict[str, torch.Tensor]:
    """A ``.model`` artifact's weights (either format), a torch state dict
    (``weights.pt``, a zip container) with the reference's names, or else
    the JAX package's ``weights.msgpack`` of a ``model_type`` model, as the
    JAX ``load_weights`` tells them apart."""
    if ckpt_path.suffix == ".model":
        module, *_ = load_model(ckpt_path, device="cpu")
        return module.state_dict()
    with open(ckpt_path, "rb") as f:
        is_torch_zip = f.read(2) == b"PK"
    if is_torch_zip:
        return torch.load(ckpt_path, map_location="cpu", weights_only=True)
    return load_jax_weights(ckpt_path, model_type)


def _sam_pretrained(model: BaseModel, cfg: TrainConfig | DotDict) -> dict | None:
    """The published SAM2 / MedSAM checkpoint under ``model_dir/<sam_name>``
    (the recipe's, or a composed config's ``paths``) as a partial state dict
    (``SAM2.load_pretrained``); None for the other families, or, with a
    warning, when the directory holds none."""
    if not isinstance(model, SAM2):
        return None
    if isinstance(cfg, DotDict):
        sam_dir = Path(str(cfg.paths.model_dir)) / str(cfg.paths.get("sam_name", "SAM2"))
    elif cfg.model_dir:
        sam_dir = Path(cfg.model_dir) / cfg.sam_name
    else:
        sam_dir = default_model_dir(cfg.sam_name)
    return model.load_pretrained(sam_dir)


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

    ``ckpt_path`` fine-tunes from a ``.model`` (either format), a
    ``weights.pt`` or the JAX package's ``weights.msgpack``. The port's
    ``.model`` already is the reference torch format, so ``export_torch``
    writes the same artifact again as ``<name>.torch.model``, the file name
    the JAX package's ``--export-torch`` gives it. ``config`` overrides the
    recipe's defaults (by default that of ``model_type``); ``num_epochs``
    sets its ``max_epochs``. On a CUDA device the trainer's precision must be
    bf16, the kernels' dtype: f32 raises before anything is built or
    written.
    """
    cfg = config or TrainConfig.for_model(ModelType(model_type).value, label_key)
    device = resolve_device(device)
    precision = cfg.trainer.precision
    require_bf16_on_cuda(device, PRECISION_DTYPES[precision],
                         f"run_training with precision {precision!r}", BF16_KERNELS)
    result_dir = Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    cfg = dataclasses.replace(
        cfg, label_key=label_key, name=model_name,
        trainer=dataclasses.replace(cfg.trainer, max_epochs=num_epochs),
    )

    model = build_model(cfg)  # MedSAM's Hiera-T is refused here, before any data is read
    datamodule = build_file_datamodule(
        cfg, data_paths=train_data, data_labels=train_labels, val_paths=val_data,
        val_labels=val_labels, labels=labels,
    )
    variables = None
    if ckpt_path is not None:
        variables = _initial_weights(Path(ckpt_path), cfg.model.model_type)
        logger.info("fine-tuning from %s", ckpt_path)

    trainer = build_trainer(cfg, device, result_dir, log_training)
    module = trainer.fit(
        model, datamodule, variables=variables,
        pretrained_variables=_sam_pretrained(model, cfg) if variables is None else None,
    )

    out_path = save_model(model_name, label_key, module, result_dir / f"{model_name}.model")
    logger.info("saved model artifact to %s", out_path)
    if export_torch:
        torch_path = save_model(model_name, label_key, module, result_dir / f"{model_name}.torch.model")
        logger.info("saved reference-readable torch artifact to %s", torch_path)
    return out_path


def run_trainer(cfg: DotDict, device: torch.device | str | None = None) -> Path:
    """Experiment-mode training (reference ``run/train_model.py:206-312``):
    validate, set up ``exp_dir/<name>/<sample>[/split_k][/test_X]``, fit on
    the splits datamodule (resuming from its ``last.ckpt`` with
    ``resume_ckpt``; SAM2's published checkpoint laid over its initial
    weights), and write ``weights.pt`` there: the ``torch.save``'d state
    dict under the reference's names, as the original CryoVIT writes it
    (the JAX package writes ``weights.msgpack``; both packages read either).
    Runs on the GPU unless ``device`` names the CPU; with
    ``trainer.mesh_shape`` on every rank of the mesh, rank 0 writing."""
    from cryovit_tpu_torch.run import common

    validate_experiment_config(cfg)
    device = resolve_device(device)
    exp_dir = common.setup_exp_dir(cfg)
    datamodule = common.build_datamodule(cfg)
    model = common.build_model(cfg, cfg.trainer.get("precision"))

    trainer = common.build_trainer(cfg, device)
    trainer.default_root_dir = exp_dir
    if cfg.get("resume_ckpt"):
        trainer.enable_checkpointing = True

    # hparam logging (reference run/train_model.py:251-287)
    if trainer.loggers and trainer.is_main:
        dm = cfg.get("datamodule", {})
        sample = dm.get("sample")
        hparams = {
            "datamodule_type": str(dm.get("_target_", "")),
            "model_name": cfg.model.name,
            "label_key": cfg.label_key,
            "experiment": cfg.name,
            "split_id": dm.get("split_id"),
            "sample": (
                "_".join(sorted(map(str, sample))) if isinstance(sample, (list, tuple)) else sample
            ),
            "test_sample": dm.get("test_sample"),
            "resume_ckpt": cfg.get("resume_ckpt"),
            "ckpt_path": cfg.get("ckpt_path"),
            "seed": cfg.get("random_seed", 42),
            "lr": cfg.model.get("lr"),
            "weight_decay": cfg.model.get("weight_decay"),
        }
        if "sam2" in str(cfg.model.get("_target_", "")).lower():
            custom = cfg.model.get("custom_kwargs") or {}
            hparams["prompt_lr"] = custom.get("prompt_lr")
        for lg in trainer.loggers:
            if hasattr(lg, "log_hparams"):
                lg.log_hparams(hparams)

    ckpt = exp_dir / "last.ckpt"
    module = trainer.fit(
        model,
        datamodule,
        ckpt_path=ckpt if cfg.get("resume_ckpt") and ckpt.exists() else None,
        pretrained_variables=_sam_pretrained(model, cfg),
    )
    weights = exp_dir / "weights.pt"
    if trainer.is_main:  # on a mesh, rank 0 writes
        torch.save({k: v.detach().cpu() for k, v in module.state_dict().items()}, weights)
        logger.info("saved weights to %s", weights)
    return exp_dir
