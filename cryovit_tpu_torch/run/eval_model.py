"""Evaluation runners (port of ``cryovit_tpu/run/eval_model.py``).

:func:`run_evaluation` (``cryovit-torch evaluate``) scores a ``.model`` artifact (CryoVIT, UNet3D or SAM2) on explicit tomogram and
label files: :meth:`Trainer.test <cryovit_tpu_torch.train.loop.Trainer.test>`
over the files, one metrics row per tomogram in
``<result_dir>/results/<model name>/<sample>.csv`` and, with
``visualize``, the inputs, labels and probabilities in
``<result_dir>/predictions/<model name>/<sample>/<tomogram>``. The JAX
package composes ``eval_model.yaml`` here; the port builds the same recipe
from :class:`cryovit_tpu_torch.config.EvalConfig`. :func:`run_trainer` is
the experiment mode (``python -m cryovit_tpu_torch.training.eval_model``):
the trained experiment's weights on its splits datamodule's test records.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import torch

from cryovit_tpu_torch import compute_dtype, resolve_device
from cryovit_tpu_torch.callbacks import CsvWriter, TestPredictionWriter
from cryovit_tpu_torch.composer import DotDict
from cryovit_tpu_torch.config import MODELS, EvalConfig, validate_experiment_config
from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model
from cryovit_tpu_torch.train.checkpoint import load_jax_weights, load_model
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.types import BatchedModelResult

logger = logging.getLogger(__name__)

__all__ = ["load_for_eval", "run_evaluation", "run_trainer"]


def load_for_eval(
    model_path: str | Path, device: torch.device | str | None = None, **overrides
) -> tuple[torch.nn.Module, EvalConfig]:
    """A ``.model`` artifact's module on ``device`` and the evaluation
    config of its family, name and label key (``overrides`` replace config
    fields). Both compute in the device's dtype: bf16 on a GPU (the
    kernels' dtype), f32 on the CPU (as the JAX package evaluates a loaded
    model)."""
    device = resolve_device(device)
    dtype = compute_dtype(device)
    module, model_type, name, label_key = load_model(model_path, device=device, dtype=dtype)
    cfg = EvalConfig(label_key=label_key, name=name, model=MODELS[model_type.value], **overrides)
    precision = "bf16" if dtype == torch.bfloat16 else "f32"
    return module, dataclasses.replace(
        cfg, trainer=dataclasses.replace(cfg.trainer, precision=precision)
    )


def run_evaluation(
    test_data: list[Path],
    test_labels: list[Path],
    labels: list[str],
    model_path: Path,
    result_dir: Path,
    visualize: bool = False,
    device: torch.device | str | None = None,
) -> Path:
    """Evaluate a ``.model`` artifact on explicit files → the directory of
    its metrics CSVs (reference ``run/eval_model.py:21-97``)."""
    device = resolve_device(device)
    module, cfg = load_for_eval(model_path, device, visualize=visualize)
    callbacks: list = [CsvWriter(cfg.csv_dir(result_dir))]
    if cfg.visualize:
        callbacks.insert(0, TestPredictionWriter(cfg.predictions_dir(result_dir), cfg.label_key))
    datamodule = build_file_datamodule(cfg, test_data, test_labels, labels=labels)
    trainer = Trainer(**dataclasses.asdict(cfg.trainer), callbacks=callbacks,
                      seed=cfg.random_seed, device=device)
    trainer.test(build_model(cfg), datamodule, module)
    csv_dir = cfg.csv_dir(result_dir)
    logger.info("evaluation metrics written under %s", csv_dir)
    return csv_dir


def run_trainer(
    cfg: DotDict, device: torch.device | str | None = None
) -> list[BatchedModelResult]:
    """Experiment-mode evaluation (reference ``run/eval_model.py:103-197``):
    the weights the train experiment wrote in its directory — ``weights.pt``,
    or else a JAX experiment's ``weights.msgpack`` — on the datamodule's
    test records, through the writers the config names (metrics CSVs,
    prediction HDF5s). Raises ``FileNotFoundError`` when the directory holds
    neither. Runs on the GPU unless ``device`` names the CPU."""
    from cryovit_tpu_torch.run import common

    validate_experiment_config(cfg)
    device = resolve_device(device)
    exp_dir = common.setup_exp_dir(cfg)
    weights_path, jax_path = exp_dir / "weights.pt", exp_dir / "weights.msgpack"
    if not weights_path.exists() and not jax_path.exists():
        raise FileNotFoundError(
            f"no trained weights at {weights_path} (nor {jax_path.name}); run train_model first"
        )
    datamodule = common.build_datamodule(cfg)
    model = common.build_model(cfg, cfg.trainer.get("precision"))
    if weights_path.exists():
        state_dict = torch.load(weights_path, map_location="cpu", weights_only=True)
    else:
        logger.info("reading the JAX package's weights %s", jax_path)
        state_dict = load_jax_weights(jax_path, model.model_type)
    trainer = common.build_trainer(cfg, device)
    module = model.build_module(state_dict, trainer.device)
    return trainer.test(model, datamodule, module)
