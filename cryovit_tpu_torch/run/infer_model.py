"""Inference runner (port of ``cryovit_tpu/run/infer_model.py``).

Tomograms → thresholded uint8 HDF5 masks, two ways:

- fused (``fused=True``, CryoVIT only): raw tomograms → DINOv2 → CryoVIT
  decoder, the features never leaving the device;
- file-based: each file's model input (stored DINOv2 features for CryoVIT,
  raw voxels for UNet3D and SAM2) through ``FileDataModule.predict_loader``
  and ``Trainer.predict`` (with the family's ``prepare_inputs``), written by
  :class:`PredictionWriter`.

The JAX package composes a YAML config here; the port takes explicit
arguments with the same defaults (the DINOv2 weights directory is
``run.dino_features.default_model_dir()``, ``$CRYOVIT_MODEL_DIR/DINOv2``)
and :class:`cryovit_tpu_torch.config.EvalConfig` for ``infer_model.yaml``.
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch

from cryovit_tpu_torch import resolve_device
from cryovit_tpu_torch.callbacks import PredictionWriter
from cryovit_tpu_torch.data.transforms import pad_slices_to_multiple
from cryovit_tpu_torch.io import load_data
from cryovit_tpu_torch.models.dinov2 import DinoV2Config
from cryovit_tpu_torch.models.fused import FusedDinoCryoVIT
from cryovit_tpu_torch.run.dino_features import load_extractor
from cryovit_tpu_torch.run.eval_model import load_for_eval
from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model
from cryovit_tpu_torch.train.checkpoint import load_model
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.types import BatchedModelResult, ModelType

logger = logging.getLogger(__name__)

__all__ = ["fused_predictions", "load_fused", "run_inference"]


def load_fused(
    model_path: str | Path,
    model_dir: str | Path | None = None,
    random_init: bool = False,
    dino_cfg: DinoV2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    slice_batch: int = 64,
    quant_int8: bool = False,
) -> tuple[FusedDinoCryoVIT, str]:
    """The fused segmenter for a ``.model`` artifact and its label key: the
    decoder from the artifact, the backbone from ``model_dir`` (or random
    weights), both on ``device`` in ``dtype`` (default: bf16 on a GPU, f32
    on the CPU); ``quant_int8`` gives the backbone the opt-in w8a8 mode."""
    device = resolve_device(device)
    backbone = load_extractor(model_dir, random_init, dino_cfg, device, dtype, quant_int8)
    decoder, model_type, _, label_key = load_model(
        model_path, device=device, dtype=backbone.pos_embed.dtype
    )
    if model_type != ModelType.CRYOVIT:
        raise ValueError(
            "fused inference streams DINOv2 features into the CryoVIT "
            f"decoder; got model type {model_type.value!r}"
        )
    return FusedDinoCryoVIT(backbone, decoder, slice_batch=slice_batch), label_key


def fused_predictions(
    data: list[Path], fused: FusedDinoCryoVIT
) -> Iterator[BatchedModelResult]:
    """One result per raw tomogram, holding its normalized volume and its
    probabilities cropped to the volume: the step :func:`run_inference`
    runs below its HDF5 writer."""
    for path in data:
        path = Path(path)
        raw, _ = load_data(path, key="data")
        volume = raw[0]
        probs = fused.segment(pad_slices_to_multiple(volume.astype(np.float32)))
        d, h, w = volume.shape
        yield BatchedModelResult(
            batch_size=1,
            samples=[path.parent.name],
            tomo_names=[path.name],
            split_id=[None],
            data=[volume],
            label=[np.zeros_like(volume, dtype=np.int8)],
            preds=[probs[:d, :h, :w].cpu().numpy()],
            losses={},
            metrics={},
        )


def _run_fused_inference(
    data: list[Path],
    fused: FusedDinoCryoVIT,
    label_key: str,
    result_dir: Path,
    threshold: float,
) -> list[Path]:
    """Raw tomograms → fused ViT + decoder → thresholded segmentations."""
    writer = PredictionWriter(results_dir=result_dir, label_key=label_key, threshold=threshold)
    for result in fused_predictions(data, fused):
        writer.on_predict_batch_end(result)
    logger.info("fused inference wrote %d segmentations", len(writer.result_paths))
    return writer.result_paths


def _run_file_inference(
    data: list[Path],
    model_path: Path,
    result_dir: Path,
    threshold: float,
    device: torch.device | str | None,
) -> list[Path]:
    """Feature or voxel files → ``Trainer.predict`` → thresholded
    segmentations (reference ``run/infer_model.py:49-67``)."""
    device = resolve_device(device)
    module, cfg = load_for_eval(model_path, device)
    writer = PredictionWriter(results_dir=result_dir, label_key=cfg.label_key,
                              threshold=threshold)
    trainer = Trainer(**dataclasses.asdict(cfg.trainer), callbacks=[writer],
                      seed=cfg.random_seed, device=device)
    trainer.predict(build_file_datamodule(cfg, data), module, build_model(cfg))
    logger.info("wrote %d segmentations under %s", len(writer.result_paths), result_dir)
    return writer.result_paths


def run_inference(
    data: list[Path],
    model_path: Path,
    result_dir: Path,
    threshold: float = 0.5,
    fused: bool = False,
    model_dir: str | Path | None = None,
    random_init: bool = False,
    dino_cfg: DinoV2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    slice_batch: int = 64,
    quant_int8: bool = False,
) -> list[Path]:
    """Segment tomograms with a ``.model`` artifact → thresholded uint8
    HDF5s under ``result_dir`` (reference ``run/infer_model.py:18-85``).

    ``fused=True`` runs the backbone on raw tomograms (CryoVIT only; the
    backbone options ``model_dir``, ``random_init``, ``dino_cfg``,
    ``slice_batch``, ``dtype`` and ``quant_int8``, the w8a8 mode, apply to
    it). Otherwise each file holds the model's input (``dino_features`` or
    ``data``) and the model runs in the device's dtype (bf16 on a GPU, f32
    on the CPU); ``quant_int8`` then raises, as in the JAX package."""
    if not fused:
        if quant_int8:
            raise ValueError(
                "quant_int8 applies to the DINOv2 backbone and requires "
                "fused=True (file-based inference reads precomputed features)"
            )
        return _run_file_inference(data, model_path, Path(result_dir), threshold, device)
    segmenter, label_key = load_fused(
        model_path, model_dir, random_init, dino_cfg, device, dtype, slice_batch, quant_int8
    )
    return _run_fused_inference(data, segmenter, label_key, Path(result_dir), threshold)
