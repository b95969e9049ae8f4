"""Inference runner (port of ``cryovit_tpu/run/infer_model.py``), fused path.

Raw tomograms → DINOv2 → CryoVIT decoder → thresholded uint8 HDF5 masks.
The JAX package composes a YAML config here; the port takes explicit
arguments with the same defaults (the DINOv2 weights directory is
``run.dino_features.default_model_dir()``, ``$CRYOVIT_MODEL_DIR/DINOv2``).
"""

from __future__ import annotations

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
from cryovit_tpu_torch.train.checkpoint import load_model
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
) -> tuple[FusedDinoCryoVIT, str]:
    """The fused segmenter for a ``.model`` artifact and its label key: the
    decoder from the artifact, the backbone from ``model_dir`` (or random
    weights), both on ``device`` in ``dtype`` (default: bf16 on a GPU, f32
    on the CPU)."""
    device = resolve_device(device)
    backbone = load_extractor(model_dir, random_init, dino_cfg, device, dtype)
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
) -> list[Path]:
    """Segment raw tomograms with a ``.model`` artifact → thresholded uint8
    HDF5s (reference ``run/infer_model.py:18-85``). Only the fused path
    (``fused=True``: the backbone runs on the raw slices, no feature files)
    is ported so far."""
    if not fused:
        raise NotImplementedError(
            "file-based inference is not yet ported; use fused=True (--fused)"
        )
    segmenter, label_key = load_fused(
        model_path, model_dir, random_init, dino_cfg, device, dtype, slice_batch
    )
    return _run_fused_inference(data, segmenter, label_key, Path(result_dir), threshold)
