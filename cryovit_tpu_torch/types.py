"""Registries and result containers: the part of ``cryovit_tpu/types.py``
the serving path needs (``ModelType``, ``BatchedModelResult``, ``pad_to``,
``round_up``). The JAX package's static-shape ``TomogramBatch`` pytree has no
counterpart here."""

from __future__ import annotations

import dataclasses
from enum import Enum

import numpy as np

__all__ = ["ModelType", "BatchedModelResult", "pad_to", "round_up"]


class ModelType(Enum):
    """Registry of the supported model families (reference ``types.py:49-55``)."""

    CRYOVIT = "cryovit"
    UNET3D = "unet3d"
    SAM2 = "sam2"
    MEDSAM = "medsam"


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple of ``multiple``."""
    return ((x + multiple - 1) // multiple) * multiple


def pad_to(arr: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Edge-pad ``arr`` at the trailing end of each axis up to ``shape``,
    replicating border values (ViT preprocessing, reference
    ``datasets/file_dataset.py:190-231``). The JAX package's constant mode
    has no caller on the ported path."""
    pads = [(0, t - s) for s, t in zip(arr.shape, shape)]
    if any(p[1] < 0 for p in pads):
        raise ValueError(f"cannot pad {arr.shape} to smaller {shape}")
    if all(p[1] == 0 for p in pads):
        return arr
    return np.pad(arr, pads, mode="edge")


@dataclasses.dataclass
class BatchedModelResult:
    """Per-batch predict output (numpy), reference ``types.py:192-219``.

    Attributes:
        batch_size: number of tomograms in the batch.
        samples: per-tomogram sample names.
        tomo_names: per-tomogram file names.
        split_id: optional split ids.
        data: per-tomogram raw input volumes ``(D, H, W)``.
        label: per-tomogram label volumes ``(D, H, W)``.
        preds: per-tomogram predicted probability volumes ``(D, H, W)``.
        losses: name → scalar loss over the batch.
        metrics: name → scalar metric over the batch.
    """

    batch_size: int
    samples: list[str]
    tomo_names: list[str]
    split_id: list[int | None]
    data: list[np.ndarray]
    label: list[np.ndarray]
    preds: list[np.ndarray]
    losses: dict[str, float]
    metrics: dict[str, float]
