"""Registries, host records and batch containers (port of ``cryovit_tpu/types.py``).

- host-side records are plain numpy (:class:`FileData`, :class:`TomogramData`);
- a batch (:class:`TomogramBatch`) is numpy padded to a bucket shape, with
  labels padded to −1 so the masked losses and metrics ignore the padding;
  the trainer moves it to the device. The JAX package registers it as a
  pytree; here it is a plain dataclass.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from pathlib import Path
from typing import Any

import numpy as np

__all__ = [
    "BatchedModelResult",
    "FileData",
    "ModelType",
    "Sample",
    "TomogramBatch",
    "TomogramData",
    "pad_to",
    "round_up",
]


class Sample(Enum):
    """Registry of all valid CryoET samples (reference ``types.py:15-47``)."""

    BACHD = "BACHD"
    BACHD_Microtubules = "BACHD Microtubules"
    dN17_BACHD = "dN17 BACHD"
    Q109 = "Q109"
    Q109_Microtubules = "Q109 Microtubules"
    Q18 = "Q18"
    Q18_Microtubules = "Q18 Microtubules"
    Q20 = "Q20"
    Q53 = "Q53"
    Q53_KD = "Q53 PIAS1"
    Q66 = "Q66"
    Q66_GRFS1 = "Q66 GRFS1"
    Q66_KD = "Q66 PIAS1"
    WT = "Wild Type"
    WT_Microtubules = "Wild Type Microtubules"
    cancer = "Cancer"
    AD = "AD"
    AD_Abeta = "AD Abeta"
    Aged = "Aged"
    Young = "Young"
    RGC_CM = "RGC CM"
    RGC_control = "RGC Control"
    RGC_naPP = "RGC naPP"
    RGC_PP = "RGC PP"
    CZI_Algae = "Algae"
    CZI_Campy_C = "Campy C"
    CZI_Campy_CDel = "Campy C-Deletion"
    CZI_Campy_F = "Campy F"
    CZI_Fibroblast = "Mouse Fibroblast"


class ModelType(Enum):
    """Registry of the supported model families (reference ``types.py:49-55``)."""

    CRYOVIT = "cryovit"
    UNET3D = "unet3d"
    SAM2 = "sam2"
    MEDSAM = "medsam"


@dataclasses.dataclass
class FileData:
    """File paths + metadata for a single tomogram (reference ``types.py:61-76``)."""

    tomo_path: Path
    label_path: Path | None = None
    labels: list[str] | None = None
    sample: str | None = None


@dataclasses.dataclass
class TomogramData:
    """Host-side record for one tomogram.

    Attributes:
        sample: experiment sample name.
        tomo_name: source file name.
        split_id: optional split identifier.
        data: input volume, channels-last ``(D, H, W, C)`` (DINOv2 features
            ``(D, h, w, 1536)``; the HDF5 file stores ``(C, D, h, w)``).
        label: ``(D, H, W)`` int8 labels with −1 = unlabeled / ignore.
        aux_data: optional extra host arrays (e.g. raw volume for writers).
    """

    sample: str
    tomo_name: str
    split_id: int | None
    data: np.ndarray
    label: np.ndarray
    aux_data: dict[str, Any] | None = None

    @property
    def depth(self) -> int:
        return int(self.data.shape[0])


@dataclasses.dataclass
class TomogramBatch:
    """A batch of tomograms padded to one bucket shape.

    Attributes:
        data: ``(B, D, H, W, C)`` input (voxels or DINOv2 features).
        label: ``(B, D, H, W)`` int8 labels, −1 = ignore (padding included).
        num_slices: ``(B,)`` int32 true depth of each tomogram.
    """

    data: np.ndarray
    label: np.ndarray
    num_slices: np.ndarray

    @property
    def num_tomos(self) -> int:
        return int(self.data.shape[0])


def round_up(x: int, multiple: int) -> int:
    """Round ``x`` up to the nearest multiple of ``multiple``."""
    return ((x + multiple - 1) // multiple) * multiple


def pad_to(
    arr: np.ndarray,
    shape: tuple[int, ...],
    *,
    value: float = 0.0,
    mode: str = "constant",
) -> np.ndarray:
    """Pad ``arr`` at the trailing end of each axis up to ``shape``.

    ``mode='edge'`` replicates border values (ViT preprocessing, reference
    ``datasets/file_dataset.py:190-231``); the constant mode fills ``value``
    (batch collation: 0 for data, −1 for labels).
    """
    pads = [(0, t - s) for s, t in zip(arr.shape, shape)]
    if any(p[1] < 0 for p in pads):
        raise ValueError(f"cannot pad {arr.shape} to smaller {shape}")
    if all(p[1] == 0 for p in pads):
        return arr
    if mode == "constant":
        return np.pad(arr, pads, mode="constant", constant_values=value)
    return np.pad(arr, pads, mode=mode)


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
