"""Preprocessing for ViT feature extraction (port of
``cryovit_tpu/data/transforms.py``, DINOv2 part).

- **host** (numpy): edge-pad H/W up to multiples of 16, once per tomogram;
- **device** (torch): the bicubic 14/16 resize as two matmuls
  (:mod:`cryovit_tpu_torch.ops.resize`), so one 14-px DINO patch covers 16
  voxels. ImageNet normalization and the 3-channel replication are folded
  into the patch-embed weights at conversion (``convert.fold_patch_embed``).
"""

from __future__ import annotations

import numpy as np
import torch

from cryovit_tpu_torch.ops.resize import resize_bicubic_2d
from cryovit_tpu_torch.types import pad_to, round_up

__all__ = [
    "DINO_PATCH_SIZE",
    "dino_device_preprocess",
    "dino_grid_shape",
    "pad_slices_to_multiple",
]

DINO_PATCH_SIZE = 14


def pad_slices_to_multiple(data: np.ndarray, multiple: int = 16) -> np.ndarray:
    """Edge-pad the trailing H/W of a ``(D, H, W)`` stack up to multiples of
    ``multiple`` (reference ``file_dataset.py:207-219``)."""
    h, w = data.shape[-2:]
    target = data.shape[:-2] + (round_up(h, multiple), round_up(w, multiple))
    return pad_to(data, target, mode="edge")


def dino_grid_shape(h: int, w: int) -> tuple[int, int]:
    """DINO patch-grid (gh, gw) for a padded (h, w) slice: the 14/16 rescale
    maps 16 voxels onto one 14-px patch, so grid = (h//16, w//16)."""
    if h % 16 or w % 16:
        raise ValueError(f"slice dims must be multiples of 16, got {(h, w)}")
    return h // 16, w // 16


def dino_device_preprocess(slices: torch.Tensor) -> torch.Tensor:
    """``(B, H, W)`` slices on the device → f32 ``(B, 14·H/16, 14·W/16)``.

    uint8 slices are scaled to [0, 1] here, on the device (a quarter of the
    host-to-device bytes of f32); any other dtype is taken as already
    normalized.
    """
    gh, gw = dino_grid_shape(*slices.shape[-2:])
    x = slices.float()
    if slices.dtype == torch.uint8:
        x = x * (1.0 / 255.0)
    return resize_bicubic_2d(x, gh * DINO_PATCH_SIZE, gw * DINO_PATCH_SIZE)
