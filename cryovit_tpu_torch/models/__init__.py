"""Model families: the CryoVIT decoder over DINOv2 features, the 3D U-Net
baseline on raw voxels and the SAM2 / MedSAM family (``models/sam2``)."""

from __future__ import annotations

import torch
from torch import nn

from cryovit_tpu_torch.models import losses, metrics
from cryovit_tpu_torch.models.base import BaseModel, prediction_mask
from cryovit_tpu_torch.models.cryovit import CryoVIT as CryoVITModule
from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
from cryovit_tpu_torch.models.sam2.family import SAM2
from cryovit_tpu_torch.models.unet3d import (
    PAD_MULTIPLE,
    SLAB_MULTIPLE,
    make_unet3d,
    random_unet3d_state_dict,
)
from cryovit_tpu_torch.models.unet3d import UNet3D as UNet3DModule
from cryovit_tpu_torch.types import ModelType

__all__ = [
    "BaseModel",
    "CryoVIT",
    "CryoVITModule",
    "ModelType",
    "PAD_MULTIPLE",
    "SAM2",
    "UNet3D",
    "UNet3DModule",
    "losses",
    "metrics",
    "prediction_mask",
]


class CryoVIT(BaseModel):
    """CryoVIT decoder over DINOv2 features (reference ``models/cryovit.py``)."""

    model_type = ModelType.CRYOVIT
    depth_shardable = True

    def build_module(
        self,
        state_dict: dict[str, torch.Tensor] | None,
        device: torch.device,
        generator: torch.Generator | None = None,
        in_channels: int | None = None,
    ) -> nn.Module:
        """The trainable decoder (f32 parameters, computing in ``dtype``)
        with ``state_dict``, or with weights drawn from ``generator`` by
        flax's init laws for ``in_channels`` features."""
        if state_dict is None:
            state_dict = random_cryovit_state_dict(generator, in_channels or 1536)
        return make_cryovit(state_dict, device=device, dtype=self.dtype, trainable=True)


class UNet3D(BaseModel):
    """End-to-end 3D U-Net on raw voxels (reference ``models/unet3d.py``)."""

    model_type = ModelType.UNET3D
    depth_shardable = True
    depth_multiple = SLAB_MULTIPLE  # each level's slab even under its stride-2 pool

    def build_module(
        self,
        state_dict: dict[str, torch.Tensor] | None,
        device: torch.device,
        generator: torch.Generator | None = None,
        in_channels: int | None = None,
    ) -> nn.Module:
        """The trainable U-Net (f32 parameters, computing in ``dtype``) with
        ``state_dict``, or with weights drawn from ``generator`` by flax's
        init laws (``in_channels`` is always 1: raw voxels)."""
        if state_dict is None:
            state_dict = random_unet3d_state_dict(generator)
        return make_unet3d(state_dict, device=device, dtype=self.dtype, trainable=True)
