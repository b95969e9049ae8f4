"""Model families. Ported so far: the CryoVIT decoder over DINOv2 features
(``UNet3D`` and ``SAM2`` are not ported yet)."""

from __future__ import annotations

import torch
from torch import nn

from cryovit_tpu_torch.models import losses, metrics
from cryovit_tpu_torch.models.base import BaseModel, prediction_mask
from cryovit_tpu_torch.models.cryovit import CryoVIT as CryoVITModule
from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
from cryovit_tpu_torch.types import ModelType

__all__ = [
    "BaseModel",
    "CryoVIT",
    "CryoVITModule",
    "ModelType",
    "losses",
    "metrics",
    "prediction_mask",
]


class CryoVIT(BaseModel):
    """CryoVIT decoder over DINOv2 features (reference ``models/cryovit.py``)."""

    model_type = ModelType.CRYOVIT

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
