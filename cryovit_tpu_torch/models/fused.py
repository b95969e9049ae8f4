"""Fused DINOv2 → CryoVIT pipeline: raw slices in, per-voxel probabilities
out, with the features kept on the device.

Port of ``cryovit_tpu/models/fused.py``. The JAX package compiles the whole
pipeline into one program and scans the backbone over slice chunks; here the
same steps run eagerly, with a Python loop over chunks of ``slice_batch``
slices bounding the backbone's activation memory.
"""

from __future__ import annotations

import numpy as np
import torch

from cryovit_tpu_torch.data.transforms import dino_device_preprocess, dino_grid_shape
from cryovit_tpu_torch.models.cryovit import CryoVIT
from cryovit_tpu_torch.models.dinov2 import DinoV2

__all__ = ["FusedDinoCryoVIT"]


class FusedDinoCryoVIT:
    """End-to-end tomogram segmentation: slices → ViT features → decoder.

    The two models stay separate modules (the decoder can come from any
    trained CryoVIT artifact while the backbone is shared and frozen); both
    must live on the same device.
    """

    def __init__(self, backbone: DinoV2, decoder: CryoVIT, slice_batch: int = 64) -> None:
        self.backbone = backbone
        self.decoder = decoder
        self.slice_batch = slice_batch
        self.device = backbone.pos_embed.device

    @torch.inference_mode()
    def segment(self, slices: np.ndarray | torch.Tensor) -> torch.Tensor:
        """``(D, H, W)`` padded-to-16 stack → ``(D, H, W)`` f32 probabilities
        on the device. f32 input is taken as already normalized; uint8
        transfers raw and is scaled to [0, 1] on the device."""
        x = torch.as_tensor(slices).to(self.device)
        d, h, w = x.shape
        gh, gw = dino_grid_shape(h, w)
        feats = torch.cat(
            [self.backbone(dino_device_preprocess(chunk)) for chunk in x.split(self.slice_batch)]
        )  # (D, gh·gw, C) f32, never leaves the device
        feats = feats.view(1, d, gh, gw, -1)
        return self.decoder(feats)[0]
