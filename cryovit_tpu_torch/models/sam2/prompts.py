"""SAM prompt encoder: boxes, the padding point and dense mask prompts.

Port of ``cryovit_tpu/models/sam2/prompts.py`` (sam2 ``PromptEncoder``):
random-Fourier encoding of point coordinates, learned per-label embeddings
(box corners are labels 2 and 3, the padding point label −1), and a small
conv net taking a dense mask prompt down to the embedding grid. The
reference drives it with box + predicted-mask prompts only
(``models/sam2.py:670-740``). Parameters carry the published sam2 names
(``pe_layer``, ``point_embeddings.{i}``, ``mask_downscaling.{0,1,3,4,6}``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.layers import Conv2d, LayerNorm

__all__ = ["PromptEncoder", "random_position_encoding"]


def random_position_encoding(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """Fourier features of [0, 1] coordinates (sam ``PositionEmbeddingRandom``):
    coords ``(..., 2)``, gaussian ``(2, dim/2)`` → ``(..., dim)`` f32."""
    proj = 2 * math.pi * ((2.0 * coords.float() - 1.0) @ gaussian.float())
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


class _PELayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(torch.zeros(2, d // 2))


class PromptEncoder(nn.Module):
    """``forward(boxes (B, 4) pixels, masks (B, S, S, 1) | None)`` →
    (sparse tokens ``(B, 3, d)``, dense embeddings ``(B, e, e, d)``) in
    ``dtype``."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.d_model
        self.pe_layer = _PELayer(d)
        # 0: negative point, 1: positive point, 2: box TL, 3: box BR
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, d) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, d)
        self.no_mask_embed = nn.Embedding(1, d)
        self.mask_downscaling = nn.ModuleList([
            Conv2d(1, 4, 2, 2), LayerNorm(4, eps=1e-6), nn.GELU(),
            Conv2d(4, 16, 2, 2), LayerNorm(16, eps=1e-6), nn.GELU(),
            Conv2d(16, d, 1),
        ])

    @property
    def gaussian(self) -> torch.Tensor:
        return self.pe_layer.positional_encoding_gaussian_matrix

    def dense_pe(self) -> torch.Tensor:
        """``(e, e, d)`` f32 positional encoding of the embedding grid."""
        e = self.cfg.embed_size
        t = (torch.arange(e, dtype=torch.float32, device=self.gaussian.device) + 0.5) / e
        ys, xs = torch.meshgrid(t, t, indexing="ij")
        return random_position_encoding(torch.stack([xs, ys], dim=-1), self.gaussian)

    def encode_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """``(B, 4)`` pixel boxes → ``(B, 2, d)`` f32 corner tokens."""
        coords = (boxes.float().reshape(-1, 2, 2) + 0.5) / self.cfg.image_size
        pe = random_position_encoding(coords, self.gaussian)
        pts = self.point_embeddings
        return torch.stack([pe[:, 0] + pts[2].weight[0], pe[:, 1] + pts[3].weight[0]], dim=1)

    def encode_masks(self, masks: torch.Tensor | None, batch: int) -> torch.Tensor:
        if masks is None:
            e = self.cfg.embed_size
            return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(batch, e, e, -1)
        x = masks.to(self.dtype)
        for layer in self.mask_downscaling:
            x = F.gelu(x) if isinstance(layer, nn.GELU) else layer(x)
        return x

    def forward(self, boxes: torch.Tensor, masks: torch.Tensor | None):
        b = boxes.shape[0]
        pad = self.not_a_point_embed.weight.reshape(1, 1, -1).expand(b, 1, -1)
        sparse = torch.cat([pad.float(), self.encode_boxes(boxes)], dim=1).to(self.dtype)
        return sparse, self.encode_masks(masks, b).to(self.dtype)
