"""Plain CryoVIT decoder (VivianDLi/CryoVIT ``src/cryovit/models/cryovit.py``),
float32, channels-first, on ``torch.nn`` layers, for the benchmark's check.

A 1×1×1 projection 1536→1024 and GELU, four synthesis blocks (GroupNorm
max(8, C/8) groups eps 1e-3 → 3³ conv of depth dilation d1 → GELU → 3³
conv of depth dilation d2 → GELU → (1, 2, 2) stride-(1, 2, 2)
ConvTranspose → GELU), the mask head (3³ conv 8→8 → GELU → 3³ conv 8→1),
a clip to ±5 and a sigmoid. The reference's parameter names.

``round_operands`` (default: none) is applied to each product's input and
weight: the benchmark's control computes the same decoder with its
operands rounded to a lower precision.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class SynthesisBlock(nn.Module):
    def __init__(self, c1: int, c2: int, c3: int, d1: int, d2: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.GroupNorm(max(8, c1 // 8), c1, eps=1e-3),
            nn.Conv3d(c1, c2, 3, padding=(d1, 1, 1), dilation=(d1, 1, 1)),
            nn.GELU(),
            nn.Conv3d(c2, c2, 3, padding=(d2, 1, 1), dilation=(d2, 1, 1)),
            nn.GELU(),
            nn.ConvTranspose3d(c2, c3, (1, 2, 2), stride=(1, 2, 2)),
            nn.GELU(),
        )


def _conv(conv: nn.Conv3d, x: torch.Tensor, q) -> torch.Tensor:
    return F.conv3d(q(x), q(conv.weight), conv.bias, padding=conv.padding,
                    dilation=conv.dilation)


class CryoVIT(nn.Module):
    """``forward((B, C, D, h, w) features)`` → ``(B, D, 16h, 16w)``
    probabilities."""

    def __init__(self, cfg: dict):
        super().__init__()
        dec = cfg["decoder"]
        c1 = width = dec["proj_channels"]
        blocks = []
        for c2, c3, d1, d2 in dec["blocks"]:
            blocks.append(SynthesisBlock(c1, c2, c3, d1, d2))
            c1 = c3
        self.layers = nn.Sequential(nn.Conv3d(cfg["embed_dim"], width, 1), nn.GELU(), *blocks)
        head = dec["head_channels"]
        self.output_layer = nn.Sequential(
            nn.Conv3d(c1, head, 3, padding=1), nn.GELU(), nn.Conv3d(head, 1, 3, padding=1))
        self.round_operands = _same

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.round_operands
        proj, _, *blocks = self.layers
        x = F.gelu(_conv(proj, x, q))
        for block in blocks:
            gn, conv0, _, conv1, _, convt, _ = block.layers
            x = gn(x)
            x = F.gelu(_conv(conv0, x, q))
            x = F.gelu(_conv(conv1, x, q))
            x = F.gelu(F.conv_transpose3d(q(x), q(convt.weight), convt.bias, stride=convt.stride))
        conv1, _, conv2 = self.output_layer
        x = _conv(conv2, F.gelu(_conv(conv1, x, q)), q)
        return torch.sigmoid(torch.clamp(x[:, 0], -5.0, 5.0))
