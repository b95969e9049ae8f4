"""3D U-Net prompt predictor for SAM2.

Port of ``cryovit_tpu/models/sam2/prompt_predictor.py`` (reference
``models/sam2_blocks.py:14-223``): a small 3D U-Net over the stride-4 level
of the backbone that predicts, for every slice, a dense mask prompt and a
box.

- a conv block is Conv3d(k3, no bias) + instance norm (no affine, eps 1e-5,
  statistics in f32) + exact GELU;
- down blocks max-pool 2× (only the axes that can still halve), up blocks
  resize with aligned corners to the skip's size, concatenate [skip, x] and
  run two conv blocks;
- the mask head is a 1×1×1 conv and a 4× upsampling with aligned corners;
  the box head a per-slice average pool and a Linear → sigmoid, corners
  ``(x1y1, x1y1 + wh)`` unclipped.

Parameters carry the reference's names (``init_conv.layers.{0,1}.conv``,
``down_layers.{i}.layers.{1,2}.conv`` after the max-pool at index 0,
``up_layers.{j}.layers.{0,1}.conv`` with j counted from the bottom of the
U-Net, ``prompt_out``, ``box_out.fc``). The volume stays channels-first
inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models.sam2.layers import Conv3d, Linear
from cryovit_tpu_torch.ops.resize import align_corners_resize_matrix

__all__ = ["PromptPredictor"]


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over (D, H, W) in f32 (flax
    ``GroupNorm(num_groups=C)``: variance as E[x²] − mean²)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3, 4), keepdim=True)
    var = (xf * xf).mean(dim=(2, 3, 4), keepdim=True) - mean * mean
    return (xf - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv3d(cin, cout, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(_instance_norm(self.conv(x))).to(x.dtype)


class _Blocks(nn.Module):
    def __init__(self, layers: list[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _BoxOut(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.fc = Linear(cin, 4)


def _resize_align_corners(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Resize the last three axes of ``(B, C, D, H, W)`` to ``shape``, one
    matrix product per axis that changes, in x's dtype."""
    for axis, size in enumerate(shape):
        dim = 2 + axis
        if x.shape[dim] == size:
            continue
        mat = torch.from_numpy(align_corners_resize_matrix(x.shape[dim], size).copy())
        mat = mat.to(device=x.device, dtype=x.dtype)
        x = torch.movedim(torch.tensordot(mat, torch.movedim(x, dim, 0), dims=([1], [0])), 0, dim)
    return x


class PromptPredictor(nn.Module):
    """``forward(feats (B, D, h, w, C))`` → (boxes ``(B·D, 4)`` in [0, 1]
    f32, mask prompt logits ``(B·D, 4h, 4w, 1)`` f32), computing in
    ``dtype``."""

    def __init__(self, in_channels: int = 256, hidden_channels: int = 16, depth: int = 4,
                 channel_mults: tuple[int, ...] = (1, 2, 4, 8, 10), scale_factor: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depth, self.scale_factor, self.dtype = depth, scale_factor, dtype
        ch = [m * hidden_channels for m in channel_mults]
        self.init_conv = _Blocks([_ConvBlock(in_channels, ch[0]), _ConvBlock(ch[0], ch[0])])
        self.down_layers = nn.ModuleList(
            _Blocks([nn.Identity(), _ConvBlock(ch[i], ch[i + 1]), _ConvBlock(ch[i + 1], ch[i + 1])])
            for i in range(depth)
        )
        self.up_layers = nn.ModuleList(
            _Blocks([_ConvBlock(ch[i] + ch[i + 1], ch[i]), _ConvBlock(ch[i], ch[i])])
            for i in reversed(range(depth))
        )
        self.prompt_out = Conv3d(ch[0], 1, 1)
        self.box_out = _BoxOut(ch[0])

    def forward(self, feats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        b, d, h, w, _ = feats.shape
        x = feats.to(self.dtype).permute(0, 4, 1, 2, 3)
        for blk in self.init_conv.layers:
            x = blk(x)
        skips = []
        for down in self.down_layers:
            skips.append(x)
            win = tuple(2 if s >= 2 else 1 for s in x.shape[2:])
            x = F.max_pool3d(x, win, win)
            x = down.layers[2](down.layers[1](x))
        for up in self.up_layers:
            skip = skips.pop()
            x = torch.cat([skip, _resize_align_corners(x, tuple(skip.shape[2:]))], dim=1)
            x = up.layers[1](up.layers[0](x))

        prompt = self.prompt_out(x).float().reshape(b * d, 1, 1, h, w)
        s = self.scale_factor
        prompt = _resize_align_corners(prompt, (1, h * s, w * s))[:, 0, 0, :, :, None]

        pooled = x.float().mean(dim=(3, 4)).permute(0, 2, 1).reshape(b * d, -1)
        box = torch.sigmoid(self.box_out.fc(pooled))
        return torch.cat([box[:, :2], box[:, :2] + box[:, 2:]], dim=-1), prompt
