"""CryoVIT 3D convolutional decoder over DINOv2 features, forward only.

Port of ``cryovit_tpu/models/cryovit.py`` (reference ``models/cryovit.py``):
1×1×1 projection 1536→1024 + GELU, four SynthesisBlocks (GroupNorm
max(8, C/8) groups eps 1e-3 → k3 conv, depth dilation d1 → GELU → k3 conv,
depth dilation d2 → GELU → 2× lateral ConvTranspose → GELU), then the mask
head (k3 conv 8→8 → GELU → k3 conv 8→1), a clip to ±5 and a sigmoid. Net
effect: 16× H/W upsampling from the patch grid back to voxels; depth kept.

- Parameters carry the reference's torch names (``layers.0``,
  ``layers.{2+i}.layers.{0,1,3,5}``, ``output_layer.{0,2}``), so reference
  state dicts load strictly.
- The wide low-resolution front (projection, blocks 0–1) runs channels-first
  ``(B, C, D, H, W)`` on ``F.conv3d`` / ``F.conv_transpose3d``; the JAX
  package runs these as XLA ops outside any Pallas kernel too.
- The few-channel high-resolution tail (blocks 2–3, the head) runs
  depth-major ``(B, D, C, H, W)`` through the hand-written kernels
  ``ops/conv3d_dm.py`` and ``ops/convt_dm.py``.
- GELU is the exact (erf) form; GroupNorm statistics are f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.ops.conv3d_dm import conv3d_dm
from cryovit_tpu_torch.ops.convt_dm import convt2x_dm

__all__ = ["CryoVIT", "SynthesisBlock", "make_cryovit", "random_cryovit_state_dict"]

# (c2, c3, d1, d2) per SynthesisBlock, reference models/cryovit.py:18-34
_BLOCKS = ((192, 128, 32, 24), (64, 32, 16, 12), (32, 32, 8, 4), (16, 8, 2, 1))
_PROJ_CHANNELS = 1024
_DEPTH_MAJOR_FROM = 2  # blocks 2-3 and the head run depth-major


def _group_norm(x: torch.Tensor, gn: nn.GroupNorm, channel_dim: int) -> torch.Tensor:
    """GroupNorm with f32 statistics over (depth, channels of the group, H, W)
    for channels at ``channel_dim`` (1: channels-first, 2: depth-major),
    output in x's dtype."""
    shape = x.shape
    c = shape[channel_dim]
    g = gn.num_groups
    xg = x.float().reshape(*shape[:channel_dim], g, c // g, *shape[channel_dim + 1 :])
    dims = tuple(i for i in range(1, xg.dim()) if i != channel_dim)
    var, mean = torch.var_mean(xg, dim=dims, keepdim=True, correction=0)
    y = ((xg - mean) * torch.rsqrt(var + gn.eps)).reshape(shape)
    affine = [1] * len(shape)
    affine[channel_dim] = c
    return (y * gn.weight.float().view(affine) + gn.bias.float().view(affine)).to(x.dtype)


def _dm_kernel(conv: nn.Conv3d) -> torch.Tensor:
    """torch Conv3d weight ``(Co, Ci, kd, kh, kw)`` → flax ``(kd, kh, kw, Ci, Co)``."""
    return conv.weight.permute(2, 3, 4, 1, 0)


def _dm_bias(bias: torch.Tensor) -> torch.Tensor:
    return bias.view(1, 1, -1, 1, 1)


class SynthesisBlock(nn.Module):
    """Anisotropic upscaling block (reference ``cryovit.py:52-83``)."""

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

    def forward_channels_first(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, C, D, H, W)`` → ``(B, c3, D, 2H, 2W)`` on library convs."""
        gn, conv0, _, conv1, _, convt, _ = self.layers
        x = _group_norm(x, gn, channel_dim=1)
        x = F.gelu(conv0(x))
        x = F.gelu(conv1(x))
        return F.gelu(convt(x))

    def forward_depth_major(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, D, C, H, W)`` → ``(B, D, c3, 2H, 2W)`` on the tail kernels."""
        gn, conv0, _, conv1, _, convt, _ = self.layers
        x = _group_norm(x, gn, channel_dim=2)
        x = F.gelu(conv3d_dm(x, _dm_kernel(conv0), conv0.dilation) + _dm_bias(conv0.bias))
        x = F.gelu(conv3d_dm(x, _dm_kernel(conv1), conv1.dilation) + _dm_bias(conv1.bias))
        # torch's ConvTranspose3d weight (Ci, Co, 1, 2, 2) is flax's kernel
        # with both lateral taps flipped
        kernel = convt.weight.flip(2, 3, 4).permute(2, 3, 4, 0, 1)
        return F.gelu(convt2x_dm(x, kernel) + _dm_bias(convt.bias))


class CryoVIT(nn.Module):
    """CryoVIT decoder head (reference ``cryovit.py:11-49``).

    Input: ``(B, D, h, w, in_channels)`` DINOv2 patch features (h = H/16;
    1536 channels for ViT-g). Output: ``(B, D, 16·h, 16·w)`` f32 per-voxel
    probabilities. Computes in the dtype of its parameters.
    """

    def __init__(self, in_channels: int = 1536):
        super().__init__()
        c1 = _PROJ_CHANNELS
        blocks = []
        for c2, c3, d1, d2 in _BLOCKS:
            blocks.append(SynthesisBlock(c1, c2, c3, d1, d2))
            c1 = c3
        self.layers = nn.Sequential(
            nn.Conv3d(in_channels, _PROJ_CHANNELS, 1), nn.GELU(), *blocks
        )
        self.output_layer = nn.Sequential(
            nn.Conv3d(8, 8, 3, padding=1), nn.GELU(), nn.Conv3d(8, 1, 3, padding=1)
        )

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        proj, _, *blocks = self.layers
        dtype = proj.weight.dtype
        x = feats.to(dtype)
        # 1x1x1 projection as one channels-last matmul
        x = F.gelu(F.linear(x, proj.weight.flatten(1), proj.bias))
        x = x.permute(0, 4, 1, 2, 3)  # (B, C, D, h, w)
        for block in blocks[:_DEPTH_MAJOR_FROM]:
            x = block.forward_channels_first(x)
        x = x.transpose(1, 2).contiguous()  # depth-major (B, D, C, H, W)
        for block in blocks[_DEPTH_MAJOR_FROM:]:
            x = block.forward_depth_major(x)
        conv1, _, conv2 = self.output_layer
        x = F.gelu(conv3d_dm(x, _dm_kernel(conv1)) + _dm_bias(conv1.bias))
        x = conv3d_dm(x, _dm_kernel(conv2))[:, :, 0] + conv2.bias
        return torch.sigmoid(torch.clamp(x.float(), -5.0, 5.0))


def make_cryovit(
    state_dict: dict[str, torch.Tensor],
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> CryoVIT:
    """The decoder with ``state_dict`` (reference names) on ``device`` in
    ``dtype``, for inference; the feature width comes from the projection."""
    with torch.device("meta"):
        model = CryoVIT(in_channels=state_dict["layers.0.weight"].shape[1])
    sd = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval().requires_grad_(False)


def random_cryovit_state_dict(
    generator: torch.Generator, in_channels: int = 1536
) -> dict[str, torch.Tensor]:
    """A decoder state dict drawn with flax's init laws (lecun-normal conv
    kernels, zero biases, unit GroupNorm scales) on the generator's device."""
    with torch.device("meta"):
        template = CryoVIT(in_channels).state_dict()
    device = generator.device
    out = {}
    for name, t in template.items():
        if name.endswith(".bias"):
            out[name] = torch.zeros(t.shape, device=device)
        elif t.dim() == 1:  # GroupNorm scale
            out[name] = torch.ones(t.shape, device=device)
        else:
            # Conv3d (Co, Ci, k...) and ConvTranspose3d (Ci, Co, k...): flax
            # takes the fan-in over the input channels and the kernel taps
            is_convt = name.endswith("layers.5.weight")
            fan_in = t.shape[0 if is_convt else 1] * t[0, 0].numel()
            out[name] = lecun_normal(tuple(t.shape), fan_in, generator)
    return out
