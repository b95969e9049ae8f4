"""CryoVIT 3D convolutional decoder over DINOv2 features.

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
  ``ops/conv3d_dm.py`` and ``ops/convt_dm.py``, wrapped in the autograd
  Functions :class:`_ConvDM` and :class:`_ConvTDM` (the JAX package's
  ``custom_vjp``s ``_conv_dm_core`` and ``_convt_core``), whose backward
  passes are kernels too. Bias, GroupNorm, GELU, clamp and sigmoid stay under
  plain autograd.
- GELU is the exact (erf) form; GroupNorm statistics are f32.
- The compute dtype is ``CryoVIT.dtype`` (``CryoVITModule(dtype=...)``):
  weights are cast to it on use, so the parameters can stay f32 masters
  while training computes in bf16. None computes in the parameters' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.ops.conv3d_dm import conv3d_dm, conv3d_dm_dw
from cryovit_tpu_torch.ops.convt_dm import convt2x_dm, convt2x_dm_bwd

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


class _ConvDM(torch.autograd.Function):
    """SAME 3³ depth-major conv (:func:`conv3d_dm`) whose backward is two
    kernel calls: the input gradient is the same conv kernel with the
    tap-flipped, in/out-swapped weights, the weight gradient
    :func:`conv3d_dm_dw` (``cryovit_tpu/models/cryovit.py:_conv_dm_bwd``)."""

    @staticmethod
    def forward(ctx, x, kernel, dilation):
        ctx.save_for_backward(x, kernel)
        ctx.dilation = dilation
        return conv3d_dm(x, kernel, dilation)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.contiguous()  # the kernel wrappers take contiguous tensors only
        dx = dw = None
        if ctx.needs_input_grad[0]:
            flipped = kernel.flip(0, 1, 2).transpose(3, 4).contiguous()
            dx = conv3d_dm(g, flipped, ctx.dilation)
        if ctx.needs_input_grad[1]:
            dw = conv3d_dm_dw(x, g, ctx.dilation).to(kernel.dtype)
        return dx, dw, None


class _ConvTDM(torch.autograd.Function):
    """2× lateral ConvTranspose (:func:`convt2x_dm`) whose backward is one
    kernel call for dx and dW (:func:`convt2x_dm_bwd`,
    ``cryovit_tpu/models/cryovit.py:_convt_bwd``)."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return convt2x_dm(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        dx, dw = convt2x_dm_bwd(g.contiguous(), x, kernel)
        return dx, dw.to(kernel.dtype)


def _dm_kernel(conv: nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    """torch Conv3d weight ``(Co, Ci, kd, kh, kw)`` → flax ``(kd, kh, kw, Ci, Co)``."""
    return conv.weight.to(dtype).permute(2, 3, 4, 1, 0)


def _dm_bias(bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return bias.to(dtype).view(1, 1, -1, 1, 1)


def _conv_cf(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """``conv`` on channels-first x with its weights cast to x's dtype."""
    return F.conv3d(
        x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
        padding=conv.padding, dilation=conv.dilation,
    )


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
        """``(B, C, D, H, W)`` → ``(B, c3, D, 2H, 2W)`` on library convs, in
        x's dtype."""
        gn, conv0, _, conv1, _, convt, _ = self.layers
        x = _group_norm(x, gn, channel_dim=1)
        x = F.gelu(_conv_cf(x, conv0))
        x = F.gelu(_conv_cf(x, conv1))
        return F.gelu(F.conv_transpose3d(
            x, convt.weight.to(x.dtype), convt.bias.to(x.dtype), stride=convt.stride
        ))

    def forward_depth_major(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, D, C, H, W)`` → ``(B, D, c3, 2H, 2W)`` on the tail kernels, in
        x's dtype."""
        gn, conv0, _, conv1, _, convt, _ = self.layers
        dt = x.dtype
        x = _group_norm(x, gn, channel_dim=2)
        x = F.gelu(_ConvDM.apply(x, _dm_kernel(conv0, dt), conv0.dilation) + _dm_bias(conv0.bias, dt))
        x = F.gelu(_ConvDM.apply(x, _dm_kernel(conv1, dt), conv1.dilation) + _dm_bias(conv1.bias, dt))
        # torch's ConvTranspose3d weight (Ci, Co, 1, 2, 2) is flax's kernel
        # with both lateral taps flipped
        kernel = convt.weight.to(dt).flip(2, 3, 4).permute(2, 3, 4, 0, 1)
        return F.gelu(_ConvTDM.apply(x, kernel) + _dm_bias(convt.bias, dt))


class CryoVIT(nn.Module):
    """CryoVIT decoder head (reference ``cryovit.py:11-49``).

    Input: ``(B, D, h, w, in_channels)`` DINOv2 patch features (h = H/16;
    1536 channels for ViT-g). Output: ``(B, D, 16·h, 16·w)`` f32 per-voxel
    probabilities. Computes in ``dtype``, or in the dtype of its parameters
    when that is None.
    """

    def __init__(self, in_channels: int = 1536, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
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
        dtype = self.dtype or proj.weight.dtype
        x = feats.to(dtype)
        # 1x1x1 projection as one channels-last matmul
        x = F.gelu(F.linear(x, proj.weight.to(dtype).flatten(1), proj.bias.to(dtype)))
        x = x.permute(0, 4, 1, 2, 3)  # (B, C, D, h, w)
        for block in blocks[:_DEPTH_MAJOR_FROM]:
            x = block.forward_channels_first(x)
        x = x.transpose(1, 2).contiguous()  # depth-major (B, D, C, H, W)
        for block in blocks[_DEPTH_MAJOR_FROM:]:
            x = block.forward_depth_major(x)
        conv1, _, conv2 = self.output_layer
        one = (1, 1, 1)
        x = F.gelu(_ConvDM.apply(x, _dm_kernel(conv1, dtype), one) + _dm_bias(conv1.bias, dtype))
        x = _ConvDM.apply(x, _dm_kernel(conv2, dtype), one)[:, :, 0] + conv2.bias.to(dtype)
        return torch.sigmoid(torch.clamp(x.float(), -5.0, 5.0))


def make_cryovit(
    state_dict: dict[str, torch.Tensor],
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
    trainable: bool = False,
) -> CryoVIT:
    """The decoder with ``state_dict`` (reference names) on ``device``; the
    feature width comes from the projection.

    For inference (the default) the parameters are in ``dtype``, frozen.
    With ``trainable`` they stay f32 (the master copy the optimizer updates)
    and ``dtype`` is the compute dtype, as ``CryoVITModule(dtype=...)``."""
    with torch.device("meta"):
        model = CryoVIT(
            in_channels=state_dict["layers.0.weight"].shape[1],
            dtype=dtype if trainable else None,
        )
    param_dtype = torch.float32 if trainable else dtype
    sd = {
        k: torch.as_tensor(v).to(device=device, dtype=param_dtype).clone()
        for k, v in state_dict.items()
    }
    model.load_state_dict(sd, strict=True, assign=True)
    if trainable:
        return model.train()
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
