"""3D U-Net baseline on raw voxels.

Port of ``cryovit_tpu/models/unet3d.py`` (reference ``models/unet3d.py``):
a 3-level isotropic U-Net. AnalysisBlocks 1→16→64→256 (two k3 convs, each
followed by InstanceNorm eps 1e-3 and exact GELU, then a k2 stride-2 conv
pool with its own norm and GELU), a bottom 256→384→256, SynthesisBlocks
64, 16, 16 (k2 stride-2 ConvTranspose, norm, GELU, skip concat, 1×1 linear
projection, norm, GELU, k3 conv, norm, GELU), a 1×1 output conv, a clip
to ±5 and a sigmoid. D, H and W must be multiples of 16 (the data pipeline
pads to 64).

- Parameters carry the reference's torch names (``analysis_layers.{i}``,
  ``bottom_layer``, ``synthesis_layers.{i}``, ``output_layer``), the names
  ``cryovit_tpu/train/torch_export.py:export_unet3d_state_dict`` writes, so
  reference state dicts load strictly.
- Level 1 (16 channels at full resolution) runs depth-major
  ``(B, D, C, H, W)``: its three 3³ convs (1→16, 16→16, and the last
  synthesis block's 16→16) go through the decoder tail's autograd Function
  :class:`~cryovit_tpu_torch.models.cryovit._ConvDM`, so the hand-written
  kernels ``conv3d_dm`` (forward and input gradient) and ``conv3d_dm_dw``
  run them on a GPU.
- Levels 2–3 and the bottom run channels-first on ``F.conv3d`` (cuDNN); the
  pool, the ConvTranspose and the 1×1 convs are plain torch ops too. The JAX
  package's matmul forms of these (``_pool2_cl``, ``_convt2_cl``) exist for
  XLA, not Pallas.
- Every norm is InstanceNorm (one group per channel) with f32 statistics,
  through :class:`_InstanceNorm`, which keeps only its input for the
  backward pass.
- The compute dtype is ``UNet3D.dtype``, as for
  :class:`~cryovit_tpu_torch.models.cryovit.CryoVIT`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.models.cryovit import _ConvDM, _dm_bias, _dm_kernel

__all__ = ["PAD_MULTIPLE", "UNet3D", "make_unet3d", "random_unet3d_state_dict"]

PAD_MULTIPLE = 16
_ANALYSIS = ((1, 16), (16, 64), (64, 256))  # (Ci, Co) per level
_SYNTHESIS = ((256, 256, 64), (64, 64, 16), (16, 16, 16))  # (Ci, skip, Co)
_BOTTOM = 384
_EPS = 1e-3


def _norm(channels: int) -> nn.InstanceNorm3d:
    return nn.InstanceNorm3d(channels, eps=_EPS, affine=True)


class _InstanceNorm(torch.autograd.Function):
    """Per-channel normalisation over every dim but batch and
    ``channel_dim``, with statistics (``torch.var_mean``, two-pass) and the
    affine in f32 (or x's dtype if wider), output in x's dtype. Saves x, the mean and 1/std; the
    backward pass recomputes x̂ from them, so a full-resolution norm keeps
    one x-sized tensor alive instead of three f32 ones."""

    @staticmethod
    def forward(ctx, x, weight, bias, channel_dim, eps):
        shape = [1] * x.dim()
        shape[channel_dim] = x.shape[channel_dim]
        dims = tuple(i for i in range(1, x.dim()) if i != channel_dim)
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
        rstd = torch.rsqrt(var + eps)
        scale = rstd * weight.to(acc).view(shape)
        y = torch.addcmul(bias.to(acc).view(shape) - mean * scale, xf, scale)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.dims, ctx.shape = dims, shape
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, gy):
        x, weight, mean, rstd = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        xhat = (x.to(mean.dtype) - mean) * rstd
        gyf = gy.to(mean.dtype)
        param_dims = (0, *dims)
        gw = (gyf * xhat).sum(param_dims)
        gb = gyf.sum(param_dims)
        g = gyf * weight.to(mean.dtype).view(shape)  # dL/dx̂
        gx = rstd * (g - g.mean(dims, keepdim=True)
                     - xhat * (g * xhat).mean(dims, keepdim=True))
        return gx.to(x.dtype), gw.to(weight.dtype), gb.to(weight.dtype), None, None


def _inorm(x: torch.Tensor, norm: nn.InstanceNorm3d, channel_dim: int = 1) -> torch.Tensor:
    return _InstanceNorm.apply(x, norm.weight, norm.bias, channel_dim, norm.eps)


def _conv(x: torch.Tensor, conv: nn.Conv3d | nn.ConvTranspose3d) -> torch.Tensor:
    """``conv`` on channels-first x with its weights cast to x's dtype."""
    w, b = conv.weight.to(x.dtype), conv.bias.to(x.dtype)
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, w, b, stride=conv.stride)
    return F.conv3d(x, w, b, stride=conv.stride, padding=conv.padding)


def _conv_dm(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
    """SAME 3³ ``conv`` on depth-major x through the tail kernels."""
    dt = x.dtype
    return _ConvDM.apply(x, _dm_kernel(conv, dt), (1, 1, 1)) + _dm_bias(conv.bias, dt)


def _pointwise_dm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A 1×1 channel mix ``(Co, Ci)`` on depth-major ``(B, D, Ci, H, W)``: a
    1×1 conv over the B·D planes."""
    b, d, ci, h, w = x.shape
    y = F.conv2d(x.view(b * d, ci, h, w), weight.to(x.dtype).view(-1, ci, 1, 1),
                 bias.to(x.dtype))
    return y.view(b, d, -1, h, w)


class AnalysisBlock(nn.Module):
    """Two k3 convs (each + InstanceNorm + GELU), then the k2 stride-2 pool
    (reference ``unet3d.py`` AnalysisBlock)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.pool = nn.Sequential(nn.Conv3d(cout, cout, 2, stride=2), _norm(cout), nn.GELU())
        self.layers = nn.Sequential(
            nn.Conv3d(cin, cout, 3, padding=1), _norm(cout), nn.GELU(),
            nn.Conv3d(cout, cout, 3, padding=1), _norm(cout), nn.GELU(),
        )

    def forward_channels_first(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, Ci, D, H, W)`` → (pooled ``(B, Co, D/2, H/2, W/2)``, skip)."""
        conv0, n0, _, conv1, n1, _ = self.layers
        x = F.gelu(_inorm(_conv(x, conv0), n0))
        skip = F.gelu(_inorm(_conv(x, conv1), n1))
        return self._pool(skip), skip

    def forward_depth_major(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, D, Ci, H, W)`` → (pooled channels-first, depth-major skip)."""
        conv0, n0, _, conv1, n1, _ = self.layers
        x = F.gelu(_inorm(_conv_dm(x, conv0), n0, channel_dim=2))
        skip = F.gelu(_inorm(_conv_dm(x, conv1), n1, channel_dim=2))
        return self._pool(skip.transpose(1, 2)), skip

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        conv, norm, _ = self.pool
        return F.gelu(_inorm(_conv(x, conv), norm))


class _LinearProjection(nn.Module):
    """1×1 channel projection (reference ``LinearProjection``: a Linear on
    the channel axis)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Linear(cin, cout)


class SynthesisBlock(nn.Module):
    """k2 stride-2 ConvTranspose + norm + GELU, skip concat, 1×1 projection
    + norm + GELU, k3 conv + norm + GELU (reference SynthesisBlock)."""

    def __init__(self, cin: int, cskip: int, cout: int):
        super().__init__()
        self.upconv = nn.Sequential(
            nn.ConvTranspose3d(cin, cout, 2, stride=2), _norm(cout), nn.GELU()
        )
        self.layers = nn.Sequential(
            _LinearProjection(cout + cskip, cout), _norm(cout), nn.GELU(),
            nn.Conv3d(cout, cout, 3, padding=1), _norm(cout), nn.GELU(),
        )

    def forward_channels_first(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        convt, n_up, _ = self.upconv
        proj, n0, _, conv, n1, _ = self.layers
        x = F.gelu(_inorm(_conv(x, convt), n_up))
        x = torch.cat([x, skip], dim=1)
        x = F.conv3d(x, proj.proj.weight.to(x.dtype)[..., None, None, None],
                     proj.proj.bias.to(x.dtype))
        x = F.gelu(_inorm(x, n0))
        return F.gelu(_inorm(_conv(x, conv), n1))

    def forward_depth_major(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        """Channels-first x from the level below and a depth-major skip →
        depth-major ``(B, D, Co, H, W)``."""
        convt, n_up, _ = self.upconv
        proj, n0, _, conv, n1, _ = self.layers
        x = _conv(x, convt).transpose(1, 2).contiguous()  # to depth-major
        x = F.gelu(_inorm(x, n_up, channel_dim=2))
        x = _pointwise_dm(torch.cat([x, skip], dim=2), proj.proj.weight, proj.proj.bias)
        x = F.gelu(_inorm(x, n0, channel_dim=2))
        return F.gelu(_inorm(_conv_dm(x, conv), n1, channel_dim=2))


class UNet3D(nn.Module):
    """The 3-level U-Net (reference ``unet3d.py:12-104``).

    Input: ``(B, D, H, W, 1)`` raw voxels, D/H/W multiples of 16. Output:
    ``(B, D, H, W)`` f32 per-voxel probabilities. Computes in ``dtype``, or
    in the dtype of its parameters when that is None.
    """

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.analysis_layers = nn.ModuleList(AnalysisBlock(ci, co) for ci, co in _ANALYSIS)
        c = _ANALYSIS[-1][1]
        self.bottom_layer = nn.Sequential(
            nn.Conv3d(c, _BOTTOM, 3, padding=1), _norm(_BOTTOM), nn.GELU(),
            nn.Conv3d(_BOTTOM, c, 3, padding=1), _norm(c), nn.GELU(),
        )
        self.synthesis_layers = nn.ModuleList(SynthesisBlock(*s) for s in _SYNTHESIS)
        self.output_layer = nn.Conv3d(_SYNTHESIS[-1][2], 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dim in x.shape[1:4]:
            if dim % PAD_MULTIPLE:
                raise ValueError(
                    f"UNet3D input dims must be multiples of {PAD_MULTIPLE}, got {tuple(x.shape)}"
                )
        dtype = self.dtype or self.output_layer.weight.dtype
        # with one channel, (B, D, H, W, 1) is already depth-major (B, D, 1, H, W)
        x = x.to(dtype).permute(0, 1, 4, 2, 3).contiguous()
        first, *rest = self.analysis_layers
        x, skip = first.forward_depth_major(x)
        skips = [skip]
        for block in rest:
            x, skip = block.forward_channels_first(x)
            skips.append(skip)
        conv0, n0, _, conv1, n1, _ = self.bottom_layer
        x = F.gelu(_inorm(_conv(x, conv0), n0))
        x = F.gelu(_inorm(_conv(x, conv1), n1))
        *outer, last = self.synthesis_layers
        for block in outer:
            x = block.forward_channels_first(x, skips.pop())
        x = last.forward_depth_major(x, skips.pop())
        out = self.output_layer
        x = _pointwise_dm(x, out.weight.flatten(1), out.bias)[:, :, 0]
        return torch.sigmoid(torch.clamp(x.float(), -5.0, 5.0))


def make_unet3d(
    state_dict: dict[str, torch.Tensor],
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
    trainable: bool = False,
) -> UNet3D:
    """The U-Net with ``state_dict`` (reference names) on ``device``; as
    :func:`~cryovit_tpu_torch.models.cryovit.make_cryovit`: frozen
    parameters in ``dtype`` for inference, or f32 masters computing in
    ``dtype`` with ``trainable``."""
    with torch.device("meta"):
        model = UNet3D(dtype=dtype if trainable else None)
    param_dtype = torch.float32 if trainable else dtype
    sd = {
        k: torch.as_tensor(v).to(device=device, dtype=param_dtype).clone()
        for k, v in state_dict.items()
    }
    model.load_state_dict(sd, strict=True, assign=True)
    if trainable:
        return model.train()
    return model.eval().requires_grad_(False)


def random_unet3d_state_dict(generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A U-Net state dict drawn with flax's init laws (lecun-normal kernels
    with the fan-in over input channels and taps, zero biases, unit norm
    scales) on the generator's device."""
    with torch.device("meta"):
        model = UNet3D()
    device = generator.device
    transposed = {n for n, m in model.named_modules() if isinstance(m, nn.ConvTranspose3d)}
    out = {}
    for name, t in model.state_dict().items():
        module = name.rsplit(".", 1)[0]
        if name.endswith(".bias"):
            out[name] = torch.zeros(t.shape, device=device)
        elif t.dim() == 1:  # norm scale
            out[name] = torch.ones(t.shape, device=device)
        else:
            # Conv3d (Co, Ci, k...), Linear (Co, Ci), ConvTranspose3d (Ci, Co, k...)
            fan_in = t.shape[0 if module in transposed else 1] * t[0, 0].numel()
            out[name] = lecun_normal(tuple(t.shape), fan_in, generator)
    return out
