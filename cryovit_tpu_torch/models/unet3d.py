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
- Depth-sharded (``forward(x, mesh=...)``, ``parallel/spatial.py``), as
  CryoVIT's decoder: each rank holds a slab of consecutive slices. Every k3
  conv takes one slice of each neighbour first
  (:func:`~cryovit_tpu_torch.parallel.halo_exchange`): the channels-first
  ``F.conv3d`` calls of levels 2–3 and the bottom then run with depth
  padding 0, and level 1's tail kernels, which pad "same" themselves, run on
  the halo'd slab and their two halo outputs are dropped. Every
  InstanceNorm takes its statistics over the whole depth (the sums
  all-reduced inside :class:`_InstanceNorm`, in the forward pass and in the
  backward's two reductions). The rest needs no exchange when each level's
  slab has an even depth: a k2 stride-2 pool's output slice ``j`` reads
  input slices ``2j`` and ``2j + 1``, both in the slab when it starts at an
  even slice (an odd slab would split a pair between two ranks), and a k2
  stride-2 ConvTranspose's input slice ``j`` writes output slices ``2j`` and
  ``2j + 1`` only, so each slab's upsampling is the finer slab of the same
  rank, the one its skip holds; the 1×1 convs, GELU and the skip concat are
  per voxel. Hence a slab of a multiple of :data:`SLAB_MULTIPLE` slices
  (``2 ** pools``). The JAX package lets GSPMD partition this network
  whenever the depth divides the mesh, with its Pallas kernels off; the
  port keeps level 1's kernels, as they compute the same per-slab conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.models.cryovit import _conv_cf, _dm_bias, _dm_kernel, _sharded
from cryovit_tpu_torch.models.cryovit import _conv_dm as _slab_conv_dm
from cryovit_tpu_torch.parallel.mesh import Mesh

__all__ = ["PAD_MULTIPLE", "SLAB_MULTIPLE", "UNet3D", "make_unet3d", "random_unet3d_state_dict"]

PAD_MULTIPLE = 16
_ANALYSIS = ((1, 16), (16, 64), (64, 256))  # (Ci, Co) per level
_SYNTHESIS = ((256, 256, 64), (64, 64, 16), (16, 16, 16))  # (Ci, skip, Co)
_BOTTOM = 384
_EPS = 1e-3
# a depth slab's multiple under a depth-sharded mesh: each analysis level
# ends in one k2 stride-2 pool, and every level's slab must stay even
SLAB_MULTIPLE = 2 ** len(_ANALYSIS)


def _norm(channels: int) -> nn.InstanceNorm3d:
    return nn.InstanceNorm3d(channels, eps=_EPS, affine=True)


class _InstanceNorm(torch.autograd.Function):
    """Per-channel normalisation over every dim but batch and
    ``channel_dim``, with statistics (two-pass: the mean, then the centred
    squares) and the affine in f32 (or x's dtype if wider), output in x's
    dtype. Saves x, the mean and 1/std; the backward pass recomputes x̂ from
    them, so a full-resolution norm keeps one x-sized tensor alive instead
    of three f32 ones. With a depth-sharded ``mesh`` x is this rank's slab
    and the statistics cover every rank's: the sums of both forward passes,
    and the backward's two (of the gradient and of its product with x̂, in
    one collective), are all-reduced. The affine's gradients stay this
    rank's share, which the trainer sums over the ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, channel_dim, eps, mesh=None):
        shape = [1] * x.dim()
        shape[channel_dim] = x.shape[channel_dim]
        dims = tuple(i for i in range(1, x.dim()) if i != channel_dim)
        acc = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(acc)
        if _sharded(mesh):
            count = x[0].numel() // x.shape[channel_dim] * mesh.size
            mean = mesh.all_reduce_(xf.sum(dims, keepdim=True)) / count
            var = mesh.all_reduce_((xf - mean).square().sum(dims, keepdim=True)) / count
        else:
            count = None
            var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
        rstd = torch.rsqrt(var + eps)
        scale = rstd * weight.to(acc).view(shape)
        y = torch.addcmul(bias.to(acc).view(shape) - mean * scale, xf, scale)
        ctx.save_for_backward(x, weight, mean, rstd)
        ctx.dims, ctx.shape, ctx.mesh, ctx.count = dims, shape, mesh, count
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
        if ctx.count is None:
            g_mean, gx_mean = g.mean(dims, keepdim=True), (g * xhat).mean(dims, keepdim=True)
        else:
            sums = ctx.mesh.all_reduce_(torch.stack(
                [g.sum(dims, keepdim=True), (g * xhat).sum(dims, keepdim=True)]))
            g_mean, gx_mean = sums / ctx.count
        gx = rstd * (g - g_mean - xhat * gx_mean)
        return gx.to(x.dtype), gw.to(weight.dtype), gb.to(weight.dtype), None, None, None


def _inorm(
    x: torch.Tensor, norm: nn.InstanceNorm3d, channel_dim: int = 1, mesh: Mesh | None = None
) -> torch.Tensor:
    return _InstanceNorm.apply(x, norm.weight, norm.bias, channel_dim, norm.eps, mesh)


def _conv(
    x: torch.Tensor, conv: nn.Conv3d | nn.ConvTranspose3d, mesh: Mesh | None = None
) -> torch.Tensor:
    """``conv`` on channels-first x with its weights cast to x's dtype;
    depth-sharded, a k3 conv on the slab with its halos (as CryoVIT's
    front), a pool or ConvTranspose on the slab alone (local: module
    docstring)."""
    if isinstance(conv, nn.ConvTranspose3d):
        return F.conv_transpose3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                                  stride=conv.stride)
    if conv.stride[0] == 1:
        return _conv_cf(x, conv, mesh)
    return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=conv.stride,
                    padding=conv.padding)


def _conv_dm(x: torch.Tensor, conv: nn.Conv3d, mesh: Mesh | None = None) -> torch.Tensor:
    """SAME 3³ ``conv`` on depth-major x through the tail kernels (with a
    depth-sharded ``mesh``, on the slab with its halos, as CryoVIT's)."""
    dt = x.dtype
    return _slab_conv_dm(x, _dm_kernel(conv, dt), (1, 1, 1), mesh) + _dm_bias(conv.bias, dt)


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

    def forward_channels_first(
        self, x: torch.Tensor, mesh: Mesh | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, Ci, D, H, W)`` → (pooled ``(B, Co, D/2, H/2, W/2)``, skip)
        (``mesh``: x is this rank's depth slab)."""
        conv0, n0, _, conv1, n1, _ = self.layers
        x = F.gelu(_inorm(_conv(x, conv0, mesh), n0, mesh=mesh))
        skip = F.gelu(_inorm(_conv(x, conv1, mesh), n1, mesh=mesh))
        return self._pool(skip, mesh), skip

    def forward_depth_major(
        self, x: torch.Tensor, mesh: Mesh | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, D, Ci, H, W)`` → (pooled channels-first, depth-major skip)."""
        conv0, n0, _, conv1, n1, _ = self.layers
        x = F.gelu(_inorm(_conv_dm(x, conv0, mesh), n0, 2, mesh))
        skip = F.gelu(_inorm(_conv_dm(x, conv1, mesh), n1, 2, mesh))
        return self._pool(skip.transpose(1, 2), mesh), skip

    def _pool(self, x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
        conv, norm, _ = self.pool
        return F.gelu(_inorm(_conv(x, conv), norm, mesh=mesh))


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

    def forward_channels_first(
        self, x: torch.Tensor, skip: torch.Tensor, mesh: Mesh | None = None
    ) -> torch.Tensor:
        """``(B, Ci, D, H, W)`` from the level below and the skip → ``(B, Co,
        2D, 2H, 2W)`` (``mesh``: both are this rank's depth slabs)."""
        convt, n_up, _ = self.upconv
        proj, n0, _, conv, n1, _ = self.layers
        x = F.gelu(_inorm(_conv(x, convt), n_up, mesh=mesh))
        x = torch.cat([x, skip], dim=1)
        x = F.conv3d(x, proj.proj.weight.to(x.dtype)[..., None, None, None],
                     proj.proj.bias.to(x.dtype))
        x = F.gelu(_inorm(x, n0, mesh=mesh))
        return F.gelu(_inorm(_conv(x, conv, mesh), n1, mesh=mesh))

    def forward_depth_major(
        self, x: torch.Tensor, skip: torch.Tensor, mesh: Mesh | None = None
    ) -> torch.Tensor:
        """Channels-first x from the level below and a depth-major skip →
        depth-major ``(B, D, Co, H, W)``."""
        convt, n_up, _ = self.upconv
        proj, n0, _, conv, n1, _ = self.layers
        x = _conv(x, convt).transpose(1, 2).contiguous()  # to depth-major
        x = F.gelu(_inorm(x, n_up, 2, mesh))
        x = _pointwise_dm(torch.cat([x, skip], dim=2), proj.proj.weight, proj.proj.bias)
        x = F.gelu(_inorm(x, n0, 2, mesh))
        return F.gelu(_inorm(_conv_dm(x, conv, mesh), n1, 2, mesh))


class UNet3D(nn.Module):
    """The 3-level U-Net (reference ``unet3d.py:12-104``).

    Input: ``(B, D, H, W, 1)`` raw voxels, D/H/W multiples of 16. Output:
    ``(B, D, H, W)`` f32 per-voxel probabilities. Computes in ``dtype``, or
    in the dtype of its parameters when that is None. With
    ``forward(x, mesh=...)`` (a mesh of more than one rank) ``x`` is this
    rank's depth slab, of a multiple of :data:`SLAB_MULTIPLE` slices, and so
    is the output.
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

    def forward(self, x: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
        shape = tuple(x.shape)
        ranks = mesh.size if _sharded(mesh) else 1
        for dim in (shape[1] * ranks, *shape[2:4]):
            if dim % PAD_MULTIPLE:
                raise ValueError(
                    f"UNet3D input dims must be multiples of {PAD_MULTIPLE}, got {shape}"
                    + (f" on each of {ranks} ranks" if ranks > 1 else "")
                )
        if ranks > 1 and shape[1] % SLAB_MULTIPLE:
            raise ValueError(
                f"a depth slab of {shape[1]} slices is not a multiple of {SLAB_MULTIPLE}, "
                f"as the {len(self.analysis_layers)} stride-2 depth pools need"
            )
        dtype = self.dtype or self.output_layer.weight.dtype
        # with one channel, (B, D, H, W, 1) is already depth-major (B, D, 1, H, W)
        x = x.to(dtype).permute(0, 1, 4, 2, 3).contiguous()
        first, *rest = self.analysis_layers
        x, skip = first.forward_depth_major(x, mesh)
        skips = [skip]
        for block in rest:
            x, skip = block.forward_channels_first(x, mesh)
            skips.append(skip)
        conv0, n0, _, conv1, n1, _ = self.bottom_layer
        x = F.gelu(_inorm(_conv(x, conv0, mesh), n0, mesh=mesh))
        x = F.gelu(_inorm(_conv(x, conv1, mesh), n1, mesh=mesh))
        *outer, last = self.synthesis_layers
        for block in outer:
            x = block.forward_channels_first(x, skips.pop(), mesh)
        x = last.forward_depth_major(x, skips.pop(), mesh)
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
