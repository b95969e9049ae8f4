"""SAM2 image encoder: Hiera trunk + FPN neck + sine position encodings.

Port of ``cryovit_tpu/models/sam2/encoder.py``, with the published sam2
names: ``trunk.*`` and ``neck.convs.{j}.conv``, where ``convs.0`` is the
coarsest (stride-32) level — sam2's ``FpnNeck`` builds its convs from the
backbone channels listed low resolution first, the reverse of the trunk's
output order. The neck is d_model 256 with 1×1 lateral convs, a top-down
nearest-neighbour path into the two coarsest levels and scalp 1 (the
stride-32 level is dropped after the top-down adds), so ``backbone_fpn`` and
``vision_pos_enc`` are the pyramids of the cached ``sam_features`` files.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.hiera import Hiera, MultiScaleAttention

__all__ = [
    "ImageEncoder",
    "fold_rgb_patch_embed",
    "make_image_encoder",
    "random_encoder_state_dict",
    "sine_position_encoding",
]

F32_PARAMS = ("trunk.pos_embed", "trunk.pos_embed_window")  # N(0, 0.02²), kept f32


@lru_cache(maxsize=16)
def sine_position_encoding(h: int, w: int, dim: int, temperature: float = 10000.0) -> np.ndarray:
    """2D sine position embedding ``(h, w, dim)`` f32 (sam2
    ``PositionEmbeddingSine``, normalised to 2π). Cached; read-only."""
    y = np.arange(1, h + 1, dtype=np.float32)[:, None].repeat(w, axis=1)
    x = np.arange(1, w + 1, dtype=np.float32)[None, :].repeat(h, axis=0)
    y = y / (y[-1:, :] + 1e-6) * 2 * math.pi
    x = x / (x[:, -1:] + 1e-6) * 2 * math.pi
    num_pos_feats = dim // 2
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    pos_x = x[..., None] / dim_t
    pos_y = y[..., None] / dim_t
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], axis=-1).reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], axis=-1).reshape(h, w, -1)
    out = np.concatenate([pos_y, pos_x], axis=-1)
    out.flags.writeable = False
    return out


class _Lateral(nn.Module):
    def __init__(self, dim: int, d_model: int):
        super().__init__()
        self.conv = nn.Conv2d(dim, d_model, 1)


class FpnNeck(nn.Module):
    """Holds the lateral 1×1 convs under sam2's names, coarsest first."""

    def __init__(self, d_model: int, stage_dims: tuple[int, ...]):
        super().__init__()
        self.convs = nn.ModuleList(_Lateral(c, d_model) for c in reversed(stage_dims))


class ImageEncoder(nn.Module):
    """Hiera + FPN neck → per retained level (strides 4, 8, 16, high
    resolution first) the ``(B, h, w, d_model)`` features and their sine
    position encodings, in the trunk's compute dtype."""

    def __init__(self, cfg: SAM2Config | None = None, in_chans: int = 3):
        super().__init__()
        self.cfg = cfg = cfg or SAM2Config.large()
        self.trunk = Hiera(cfg.hiera, in_chans)
        self.neck = FpnNeck(cfg.d_model, cfg.hiera.stage_dims)

    def forward(self, x: torch.Tensor) -> dict[str, list[torch.Tensor]]:
        cfg = self.cfg
        trunk_outs = self.trunk(x)
        n = len(trunk_outs)
        laterals = []
        for i, feat in enumerate(trunk_outs):  # 1×1 conv as a matrix product
            conv = self.neck.convs[n - 1 - i].conv
            laterals.append(F.linear(feat, conv.weight.flatten(1), conv.bias))
        # top-down: the two coarsest levels receive the upsampled coarser sum
        # (fpn_top_down_levels [2, 3] of sam2.1_hiera_l)
        outs: list[torch.Tensor] = [None] * n  # type: ignore[list-item]
        prev = None
        for i in range(n - 1, -1, -1):
            feat = laterals[i]
            if prev is not None and i >= n - 2:
                feat = feat + prev.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            outs[i] = prev = feat
        features = outs[: cfg.num_feature_levels]  # scalp: drop stride 32
        pos_enc = [
            torch.from_numpy(sine_position_encoding(f.shape[1], f.shape[2], cfg.d_model).copy())
            .to(device=f.device, dtype=f.dtype)[None]
            .expand(f.shape[0], -1, -1, -1)
            for f in features
        ]
        return {"backbone_fpn": features, "vision_pos_enc": pos_enc}


def fold_rgb_patch_embed(state_dict: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Fold the 3-channel replication of grayscale slices into the patch
    embed: ``Σ_c W_c ⊛ x = (Σ_c W_c) ⊛ x``, summed in f32 before any cast.
    A state dict already folded comes back unchanged."""
    key = "trunk.patch_embed.proj.weight"
    w = state_dict[key]
    if w.shape[1] == 1:
        return state_dict
    out = dict(state_dict)
    out[key] = w.float().sum(dim=1, keepdim=True)
    return out


def random_encoder_state_dict(cfg: SAM2Config, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """flax's init laws for the JAX ``ImageEncoder`` with its 3-channel
    patch embed: lecun-normal linear and conv weights, zero biases, unit
    LayerNorm scales, position embeddings N(0, 0.02²) — drawn in f32 on the
    generator's device."""
    device = generator.device
    with torch.device("meta"):
        template = ImageEncoder(cfg).state_dict()
    out = {}
    for name, t in template.items():
        shape = tuple(t.shape)
        if name in F32_PARAMS:
            out[name] = torch.randn(shape, generator=generator, device=device) * 0.02
        elif ".norm" in name:
            out[name] = (torch.ones if name.endswith(".weight") else torch.zeros)(shape, device=device)
        elif name.endswith(".weight"):  # Linear (out, in), Conv2d (out, in, kh, kw)
            out[name] = lecun_normal(shape, t[0].numel(), generator)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def make_image_encoder(
    state_dict: dict[str, torch.Tensor],
    cfg: SAM2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> ImageEncoder:
    """Build the encoder from a port state dict (published names, without
    the ``image_encoder.`` prefix) on ``device`` for inference: linear and
    conv weights in ``dtype``, LayerNorm parameters and position embeddings
    in f32. The attention kernels' folded qkv copies are made from the f32
    weights (``Hiera.fold_kernel_scales``) before the cast. The patch
    embed's input channels follow the state dict (1 once folded, 3 as
    published)."""
    in_chans = state_dict["trunk.patch_embed.proj.weight"].shape[1]
    with torch.device("meta"):
        model = ImageEncoder(cfg, in_chans)
    sd = {
        k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32)))
        .to(device=device, dtype=torch.float32)
        for k, v in state_dict.items()
    }
    model.load_state_dict(sd, strict=True, assign=True)
    model.trunk.fold_kernel_scales()
    for module in model.modules():  # LayerNorms and position embeddings stay f32
        if isinstance(module, (nn.Linear, nn.Conv2d, MultiScaleAttention)):
            module.to(dtype)
    return model.eval().requires_grad_(False)
