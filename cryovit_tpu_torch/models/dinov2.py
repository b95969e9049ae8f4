"""DINOv2 ViT-g/14 with register tokens (feature extractor), in PyTorch.

Port of ``cryovit_tpu/models/dinov2.py``. The giant variant: patch 14, embed
1536, 40 blocks, 24 heads of 64, SwiGLU-fused FFN (hidden 4096), LayerScale,
1 cls + 4 register tokens, LayerNorm eps 1e-6. ``DinoV2.forward`` returns
``forward_features(...)["x_norm_patchtokens"]`` of the torch hub model.

- Parameters carry the torch hub names (``blocks.{i}.attn.qkv.weight``, …),
  with the patch embed folded to one input channel
  (``convert.fold_patch_embed``): tomogram slices are grayscale.
- The patch embed is an unfold + matmul.
- Position embeddings are interpolated in torch's scale-factor form
  (``scale = (g + 0.1) / M``), as the hub model does.
- Attention reads q, k and v as column views of one qkv projection and
  applies their biases inside the kernel (``ops/flash_attention.py``).
- LayerNorm statistics are f32 (``F.layer_norm``; the JAX package uses the
  "fast" variance E[x²] − E[x]², which differs at the 1e-5 level in f32);
  the residual stream is in the compute dtype, the final norm in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.ops.flash_attention import flash_attention
from cryovit_tpu_torch.ops.resize import _cubic_kernel

__all__ = ["DinoV2Config", "DinoV2", "interpolate_pos_embed", "make_dinov2"]


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    """Architecture hyperparameters. Defaults = ViT-g/14 with registers."""

    patch_size: int = 14
    embed_dim: int = 1536
    depth: int = 40
    num_heads: int = 24
    ffn_hidden: int = 4096  # SwiGLU-fused hidden (2/3 · 4 · 1536 → mult of 8)
    num_registers: int = 4
    pos_grid: int = 37  # pretraining grid: 518 / 14
    layer_norm_eps: float = 1e-6
    in_channels: int = 1  # folded grayscale input

    @classmethod
    def giant(cls) -> "DinoV2Config":
        return cls()

    @classmethod
    def tiny_test(cls) -> "DinoV2Config":
        """Small config for parity tests (CPU only: head dim 16)."""
        return cls(
            patch_size=14,
            embed_dim=64,
            depth=2,
            num_heads=4,
            ffn_hidden=56,
            num_registers=4,
            pos_grid=4,
        )


def _scaled_resize_matrix(in_size: int, out_size: int, scale: float) -> np.ndarray:
    """Bicubic resampling matrix with an explicit scale factor in the
    half-pixel mapping (``src = (dst + 0.5)/scale − 0.5``), as torch does when
    ``scale_factor`` is passed with ``recompute_scale_factor=False``."""
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(mat, (dst.astype(np.int64), idx), _cubic_kernel(tap - frac))
    return mat.astype(np.float32)


def interpolate_pos_embed(
    pos_embed: torch.Tensor, grid: tuple[int, int], pos_grid: int
) -> torch.Tensor:
    """Interpolate ``(1 + M², C)`` position embeddings (cls first) to a
    ``(gh, gw)`` patch grid, in f32, with the hub model's bicubic
    ``scale_factor = (g + 0.1) / M``."""
    gh, gw = grid
    m = pos_grid
    pos = pos_embed.float()
    cls_pos = pos[:1]
    patch_pos = pos[1:].reshape(m, m, -1)
    if (gh, gw) != (m, m):
        rh = torch.from_numpy(_scaled_resize_matrix(m, gh, (gh + 0.1) / m))
        rw = torch.from_numpy(_scaled_resize_matrix(m, gw, (gw + 0.1) / m))
        patch_pos = torch.einsum("oh,hwc->owc", rh.to(pos.device), patch_pos)
        patch_pos = torch.einsum("pw,owc->opc", rw.to(pos.device), patch_pos)
    return torch.cat([cls_pos, patch_pos.reshape(gh * gw, -1)], dim=0)


class PatchEmbed(nn.Module):
    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        p = cfg.patch_size
        self.proj = nn.Conv2d(cfg.in_channels, cfg.embed_dim, p, stride=p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W)`` → ``(B, gh·gw, E)`` as one unfold + matmul."""
        b, h, w = x.shape
        p = self.proj.kernel_size[0]
        gh, gw = h // p, w // p
        weight = self.proj.weight
        patches = x.reshape(b, gh, p, gw, p).permute(0, 1, 3, 2, 4)
        patches = patches.reshape(b, gh * gw, p * p).to(weight.dtype)
        return F.linear(patches, weight.reshape(weight.shape[0], -1), self.proj.bias)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        # one (B·N, C)·(C, 3C) product in its natural layout; q, k and v are
        # column views of it, and their biases are added inside the kernel
        qkv = F.linear(x, self.qkv.weight)
        out = flash_attention(
            qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :],
            self.qkv.bias.view(3, c), self.num_heads,
            scale=(c // self.num_heads) ** -0.5,
        )
        return F.linear(out, self.proj.weight, self.proj.bias)


class SwiGLUFFN(nn.Module):
    """``w3(silu(x1) · x2)`` with ``x1, x2 = split(w12 x)``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    """Holds ``gamma`` under the hub name; ``Block`` applies it with the
    residual add."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


class Block(nn.Module):
    """Pre-LN block with LayerScale: ``x + ls1·attn(LN1 x)``, then
    ``x + ls2·mlp(LN2 x)`` (torch hub ``dinov2/layers/block.py``)."""

    def __init__(self, cfg: DinoV2Config):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attn = Attention(dim, cfg.num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = SwiGLUFFN(dim, cfg.ffn_hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # LayerNorm in one kernel (f32 statistics inside, output in x's
        # dtype); LayerScale and the residual add in one addcmul
        x = torch.addcmul(x, self.attn(self.norm1(x)), self.ls1.gamma)
        return torch.addcmul(x, self.mlp(self.norm2(x)), self.ls2.gamma)


class DinoV2(nn.Module):
    """DINOv2 backbone returning normalized patch tokens.

    Input: ``(B, H, W)`` preprocessed slices (already 14/16-resized; H, W
    multiples of 14). Output: ``(B, gh·gw, embed_dim)`` f32 patch tokens.
    Computes in the dtype of its parameters.
    """

    def __init__(self, cfg: DinoV2Config | None = None):
        super().__init__()
        self.cfg = cfg = cfg or DinoV2Config.giant()
        e = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, e))
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_registers, e))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.pos_grid**2, e))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(e, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, h, w = x.shape
        gh, gw = h // cfg.patch_size, w // cfg.patch_size
        dtype = self.pos_embed.dtype
        tokens = self.patch_embed(x)
        pos = interpolate_pos_embed(self.pos_embed[0], (gh, gw), cfg.pos_grid)
        cls = self.cls_token.expand(b, 1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + pos.to(dtype)
        regs = self.register_tokens.expand(b, -1, -1)
        tokens = torch.cat([tokens[:, :1], regs, tokens[:, 1:]], dim=1)
        for blk in self.blocks:
            tokens = blk(tokens)
        norm = self.norm
        tokens = F.layer_norm(
            tokens.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps
        )
        return tokens[:, 1 + cfg.num_registers :]


def make_dinov2(
    state_dict: dict[str, torch.Tensor],
    cfg: DinoV2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> DinoV2:
    """Build the extractor from a port state dict (torch hub names, patch
    embed folded to one channel), on ``device`` in ``dtype``, for inference.

    The module is built on the meta device and takes the state dict's
    tensors as its parameters, so the giant model is never initialised
    twice or copied through host memory."""
    with torch.device("meta"):
        model = DinoV2(cfg)
    sd = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval().requires_grad_(False)
