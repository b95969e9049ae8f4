"""Plain DINOv2 ViT with register tokens (facebookresearch/dinov2
``dinov2/models/vision_transformer.py``, ``layers/block.py``,
``layers/swiglu_ffn.py``), float32, for the benchmark's check.

The torch hub parameter names; the patch embed takes one input channel
(grayscale slices; the benchmark draws its weights in that form). The
position embeddings are interpolated as the hub model does
(``interpolate_pos_encoding``: bicubic, ``scale_factor = (g + offset) /
M``, no antialias). Attention is written out: softmax(q·kᵀ/√d)·v.

Departures from the hub model: none in the mathematics; no dropout or
drop-path (inference), no mask token.

``round_operands(model, fn)`` applies ``fn`` to every product's operands
(the benchmark's control: the same model with its operands rounded to a
lower precision); by default they are left as they are.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _linear(layer: nn.Linear, x: torch.Tensor, q) -> torch.Tensor:
    return F.linear(q(x), q(layer.weight), layer.bias)


def round_operands(model: nn.Module, fn) -> None:
    for m in model.modules():
        m.q = fn


class Attention(nn.Module):
    q = staticmethod(_same)

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.heads
        r = self.q
        qkv = _linear(self.qkv, x, r).reshape(b, n, 3, self.heads, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.softmax(r(q * d**-0.5) @ r(k.transpose(-2, -1)), dim=-1)
        out = (r(attn) @ r(v)).transpose(1, 2).reshape(b, n, c)
        return _linear(self.proj, out, r)


class SwiGLU(nn.Module):
    q = staticmethod(_same)

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = _linear(self.w12, x, self.q).chunk(2, dim=-1)
        return _linear(self.w3, F.silu(x1) * x2, self.q)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        dim, eps = cfg["embed_dim"], cfg["layer_norm_eps"]
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, cfg["num_heads"])
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = SwiGLU(dim, cfg["ffn_hidden"])
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        p = cfg["patch_size"]
        self.proj = nn.Conv2d(cfg["in_chans"], cfg["embed_dim"], p, stride=p)


class DinoV2(nn.Module):
    """``forward((B, H, W) slices)`` → ``(B, gh·gw, C)`` normalized patch
    tokens (``x_norm_patchtokens``)."""

    q = staticmethod(_same)

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        c = cfg["embed_dim"]
        m = cfg["img_size"] // cfg["patch_size"]
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c))
        self.register_tokens = nn.Parameter(torch.empty(1, cfg["num_register_tokens"], c))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + m * m, c))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg["depth"]))
        self.norm = nn.LayerNorm(c, eps=cfg["layer_norm_eps"])

    def interpolate_pos_encoding(self, gh: int, gw: int) -> torch.Tensor:
        cfg = self.cfg
        pos = self.pos_embed.float()
        m = cfg["img_size"] // cfg["patch_size"]
        if (gh, gw) == (m, m):
            return pos
        off = cfg["interpolate_offset"]
        patch = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        patch = F.interpolate(patch, scale_factor=((gh + off) / m, (gw + off) / m),
                              mode="bicubic", antialias=cfg["interpolate_antialias"])
        assert patch.shape[-2:] == (gh, gw)
        patch = patch.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        return torch.cat([pos[:, :1], patch], dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w = x.shape
        p = self.cfg["patch_size"]
        proj = self.patch_embed.proj
        t = F.conv2d(self.q(x[:, None]), self.q(proj.weight), proj.bias, stride=proj.stride)
        t = t.flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(b, -1, -1), t], dim=1)
        t = t + self.interpolate_pos_encoding(h // p, w // p)
        t = torch.cat([t[:, :1], self.register_tokens.expand(b, -1, -1), t[:, 1:]], dim=1)
        for blk in self.blocks:
            t = blk(t)
        return self.norm(t)[:, 1 + self.cfg["num_register_tokens"]:]
