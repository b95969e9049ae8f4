"""SAM2 memory: memory encoder, memory attention and their position codes.

Port of ``cryovit_tpu/models/sam2/memory.py`` (the published sam2 modules,
so ``sam2.1_hiera_large.pt`` maps tensor for tensor):

- :class:`MemoryEncoder` (sam2 ``memory_encoder.py``): the mask
  downsampler (four stride-2 3×3 convs 1→4→16→64→256 with LayerNorm eps
  1e-6 + GELU, then a 1×1 conv to d_model), ``pix_feat_proj``, a fuser of
  two CXBlocks (7×7 depthwise conv, LayerNorm, pointwise MLP, LayerScale)
  and ``out_proj`` to ``mem_dim``;
- :class:`MemoryAttention` (sam2 ``memory_attention.py``, the published
  ``sam2.1_hiera_l`` layer config): one head; self-attention with axial
  RoPE on q and k; cross-attention to the memory bank with k/v projected
  from ``mem_dim``, the memory position stream added to k only, RoPE on
  the spatial memory tokens (tiled over the slots) and none on the
  object-pointer tokens; a ReLU MLP of 8·d; LayerNorms eps 1e-5; the input
  gets 0.1 × the current slice's position code;
- :func:`axial_rope`: column frequencies on the first half of the rotary
  pairs, row frequencies on the second, adjacent channels as complex pairs.

Besides that reference-shaped path, the cached one of the JAX package's
``kv_cache``: :meth:`MemoryAttention.project_memory` / ``project_ptr`` turn
one newly written memory slot into every layer's cross k/v entries once, at
write time, and :meth:`MemoryAttention.cached` attends to those entries per
slice, adding the position terms (``rope(W_k·grid_pe + b_k)``, a
recency-indexed ``rope(W_k·tpos)`` table, the pointers' ``W_k·pe + b_k``)
that depend only on parameters. The k/v projections and RoPE are linear, so
both paths compute the same attention.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.layers import Conv2d, LayerNorm, Linear, cast

__all__ = ["MemoryAttention", "MemoryEncoder", "axial_rope", "sine_pe_1d"]


@lru_cache(maxsize=32)
def _axial_angles(dim: int, grid: tuple[int, int], theta: float = 10000.0) -> np.ndarray:
    """``(h·w, dim/2)`` rotation angles of sam2 ``compute_axial_cis`` over a
    row-major token axis: token t at column ``t % w`` (first dim/4 pairs)
    and row ``t // w`` (the rest)."""
    quarter = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[:quarter] / dim))
    h, w = grid
    t = np.arange(h * w)
    out = np.concatenate([np.outer(t % w, freqs), np.outer(t // w, freqs)], axis=-1)
    out.flags.writeable = False
    return out


_ROPE_TABLES: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}


def _rope_tables(d: int, grid: tuple[int, int], repeat: int, dtype: torch.dtype,
                 device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    key = (d, grid, repeat, dtype, device)
    if key not in _ROPE_TABLES:
        ang = np.tile(_axial_angles(d, grid), (repeat, 1))
        # normal tensors even under inference_mode, so a later train step
        # may save them for its backward
        with torch.inference_mode(False):
            _ROPE_TABLES[key] = tuple(
                torch.from_numpy(f(ang)).to(device=device, dtype=dtype)[None, :, None, :]
                for f in (np.cos, np.sin)
            )
    return _ROPE_TABLES[key]


def axial_rope(x: torch.Tensor, grid: tuple[int, int], repeat: int = 1) -> torch.Tensor:
    """2D axial rotary embedding of ``x (B, N, H, D)``, ``N = repeat·h·w``
    (``repeat > 1`` tiles the grid angles over memory slots, sam2's
    ``rope_k_repeat``)."""
    b, n, heads, d = x.shape
    cos, sin = _rope_tables(d, grid, repeat, x.dtype, x.device)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(b, n, heads, d)


def sine_pe_1d(pos: torch.Tensor, dim: int, temperature: float = 10000.0) -> torch.Tensor:
    """1D sine position embedding (sam2 ``get_1d_sine_pe``): ``pos (...)``
    → ``(..., dim)`` f32, sines then cosines."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / pe_dim)
    ang = pos.float()[..., None] / dim_t
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class _MaskDownSampler(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        layers: list[nn.Module] = []
        cin = 1
        for i in range(4):
            cout = 4 ** (i + 1)
            layers += [Conv2d(cin, cout, 3, 2, 1), LayerNorm(cout, eps=1e-6), nn.GELU()]
            cin = cout
        layers.append(Conv2d(cin, d_model, 1))
        self.encoder = nn.ModuleList(layers)


class _CXBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.dwconv = Conv2d(d, d, 7, padding=3, groups=d)
        self.norm = LayerNorm(d, eps=1e-6)
        self.pwconv1 = Linear(d, 4 * d)
        self.pwconv2 = Linear(4 * d, d)
        self.gamma = nn.Parameter(torch.full((d,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv2(F.gelu(self.pwconv1(self.norm(self.dwconv(x)))))
        return x + y * cast(self.gamma, x)


class _Fuser(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.layers = nn.ModuleList(_CXBlock(d) for _ in range(2))


class MemoryEncoder(nn.Module):
    """``forward(pix_feat (B, e, e, d), masks (B, S, S, 1), skip_sigmoid)``
    → memory features ``(B, e, e, mem_dim)`` in ``dtype``."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        d = cfg.d_model
        self.mask_downsampler = _MaskDownSampler(d)
        self.pix_feat_proj = Conv2d(d, d, 1)
        self.fuser = _Fuser(d)
        self.out_proj = Conv2d(d, cfg.mem_dim, 1)

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_sigmoid: bool = False) -> torch.Tensor:
        x = (masks if skip_sigmoid else torch.sigmoid(masks)).to(self.dtype)
        for layer in self.mask_downsampler.encoder:
            x = F.gelu(x) if isinstance(layer, nn.GELU) else layer(x)
        x = x + self.pix_feat_proj(pix_feat.to(self.dtype))
        for block in self.fuser.layers:
            x = block(x)
        return self.out_proj(x)


class _Attention(nn.Module):
    """sam2 ``RoPEAttention``'s projections (``kv_in_dim`` for k and v)."""

    def __init__(self, d: int, kv_dim: int):
        super().__init__()
        self.q_proj = Linear(d, d)
        self.k_proj = Linear(kv_dim, d)
        self.v_proj = Linear(kv_dim, d)
        self.out_proj = Linear(d, d)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor | None) -> torch.Tensor:
    """``(B, N, H, D)`` heads → ``(B, N, H·D)``; ``mask (B, M)`` bool."""
    attn_mask = None if mask is None else mask[:, None, None, :]
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                         attn_mask=attn_mask, scale=q.shape[-1] ** -0.5)
    return out.transpose(1, 2).flatten(2)


class _MemAttnLayer(nn.Module):
    def __init__(self, d: int, mem_dim: int, grid: tuple[int, int], num_heads: int = 1):
        super().__init__()
        self.grid, self.num_heads = grid, num_heads
        self.self_attn = _Attention(d, d)
        self.cross_attn_image = _Attention(d, mem_dim)
        self.linear1 = Linear(d, 8 * d)
        self.linear2 = Linear(8 * d, d)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(d, eps=1e-5) for _ in range(3))

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.reshape(t.shape[0], t.shape[1], self.num_heads, -1)

    def _self_attend(self, x):
        sa = self.self_attn
        y = self.norm1(x)
        q = axial_rope(self._heads(sa.q_proj(y)), self.grid)
        k = axial_rope(self._heads(sa.k_proj(y)), self.grid)
        return x + sa.out_proj(_attend(q, k, self._heads(sa.v_proj(y)), None))

    def _cross_attend(self, x, k, v, mask):
        """Cross-attention to memory heads ``k``/``v``, then the MLP."""
        ca = self.cross_attn_image
        q = axial_rope(self._heads(ca.q_proj(self.norm2(x))), self.grid)
        x = x + ca.out_proj(_attend(q, k, v, mask))
        return x + self.linear2(F.relu(self.linear1(self.norm3(x))))

    def forward(self, x, mem, mem_pos, mem_mask, n_rope_k: int):
        ca = self.cross_attn_image
        x = self._self_attend(x)
        k = self._heads(ca.k_proj(mem + mem_pos))
        k_sp = axial_rope(k[:, :n_rope_k], self.grid, repeat=n_rope_k // x.shape[1])
        k = torch.cat([k_sp, k[:, n_rope_k:]], dim=1)
        return self._cross_attend(x, k, self._heads(ca.v_proj(mem)), mem_mask)

    # ---- the cached path ------------------------------------------------

    def _k_no_bias(self, t):
        return F.linear(t, cast(self.cross_attn_image.k_proj.weight, t))

    def project_spatial(self, mem):
        """A written slot ``(B, e², mem_dim)`` → this layer's cache entries:
        ``k = rope(W_k·mem)`` (bias-free: the bias rides the grid term, so it
        is added once) and ``v = W_v·mem + b_v`` (v never sees position)."""
        k = axial_rope(self._heads(self._k_no_bias(mem)), self.grid)
        return k.flatten(2), self.cross_attn_image.v_proj(mem)

    def project_ptr(self, tok):
        """Pointer tokens ``(B, ratio, mem_dim)`` → bias-free ``W_k·tok`` and
        ``W_v·tok + b_v`` (no RoPE on pointer tokens)."""
        return self._k_no_bias(tok), self.cross_attn_image.v_proj(tok)

    def static_keys(self, grid_pe, tpos):
        """The parameter-only key terms: ``rope(W_k·grid_pe + b_k)`` ``(e²,
        d)`` and, per ``maskmem_tpos_enc`` row, ``rope(W_k·tpos[r])`` over the
        grid ``(T, e², d)``."""
        e2 = grid_pe.shape[0]
        base = axial_rope(self._heads(self.cross_attn_image.k_proj(grid_pe)[None]), self.grid)
        tk = self._k_no_bias(tpos)[:, None, :].expand(-1, e2, -1)
        return base.flatten(2)[0], axial_rope(self._heads(tk), self.grid).flatten(2)

    def cached(self, x, k_sp, v_sp, k_pt, v_pt, recency, ptr_pe, static):
        """Cross-attention from cache entries: ``k_sp``/``v_sp (B, M, e², d)``
        of the M valid slots, ``k_pt``/``v_pt (B, P, ratio, d)`` of the P
        valid pointers, each slot's ``recency`` row, the pointers'
        temporal code ``ptr_pe (P, mem_dim)`` and :meth:`static_keys`."""
        base, tpos_k = static
        b, m, e2, d = k_sp.shape
        x = self._self_attend(x)
        k_spatial = k_sp + base + torch.stack([tpos_k[r] for r in recency])
        k_ptr = k_pt + self.cross_attn_image.k_proj(ptr_pe)[None, :, None, :]
        k = torch.cat([k_spatial.reshape(b, m * e2, d), k_ptr.reshape(b, -1, d)], dim=1)
        v = torch.cat([v_sp.reshape(b, m * e2, d), v_pt.reshape(b, -1, d)], dim=1)
        return self._cross_attend(x, self._heads(k), self._heads(v), None)


class MemoryAttention(nn.Module):
    """``forward(feats (B, e, e, d), curr_pos (B|1, e, e, d), mem_tokens (B,
    M, mem_dim), mem_pos (B, M, mem_dim), mem_mask (B, M) bool | None,
    n_rope_k)`` → memory-conditioned features ``(B, e, e, d)``; the first
    ``n_rope_k`` memory tokens are spatial, the rest object pointers."""

    def __init__(self, cfg: SAM2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        e = cfg.embed_size
        self.layers = nn.ModuleList(
            _MemAttnLayer(cfg.d_model, cfg.mem_dim, (e, e))
            for _ in range(cfg.memory_attention_layers)
        )
        self.norm = LayerNorm(cfg.d_model, eps=1e-5)

    def _input(self, feats, curr_pos):
        b, e, _, d = feats.shape
        return (feats.reshape(b, e * e, d) + 0.1 * curr_pos.reshape(-1, e * e, d)).to(self.dtype)

    def forward(self, feats, curr_pos, mem_tokens, mem_pos, mem_mask=None, n_rope_k=None):
        dt = self.dtype
        b, e, _, d = feats.shape
        x = self._input(feats, curr_pos)
        if n_rope_k is None:
            n_rope_k = mem_tokens.shape[1]
        mem, pos = mem_tokens.to(dt), mem_pos.to(dt)
        for layer in self.layers:
            x = layer(x, mem, pos, mem_mask, n_rope_k)
        return self.norm(x).reshape(b, e, e, d)

    # ---- the cached path (kv_cache) ---------------------------------------

    def project_memory(self, mem: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A written slot ``(B, e², mem_dim)`` → every layer's cache entries
        ``k, v (B, e², L·d)`` (layer l on channels ``[l·d, (l+1)·d)``)."""
        mem = mem.to(self.dtype)
        ks, vs = zip(*(layer.project_spatial(mem) for layer in self.layers))
        return torch.cat(ks, dim=-1), torch.cat(vs, dim=-1)

    def project_ptr(self, tok: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Pointer tokens ``(B, ratio, mem_dim)`` → ``k, v (B, ratio, L·d)``."""
        tok = tok.to(self.dtype)
        ks, vs = zip(*(layer.project_ptr(tok) for layer in self.layers))
        return torch.cat(ks, dim=-1), torch.cat(vs, dim=-1)

    def static_keys(self, grid_pe: torch.Tensor, tpos: torch.Tensor) -> list:
        """Per layer its parameter-only key terms (``_MemAttnLayer.static_keys``)
        of the grid's sine code ``(e², mem_dim)`` and ``maskmem_tpos_enc``
        ``(T, mem_dim)``; made once per tracking pass."""
        grid_pe, tpos = grid_pe.to(self.dtype), tpos.to(self.dtype)
        return [layer.static_keys(grid_pe, tpos) for layer in self.layers]

    def cached(self, feats, curr_pos, k_sp, v_sp, k_pt, v_pt, recency, ptr_pe, static):
        """Memory-conditioned features from the cache entries: ``k_sp``/``v_sp
        (B, M, e², L·d)``, ``k_pt``/``v_pt (B, P, ratio, L·d)``, ``recency``
        (M ints), ``ptr_pe (P, mem_dim)``, ``static`` from :meth:`static_keys`."""
        b, e, _, d = feats.shape
        x = self._input(feats, curr_pos)
        ptr_pe = ptr_pe.to(self.dtype)
        for i, layer in enumerate(self.layers):
            sl = slice(i * d, (i + 1) * d)
            x = layer.cached(x, k_sp[..., sl], v_sp[..., sl], k_pt[..., sl], v_pt[..., sl],
                             recency, ptr_pe, static[i])
        return self.norm(x).reshape(b, e, e, d)
