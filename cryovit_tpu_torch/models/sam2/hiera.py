"""Hiera trunk (the SAM2 "hieradet" backbone) in PyTorch.

Port of ``cryovit_tpu/models/sam2/hiera.py``: a hierarchical ViT with
windowed attention — 7×7 stride-4 patch embed, four stages with the width
and head count doubling and 2× query pooling at each stage transition,
fixed window sizes per stage, and a few global-attention blocks. The
position embedding is a bicubic-resized background embedding plus a tiled
window embedding, as in the published ``hieradet``.

- Parameters carry the published sam2 names (``patch_embed.proj``,
  ``pos_embed`` ``(1, C, 7, 7)``, ``pos_embed_window``,
  ``blocks.{i}.{norm1,norm2,attn.qkv,attn.proj,mlp.layers.0,mlp.layers.1,
  proj}``), so the trunk of ``sam2.1_hiera_large.pt`` loads strictly.
- Tokens stay channels-last, ``(B, H, W, C)``, as in the JAX package.
- The trunk computes in the dtype of its linear weights; LayerNorm
  statistics and the position embedding are f32, GELU is exact.
- The blocks the JAX package sends to its Pallas kernels go to the port's
  kernel wrappers (``ops/window_attention.py``) under the same gates, which
  test shape and dtype: the fused window block for 128–512-token windows
  (Hiera-L's stage-3 windows of 16×16) and the attention kernel for 512–2048
  tokens of global attention (its three global blocks at 32×32). A wrapper
  launches its kernel for CUDA tensors and runs its plain version for CPU
  tensors. Every other block runs the JAX package's XLA recipe in plain
  PyTorch.
- The kernels take the qkv projection with the softmax scale·log2(e) folded
  into its q third. :meth:`Hiera.fold_kernel_scales` stores that copy; called
  on f32 weights before the cast to bf16 (as ``make_image_encoder`` does),
  it rounds the folded weights once, as the JAX package does.
- The opt-in w8a8 mode (:meth:`Hiera.quantize_int8`) computes exactly the
  projections that the JAX package's ``_Dense`` quantizes as int8 products
  (``ops/quant.py``): the qkv of every block that does not take the global
  attention gate and ``mlp.layers.0`` of every block that does not take the
  fused window-block gate. The fused blocks, the global blocks' qkv,
  ``attn.proj``, ``mlp.layers.1`` and the q-pool shortcut stay in the
  compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.models.sam2.config import HieraConfig
from cryovit_tpu_torch.ops.quant import int8_linear, quantize_weight
from cryovit_tpu_torch.ops.resize import bicubic_resize_matrix
from cryovit_tpu_torch.ops.window_attention import (
    fold_q_scale,
    layer_norm_f32,
    window_attention,
    window_block_attention,
    window_block_mlp,
)

__all__ = ["Hiera", "MultiScaleAttention", "MultiScaleBlock", "check_window_rule",
           "window_partition", "window_unpartition"]


def window_partition(x: torch.Tensor, w: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """``(B, H, W, C)`` → ``(B·nh·nw, w, w, C)``, zero-padding H and W up
    to multiples of w; also returns the padded size."""
    b, h, wdt, c = x.shape
    pad_h, pad_w = (-h) % w, (-wdt) % w
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, wdt + pad_w
    x = x.reshape(b, hp // w, w, wp // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w, w, c), (hp, wp)


def window_unpartition(
    x: torch.Tensor, w: int, padded: tuple[int, int], out: tuple[int, int]
) -> torch.Tensor:
    """Inverse of :func:`window_partition`, cropping the padding."""
    hp, wp = padded
    h, wdt = out
    b = x.shape[0] // ((hp // w) * (wp // w))
    x = x.reshape(b, hp // w, wp // w, w, w, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, -1)[:, :h, :wdt].contiguous()


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2×2 stride-2 max-pool of ``(B, H, W, C)`` (an odd edge is dropped)."""
    b, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return layer_norm_f32(x, norm.weight, norm.bias, norm.eps)


def _softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float):
    """``(…, n, d)`` attention in the JAX package's XLA recipe: in f32 a
    plain softmax; in bf16 the scores rounded to bf16, the shift by their
    max and the exponential in bf16, the denominator summed in f32, its
    reciprocal rounded to bf16."""
    s = torch.matmul(q * scale, k.transpose(-1, -2))
    if q.dtype == torch.float32:
        return torch.matmul(torch.softmax(s, dim=-1), v)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = p.float().sum(dim=-1, keepdim=True)
    return torch.matmul(p * (1.0 / denom).to(p.dtype), v)


class MultiScaleAttention(nn.Module):
    """Attention with optional 2× query pooling (a stage transition)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False):
        super().__init__()
        self.dim_out, self.num_heads, self.q_pool = dim_out, num_heads, q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        # the qkv projection as the kernels take it (fold_kernel_scale)
        self.register_buffer("kernel_qkv_weight", None, persistent=False)
        self.register_buffer("kernel_qkv_bias", None, persistent=False)
        # the w8a8 mode's int8 qkv weight and per-output-channel scales
        self.register_buffer("qkv_int8", None, persistent=False)
        self.register_buffer("qkv_int8_scale", None, persistent=False)

    def fold_kernel_scale(self) -> None:
        """Store the qkv projection with scale·log2(e) folded into its q
        third (``ops.window_attention.fold_q_scale``), in the weights' dtype."""
        self.kernel_qkv_weight, self.kernel_qkv_bias = fold_q_scale(
            self.qkv.weight, self.qkv.bias, self.num_heads
        )

    def kernel_qkv(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self.kernel_qkv_weight is None:
            raise RuntimeError(
                "the attention kernels take the folded qkv projection: call "
                "Hiera.fold_kernel_scales() on the f32 weights before the cast"
            )
        return self.kernel_qkv_weight, self.kernel_qkv_bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        heads, c = self.num_heads, self.dim_out
        d = c // heads
        n = h * w
        if (
            not self.q_pool
            and x.dtype != torch.float32
            and x.shape[-1] == c
            and d < 128
            and 512 <= n <= 2048
            and n % 16 == 0
        ):
            # global attention (Hiera-L's three 1024-token blocks): the
            # projections are plain matrix products, the attention is the
            # kernel, reading q, k and v as column views of the projection
            qkv = F.linear(x.reshape(b, n, -1), *self.kernel_qkv())
            out = window_attention(qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :], heads)
            return F.linear(out, self.proj.weight, self.proj.bias).reshape(b, h, w, c)

        # the JAX package's per-head lane slices (bf16) and its head-major
        # einsums (f32, or q pooling) are one computation in two TPU
        # layouts; here it is one batched product over heads
        if self.qkv_int8 is not None:
            qkv = int8_linear(x, self.qkv_int8, self.qkv_int8_scale, self.qkv.bias,
                              self.qkv.weight.dtype)
        else:
            qkv = F.linear(x, self.qkv.weight, self.qkv.bias)
        qkv = qkv.reshape(b, n, 3, heads, d)
        q, k, v = qkv.unbind(2)
        if self.q_pool:
            q = _max_pool2(q.reshape(b, h, w, c))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, heads, d)
        out = _softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), d**-0.5)
        out = out.transpose(1, 2).reshape(b, h, w, c)
        return F.linear(out, self.proj.weight, self.proj.bias)


class MLP(nn.Module):
    """sam2's two-layer ``MLP`` (``layers.0``, ``layers.1``) with exact GELU;
    ``layers.0`` an int8 product in the w8a8 mode (``fc1_int8``)."""

    def __init__(self, dim: int, hidden: int, dim_out: int):
        super().__init__()
        self.layers = nn.ModuleList([nn.Linear(dim, hidden), nn.Linear(hidden, dim_out)])
        self.register_buffer("fc1_int8", None, persistent=False)
        self.register_buffer("fc1_int8_scale", None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fc1 = self.layers[0]
        if self.fc1_int8 is not None:
            h = int8_linear(x, self.fc1_int8, self.fc1_int8_scale, fc1.bias, fc1.weight.dtype)
        else:
            h = fc1(x)
        return self.layers[1](F.gelu(h))


class MultiScaleBlock(nn.Module):
    """Hiera block: LN → (windowed) attention (+ q-pool shortcut) → LN → MLP.

    ``forward(x, pre_windowed=True)`` takes x already window-partitioned,
    ``(B·nw, w, w, C)``: the trunk keeps runs of windowed blocks in that
    layout (LN, MLP and the residual adds are per token)."""

    def __init__(
        self, dim: int, dim_out: int, num_heads: int, window_size: int,
        q_pool: bool = False, mlp_ratio: float = 4.0,
    ):
        super().__init__()
        self.dim_out, self.num_heads = dim_out, num_heads
        self.window_size, self.q_pool = window_size, q_pool  # window 0 = global
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_pool)
        self.norm2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out)
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None

    def forward(self, x: torch.Tensor, pre_windowed: bool = False) -> torch.Tensor:
        h0, w0 = x.shape[1:3]
        win = self.window_size
        tokens = h0 * w0 if pre_windowed else win * win
        if (
            win > 0
            and not self.q_pool
            and x.shape[-1] == self.dim_out
            and x.dtype != torch.float32
            and 128 <= tokens <= 512
            and tokens % 16 == 0
            and self.dim_out // self.num_heads < 128
            and (pre_windowed or (h0 % win == 0 and w0 % win == 0))
        ):
            return self._fused_window_block(x, pre_windowed)
        shortcut = x
        x = _layer_norm(x, self.norm1)
        if self.proj is not None:  # projection of the (pooled) shortcut
            shortcut = F.linear(x, self.proj.weight, self.proj.bias)
        if self.q_pool:
            shortcut = _max_pool2(shortcut)
        h, w = x.shape[1:3]
        windowed = win > 0 and not pre_windowed
        if windowed:
            x, padded = window_partition(x, win)
        x = self.attn(x)
        if windowed:
            if self.q_pool:
                win, padded, (h, w) = win // 2, (padded[0] // 2, padded[1] // 2), (h // 2, w // 2)
            x = window_unpartition(x, win, padded, (h, w))
        x = shortcut + x
        return x + self.mlp(_layer_norm(x, self.norm2))

    def _fused_window_block(self, x: torch.Tensor, pre_windowed: bool) -> torch.Tensor:
        """The two kernels of a windowed block: [LN1 → qkv → attention →
        proj → +x] per window and [LN2 → fc1 → GELU → fc2 → +x] per token
        (exact tiling only: the gate admits no padded grid)."""
        h0, w0 = x.shape[1:3]
        win = self.window_size
        xw = x if pre_windowed else window_partition(x, win)[0]
        bw, hh, ww, c = xw.shape
        flat = xw.reshape(bw, hh * ww, c).contiguous()
        attn, mlp = self.attn, self.mlp
        r1 = window_block_attention(
            flat, self.norm1.weight, self.norm1.bias, *attn.kernel_qkv(),
            attn.proj.weight, attn.proj.bias, self.num_heads, self.norm1.eps,
        )
        r2 = window_block_mlp(
            r1, self.norm2.weight, self.norm2.bias, mlp.layers[0].weight, mlp.layers[0].bias,
            mlp.layers[1].weight, mlp.layers[1].bias, self.norm2.eps,
        )
        out = r2.reshape(bw, hh, ww, c)
        if not pre_windowed:
            out = window_unpartition(out, win, (h0, w0), (h0, w0))
        return out


class PatchEmbed(nn.Module):
    """7×7 stride-4 convolution, channels-last in and out."""

    def __init__(self, in_chans: int, cfg: HieraConfig):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, cfg.embed_dim, cfg.patch_kernel, cfg.patch_stride,
                              cfg.patch_padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight
        y = F.conv2d(x.permute(0, 3, 1, 2).to(w.dtype), w, self.proj.bias,
                     self.proj.stride, self.proj.padding)
        return y.permute(0, 2, 3, 1).contiguous()


def check_window_rule(cfg: HieraConfig) -> None:
    """Refuse a trunk whose q-pool block would pool an odd window (ROADMAP
    C2). The first block of a stage takes that stage's window (the JAX
    package's rule, which the port follows; published sam2 gives it the
    previous stage's) and pools its queries 2×, so an odd window cannot be
    reassembled: the JAX package fails there with a reshape error in
    ``window_unpartition``. Hiera-T (``SAM2Config.medsam_tiny()``, windows
    (8, 4, 14, 7)) is refused at block 10."""
    idx = 0
    for stage, depth in enumerate(cfg.stages):
        window = cfg.window_spec[stage]
        if stage > 0 and idx not in cfg.global_att_blocks and window % 2:
            raise ValueError(
                f"Hiera block {idx} pools queries 2x over {window}x{window} windows, which "
                "cannot be reassembled: the first block of a stage takes that stage's window "
                "(the JAX package's rule, which the port follows), so an odd window there is "
                f"refused (ROADMAP C2; window_spec {tuple(cfg.window_spec)})"
            )
        idx += depth


class Hiera(nn.Module):
    """Hiera trunk returning one ``(B, h, w, C)`` map per stage (strides 4,
    8, 16, 32). Input ``(B, H, W)`` (one channel) or ``(B, H, W, Cin)``.

    ``window_persistent=False`` partitions windows per block everywhere (the
    same math; the JAX package's oracle for the run loop below)."""

    def __init__(self, cfg: HieraConfig | None = None, in_chans: int = 3,
                 window_persistent: bool = True):
        super().__init__()
        self.cfg = cfg = cfg or HieraConfig.large()
        self.window_persistent = window_persistent
        self.patch_embed = PatchEmbed(in_chans, cfg)
        bh, bw = cfg.window_pos_embed_bkg_spatial_size
        w0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, bh, bw))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, cfg.embed_dim, w0, w0))

        # per block: (window, q_pool, stage end), built as the JAX package does
        check_window_rule(cfg)
        self.specs: list[tuple[int, bool, bool]] = []
        stage_ends = {sum(cfg.stages[: s + 1]) - 1 for s in range(len(cfg.stages))}
        blocks = []
        dim, heads, idx = cfg.embed_dim, cfg.num_heads, 0
        for stage, depth in enumerate(cfg.stages):
            for d in range(depth):
                first = d == 0 and stage > 0
                dim_out, heads_out = (dim * 2, heads * 2) if first else (dim, heads)
                window = 0 if idx in cfg.global_att_blocks else cfg.window_spec[stage]
                blocks.append(MultiScaleBlock(dim, dim_out, heads_out, window, first,
                                              cfg.mlp_ratio))
                self.specs.append((window, first, idx in stage_ends))
                dim, heads = dim_out, heads_out
                idx += 1
        self.blocks = nn.ModuleList(blocks)

    def fold_kernel_scales(self) -> None:
        """Fold scale·log2(e) into a copy of every block's qkv projection for
        the attention kernels. Call it on the f32 weights, before the cast
        to the compute dtype, so the folded weights round once."""
        for blk in self.blocks:
            blk.attn.fold_kernel_scale()

    def quantize_int8(self, weights: dict[str, torch.Tensor]) -> None:
        """The w8a8 mode: every block's ``attn.qkv`` and ``mlp.layers.0``
        weight quantized per output channel, once, into non-persistent
        buffers (the counterpart of the JAX package's
        ``run/sam_features.py:prequantize_trunk_int8``). ``weights`` maps the
        trunk's parameter names to their values before the cast to the
        compute dtype (JAX quantizes the parameters as stored). The blocks
        that take a kernel gate leave theirs unused, as JAX's do."""
        for i, blk in enumerate(self.blocks):
            attn, mlp = blk.attn, blk.mlp
            attn.qkv_int8, attn.qkv_int8_scale = quantize_weight(
                weights[f"blocks.{i}.attn.qkv.weight"].to(attn.qkv.weight.device))
            mlp.fc1_int8, mlp.fc1_int8_scale = quantize_weight(
                weights[f"blocks.{i}.mlp.layers.0.weight"].to(mlp.layers[0].weight.device))

    def position_embedding(self, gh: int, gw: int) -> torch.Tensor:
        """``(gh, gw, C)`` f32: the background embedding resized bicubically
        (torch ``F.interpolate`` weights) plus the tiled window embedding."""
        bkg = self.pos_embed[0].float().permute(1, 2, 0)
        dev = bkg.device
        rh = torch.from_numpy(bicubic_resize_matrix(bkg.shape[0], gh).copy()).to(dev)
        rw = torch.from_numpy(bicubic_resize_matrix(bkg.shape[1], gw).copy()).to(dev)
        pos = torch.einsum("oh,hwc->owc", rh, bkg)
        pos = torch.einsum("pw,owc->opc", rw, pos)
        win = self.pos_embed_window[0].float().permute(1, 2, 0)
        w = win.shape[0]
        tiles = win.repeat(math.ceil(gh / w), math.ceil(gw / w), 1)[:gh, :gw]
        return pos + tiles

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        if x.dim() == 3:
            x = x[..., None]
        x = self.patch_embed(x)
        gh, gw = x.shape[1:3]
        x = x + self.position_embedding(gh, gw)[None].to(x.dtype)

        # Window-persistent execution: consecutive windowed, non-pooling
        # blocks run in window-major layout with one partition/unpartition
        # per run. Runs break at q-pool blocks, global blocks and stage ends
        # (outputs need the spatial layout), and need the window to tile the
        # grid exactly (with pad tokens a persistent layout would let them
        # evolve through LN/MLP between blocks instead of re-zeroing them).
        outputs: list[torch.Tensor] = []
        gh_cur, gw_cur = gh, gw
        i, n_blocks = 0, len(self.blocks)
        while i < n_blocks:
            window, q_pool, stage_end = self.specs[i]
            runnable = (self.window_persistent and window > 0 and not q_pool
                        and gh_cur % window == 0 and gw_cur % window == 0)
            j = i
            while runnable and j < n_blocks and self.specs[j][0] == window and not self.specs[j][1]:
                j += 1
                if self.specs[j - 1][2]:  # stage end: its output needs the spatial layout
                    break
            if j - i >= 2:
                x, padded = window_partition(x, window)
                for blk in self.blocks[i:j]:
                    x = blk(x, pre_windowed=True)
                x = window_unpartition(x, window, padded, (gh_cur, gw_cur))
                if self.specs[j - 1][2]:
                    outputs.append(x)
                i = j
                continue
            x = self.blocks[i](x)
            if q_pool:
                gh_cur, gw_cur = gh_cur // 2, gw_cur // 2
            if stage_end:
                outputs.append(x)
            i += 1
        return outputs
