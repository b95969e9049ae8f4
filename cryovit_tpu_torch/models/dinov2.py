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
- Attention, with heads that pair (``pair_heads``, the default for head
  width 64 and an even head count), reads q, k and v as column views of one
  qkv projection and applies their biases inside the kernel
  (``ops/flash_attention.py:flash_attention``, or the model's
  ``pair_attention_fn``, e.g. its int8 modes). Otherwise it takes the
  head-major branch: the biased projection viewed as ``(B, H, N, D)``
  planes, ``flash_attention_bhnd``, and the output projection reading the
  kernel's ``(B, N, H, D)`` output as ``(B, N, C)``.
- LayerNorm statistics are f32 (``F.layer_norm``; the JAX package uses the
  "fast" variance E[x²] − E[x]², which differs at the 1e-5 level in f32);
  the residual stream is in ``residual_dtype`` (default: the compute
  dtype), the final norm in f32.
- ``fused_ln`` gives the blocks the JAX package's deferred-residual carry
  ``(x, pending)``: every residual add + LayerScale + LayerNorm pair is one
  ``ops/fused_norm.py:residual_layernorm`` call, two per block.
- ``quant_int8`` (the opt-in w8a8 mode, :meth:`DinoV2.quantize_int8`)
  computes the pair path's qkv projection and every block's w12 as int8
  products (``ops/quant.py``); the output projection, w3 and the head-major
  branch's qkv stay in the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch import require_bf16_on_cuda
from cryovit_tpu_torch.ops.flash_attention import flash_attention, flash_attention_bhnd
from cryovit_tpu_torch.ops.fused_norm import residual_layernorm
from cryovit_tpu_torch.ops.quant import int8_linear, quantize_weight
from cryovit_tpu_torch.ops.resize import _cubic_kernel

__all__ = [
    "BF16_KERNELS", "DinoV2Config", "DinoV2", "assign_weights", "interpolate_pos_embed",
    "make_dinov2",
]

# the backbone's CUDA kernels, bf16 only (a CUDA device refuses another
# compute dtype up front: cryovit_tpu_torch.require_bf16_on_cuda)
BF16_KERNELS = "flash_attention, flash_attention_bhnd, residual_layernorm"


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
    """Multi-head self-attention; with ``pair_heads``, ``pair_attention_fn``
    (default ``flash_attention``, with the signature of
    ``ops/flash_attention.py:flash_attention``) computes it from column
    views of the qkv projection and the (3, C) biases, as the JAX
    ``Attention.pair_attention_fn`` does; e.g.
    ``partial(flash_attention, quant="qkpv")`` for the int8 internals.

    With int8 qkv weights (:meth:`quantize_int8`, the w8a8 mode) the pair
    path's projection is one int8 product; the kernel still takes the
    softmax scale (JAX folds it into the q third before quantizing, which
    differs by one bf16 rounding of the q weights)."""

    def __init__(self, dim: int, num_heads: int, pair_heads: bool = True,
                 pair_attention_fn=flash_attention):
        super().__init__()
        self.num_heads = num_heads
        self.pair_heads = pair_heads
        self.pair_attention_fn = pair_attention_fn
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("qkv_int8", None, persistent=False)
        self.register_buffer("qkv_int8_scale", None, persistent=False)

    def quantize_int8(self) -> None:
        """Quantize the qkv weight, in its compute dtype, per output channel
        (the pair path's w8a8 projection; JAX casts before it quantizes)."""
        self.qkv_int8, self.qkv_int8_scale = quantize_weight(self.qkv.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        d = c // self.num_heads
        if not self.pair_heads:
            # head-major (JAX dinov2.py:262-275): the bias is added by the
            # projection, q/k/v are permuted (B, H, N, D) views of its
            # (B, N, 3, H, D) output, and the kernel's output, (B, N, H, D)
            # in memory, is read by the output projection as (B, N, C)
            qkv = F.linear(x, self.qkv.weight, self.qkv.bias).view(b, n, 3, self.num_heads, d)
            out = flash_attention_bhnd(*(qkv[:, :, i].transpose(1, 2) for i in range(3)))
            return F.linear(out.transpose(1, 2).reshape(b, n, c), self.proj.weight, self.proj.bias)
        # one (B·N, C)·(C, 3C) product in its natural layout; q, k and v are
        # column views of it, and their biases are added inside the kernel
        if self.qkv_int8 is not None:
            qkv = int8_linear(x, self.qkv_int8, self.qkv_int8_scale, None, self.qkv.weight.dtype)
        else:
            qkv = F.linear(x, self.qkv.weight)
        out = self.pair_attention_fn(
            qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :],
            self.qkv.bias.view(3, c), self.num_heads, scale=d**-0.5,
        )
        return F.linear(out, self.proj.weight, self.proj.bias)


class SwiGLUFFN(nn.Module):
    """``w3(silu(x1) · x2)`` with ``x1, x2 = split(w12 x)``; w12 an int8
    product once :meth:`quantize_int8` has run (w3 stays in the compute
    dtype, as in the JAX package)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)
        self.register_buffer("w12_int8", None, persistent=False)
        self.register_buffer("w12_int8_scale", None, persistent=False)

    def quantize_int8(self, weight: torch.Tensor) -> None:
        """Quantize ``weight``, w12's values before the cast to the compute
        dtype (JAX quantizes the parameter as stored), per output channel."""
        self.w12_int8, self.w12_int8_scale = quantize_weight(weight.to(self.w12.weight.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w12 = self.w12
        if self.w12_int8 is not None:
            x12 = int8_linear(x, self.w12_int8, self.w12_int8_scale, w12.bias, w12.weight.dtype)
        else:
            x12 = w12(x)
        x1, x2 = x12.chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class LayerScale(nn.Module):
    """Holds ``gamma`` under the hub name; ``Block`` applies it with the
    residual add."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``norm`` over ``x`` in x's dtype (f32 statistics), output in ``dtype``."""
    w, b = norm.weight.to(x.dtype), norm.bias.to(x.dtype)
    return F.layer_norm(x, norm.normalized_shape, w, b, norm.eps).to(dtype)


class Block(nn.Module):
    """Pre-LN block with LayerScale: ``x + ls1·attn(LN1 x)``, then
    ``x + ls2·mlp(LN2 x)`` (torch hub ``dinov2/layers/block.py``). The
    residual stream ``x`` may be in another dtype than the parameters (the
    compute dtype)."""

    def __init__(self, cfg: DinoV2Config, pair_heads: bool = True,
                 pair_attention_fn=flash_attention):
        super().__init__()
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.attn = Attention(dim, cfg.num_heads, pair_heads, pair_attention_fn)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = SwiGLUFFN(dim, cfg.ffn_hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # LayerNorm in one kernel (f32 statistics inside, output in the
        # compute dtype); LayerScale and the residual add in one addcmul in
        # the stream's dtype
        dtype = self.ls1.gamma.dtype
        h = self.attn(_layer_norm(self.norm1, x, dtype))
        x = torch.addcmul(x, h.to(x.dtype), self.ls1.gamma.to(x.dtype))
        h = self.mlp(_layer_norm(self.norm2, x, dtype))
        return torch.addcmul(x, h.to(x.dtype), self.ls2.gamma.to(x.dtype))

    def forward_fused(
        self, x: torch.Tensor, pending: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """The JAX package's deferred-residual carry (``dinov2.py:383-416``):
        ``pending``, the previous block's LayerScale-scaled MLP output, is
        added here, fused with this block's first LayerNorm; the second
        LayerNorm is fused with the attention branch's LayerScale and add;
        the MLP branch is returned as the next ``pending``, rounded to the
        compute dtype before the cast to the stream's."""
        dtype = self.ls1.gamma.dtype
        eps = self.norm1.eps
        x, h = residual_layernorm(x, pending, None, self.norm1.weight, self.norm1.bias, eps, dtype)
        h = self.attn(h)
        x, h = residual_layernorm(x, h, self.ls1.gamma, self.norm2.weight, self.norm2.bias, eps,
                                  dtype)
        h = self.mlp(h)
        return x, (h * self.ls2.gamma.to(h.dtype)).to(x.dtype)


class DinoV2(nn.Module):
    """DINOv2 backbone returning normalized patch tokens.

    Input: ``(B, H, W)`` preprocessed slices (already 14/16-resized; H, W
    multiples of 14). Output: ``(B, gh·gw, embed_dim)`` f32 patch tokens.
    Computes in the dtype of its parameters; the options are those of
    :func:`make_dinov2`, resolved, and ``pair_attention_fn``, the paired
    heads' attention (:class:`Attention`), which ``make_dinov2`` leaves at
    its default as the JAX one does.
    """

    def __init__(
        self,
        cfg: DinoV2Config | None = None,
        *,
        pair_heads: bool = True,
        fused_ln: bool = False,
        residual_dtype: torch.dtype | None = None,
        pair_attention_fn=flash_attention,
    ):
        super().__init__()
        self.cfg = cfg = cfg or DinoV2Config.giant()
        self.fused_ln = fused_ln
        self.residual_dtype = residual_dtype  # None: the compute dtype
        e = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg)
        self.cls_token = nn.Parameter(torch.empty(1, 1, e))
        self.register_tokens = nn.Parameter(torch.empty(1, cfg.num_registers, e))
        self.pos_embed = nn.Parameter(torch.empty(1, 1 + cfg.pos_grid**2, e))
        self.blocks = nn.ModuleList(
            Block(cfg, pair_heads, pair_attention_fn) for _ in range(cfg.depth)
        )
        self.norm = nn.LayerNorm(e, eps=cfg.layer_norm_eps)

    def quantize_int8(self, state_dict: dict[str, torch.Tensor]) -> None:
        """The w8a8 mode: every block's w12 quantized from its value in
        ``state_dict`` (before the cast to the compute dtype) and, on the
        pair path, its qkv from the compute-dtype weight, per output channel
        into non-persistent buffers, once: the values of the JAX package's
        on-the-fly quantization, bit for bit. The state dict is unchanged."""
        for i, blk in enumerate(self.blocks):
            blk.mlp.quantize_int8(torch.as_tensor(state_dict[f"blocks.{i}.mlp.w12.weight"]))
            if blk.attn.pair_heads:
                blk.attn.quantize_int8()

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
        tokens = tokens.to(self.residual_dtype or dtype)
        if self.fused_ln:
            pending = torch.zeros_like(tokens)
            for blk in self.blocks:
                tokens, pending = blk.forward_fused(tokens, pending)
            tokens = tokens + pending  # flush the last block's deferred residual
        else:
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
    *,
    pair_heads: bool | None = None,
    fused_ln: bool | None = None,
    residual_dtype: torch.dtype | None = None,
    quant_int8: bool = False,
) -> DinoV2:
    """Build the extractor from a port state dict (torch hub names, patch
    embed folded to one channel), on ``device`` in ``dtype``, for inference.

    The options and their defaults are the JAX ``make_dinov2``'s:

    - ``pair_heads`` (default: head width 64 and an even head count, true
      for ViT-g): the channel-major attention kernel with in-kernel biases;
      false takes the head-major branch and ``flash_attention_bhnd``;
    - ``fused_ln`` (default false): the deferred-residual blocks with two
      ``residual_layernorm`` calls each;
    - ``residual_dtype`` (default: ``dtype``): the residual stream's dtype;
    - ``quant_int8`` (default false): the opt-in w8a8 mode
      (:meth:`DinoV2.quantize_int8`), the pair path's qkv and every w12 as
      int8 products.

    The module is built on the meta device and takes the state dict's
    tensors as its parameters (:func:`assign_weights`), so the giant model
    is never initialised twice or copied through host memory; tensors
    already on ``device`` in ``dtype`` are shared, not copied. On a CUDA
    device ``dtype`` must be bf16, the kernels' dtype: another raises before
    any weight is built."""
    target = device if device is not None else (  # None: where the tensors are
        "cuda" if any(torch.is_tensor(v) and v.is_cuda for v in state_dict.values()) else "cpu")
    require_bf16_on_cuda(target, dtype, f"make_dinov2(dtype={dtype})", BF16_KERNELS)
    cfg = cfg or DinoV2Config.giant()
    if pair_heads is None:
        pair_heads = cfg.embed_dim // cfg.num_heads == 64 and cfg.num_heads % 2 == 0
    with torch.device("meta"):
        model = DinoV2(cfg, pair_heads=pair_heads, fused_ln=bool(fused_ln),
                       residual_dtype=residual_dtype)
    model = assign_weights(model, state_dict, device, dtype)
    if quant_int8:
        model.quantize_int8(state_dict)
    return model


def assign_weights(
    model: DinoV2,
    state_dict: dict[str, torch.Tensor],
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.bfloat16,
) -> DinoV2:
    """``model`` (built on the meta device) for inference with the state
    dict's tensors as its parameters, on ``device`` in ``dtype``: tensors
    already there are shared, not copied."""
    sd = {k: torch.as_tensor(v).to(device=device, dtype=dtype) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval().requires_grad_(False)
