"""Windowed attention and the fused window blocks of the Hiera trunk.

Counterparts of ``cryovit_tpu/ops/window_attention.py``. The port keeps the
math of its three Pallas kernels and drops their TPU layout: there are no
head-padded 128-lane planes and no ones column in v. q, k and v are column
views of the unpadded ``(rows, 3·H·D)`` qkv projection, the weights are the
unpadded torch ``nn.Linear`` weights ``(out, in)``, and the kernels sum the
softmax denominator themselves. As in the JAX package, q arrives pre-scaled
by ``D^-½·log2(e)``: :func:`fold_q_scale` folds that factor into the q third
of the qkv projection, in f32 before the weights are cast to bf16.

- :func:`window_block_attention`: ``x + proj(MHA(qkv(LN(x))))`` per window
  of ``(N, T, C)`` tokens (``csrc/window_block.cu``'s wgmma + TMA
  LayerNorm-prologue and residual products + ``csrc/attention_sm90.cu`` on
  a GPU).
- :func:`window_block_mlp`: ``x + fc2(GELU(fc1(LN(x))))`` per token
  (``csrc/window_block.cu``).
- :func:`window_attention`: ``softmax(q kᵀ) v`` per (batch, head), for the
  global blocks (``csrc/attention_sm90.cu``, the wgmma + TMA body shared
  with the DINOv2 attention).

Each wrapper runs its plain version (``*_reference``) for CPU tensors and
launches its kernel for CUDA tensors, or raises. The plain versions follow
the TPU kernels' recipe: LayerNorm with f32 statistics and the variance as
E[x²] − mean², output rounded to the input dtype; products accumulated in
f32 and rounded once; attention with the exact f32 row max of the scores
(already in the log2 domain), bf16 probabilities ``exp2(bf16(s − m))`` and
their f32 sum as the denominator; exact (erf) GELU in f32. The CUDA
attention takes the row max online, in one pass over the keys: the same
function, with the probabilities rounded against the running max.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cryovit_tpu_torch import kernels

__all__ = [
    "HEAD_DIMS",
    "MAX_BLOCK_WIDTH",
    "fold_q_scale",
    "layer_norm_f32",
    "window_attention",
    "window_attention_reference",
    "window_block_attention",
    "window_block_attention_reference",
    "window_block_mlp",
    "window_block_mlp_reference",
]

# head widths the CUDA attention kernel is built for: 72 (sam2.1_hiera_l),
# 96 (Hiera-T's global blocks, SAM2Config.medsam_tiny())
HEAD_DIMS = (72, 96)
# the widest C the window-block kernels take: their LayerNorm products hold
# 128 rows of C in shared memory beside the weight ring (csrc/window_block.cu)
MAX_BLOCK_WIDTH = 704
LOG2E = 1.4426950408889634


def layer_norm_f32(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis: f32 statistics, the variance as
    E[x²] − mean² (flax's fast variance, and ``_ln_f32`` of the TPU
    kernels), f32 affine, output in x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    inv = torch.rsqrt(var.clamp_min(0.0) + eps)
    return ((xf - mean) * inv * weight.float() + bias.float()).to(x.dtype)


def fold_q_scale(
    weight: torch.Tensor, bias: torch.Tensor, heads: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The qkv projection ``(3C, C)`` / ``(3C,)`` as the attention kernels
    take it: its q third times ``D^-½·log2(e)`` (D = C / heads), in the
    input's dtype. The JAX package folds the factor into f32 weights before
    their cast to bf16; so does the port's encoder."""
    c = weight.shape[0] // 3
    factor = torch.ones(3 * c, dtype=weight.dtype, device=weight.device)
    factor[:c] = (c // heads) ** -0.5 * LOG2E
    return weight * factor[:, None], bias * factor


def _linear_f32(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), weight.float().t()) + bias.float()


def window_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> torch.Tensor:
    """Plain attention in the kernels' recipe. q, k, v: ``(B, T, H·D)``
    (column views are fine), q pre-scaled by ``D^-½·log2(e)``. Returns
    ``(B, T, H·D)`` in q's dtype."""
    b, t, c = q.shape
    d = c // heads

    def split(x: torch.Tensor) -> torch.Tensor:
        return x.float().reshape(b, t, heads, d).transpose(1, 2)

    s = torch.matmul(split(q), split(k).transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2((s - m).to(torch.bfloat16).float()).to(torch.bfloat16).float()
    out = torch.matmul(p, split(v)) * (1.0 / p.sum(-1, keepdim=True))
    return out.transpose(1, 2).reshape(b, t, c).to(q.dtype)


def window_block_attention_reference(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    qkv_weight: torch.Tensor,
    qkv_bias: torch.Tensor,
    proj_weight: torch.Tensor,
    proj_bias: torch.Tensor,
    heads: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain attention half-block ``x + proj(MHA(qkv(LN(x))))`` on
    ``(N, T, C)`` windows, the qkv projection's q third pre-scaled
    (:func:`fold_q_scale`): qkv rounded to x's dtype, as the kernel stores
    it."""
    c = x.shape[-1]
    y = layer_norm_f32(x, ln_weight, ln_bias, eps)
    qkv = _linear_f32(y, qkv_weight, qkv_bias).to(x.dtype)
    attn = window_attention_reference(
        qkv[..., :c], qkv[..., c : 2 * c], qkv[..., 2 * c :], heads
    )
    return (x.float() + _linear_f32(attn, proj_weight, proj_bias)).to(x.dtype)


def window_block_mlp_reference(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain MLP half-block ``x + fc2(GELU(fc1(LN(x))))`` per token: the
    hidden activation rounded to x's dtype, as the kernel stores it."""
    y = layer_norm_f32(x, ln_weight, ln_bias, eps)
    hidden = F.gelu(_linear_f32(y, fc1_weight, fc1_bias)).to(x.dtype)
    return (x.float() + _linear_f32(hidden, fc2_weight, fc2_bias)).to(x.dtype)


def _device_of(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {x.device}")
    return x.device.type


def _check(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"the kernel takes {name} as {dtype}; got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {tuple(shape)} tensor; got {tuple(t.shape)} "
            f"contiguous={t.is_contiguous()}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_width(c: int, heads: int | None = None) -> None:
    if c % 8:
        raise ValueError(f"the window kernels take channel counts that are multiples of 8; got {c}")
    if heads is not None and (c % heads or c // heads not in HEAD_DIMS):
        raise ValueError(
            f"the attention kernel is built for head dim in {HEAD_DIMS}: C={c}, heads={heads}"
        )


def _check_block_width(c: int) -> None:
    if c > MAX_BLOCK_WIDTH:
        raise ValueError(
            f"the window-block kernels take C up to {MAX_BLOCK_WIDTH} (their LayerNorm products "
            f"hold 128 rows of C in shared memory); got {c}"
        )


def window_block_attention(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    qkv_weight: torch.Tensor,
    qkv_bias: torch.Tensor,
    proj_weight: torch.Tensor,
    proj_bias: torch.Tensor,
    heads: int,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + proj(MHA(qkv(LN(x))))`` per window, as
    :func:`window_block_attention_reference` computes it.

    x: ``(N, T, C)`` windows of tokens; LayerNorm affine ``(C,)`` f32;
    qkv ``(3C, C)`` / ``(3C,)`` with its q third pre-scaled
    (:func:`fold_q_scale`) and proj ``(C, C)`` / ``(C,)`` in torch Linear
    layout. On a CUDA device: bf16 x and weights, contiguous, C at most
    :data:`MAX_BLOCK_WIDTH`, head dim in :data:`HEAD_DIMS`; anything else
    raises.
    """
    if _device_of(x, "window-block attention") == "cpu":
        return window_block_attention_reference(
            x, ln_weight, ln_bias, qkv_weight, qkv_bias, proj_weight, proj_bias, heads, eps
        )
    if x.dim() != 3:
        raise ValueError(f"x must be (N, T, C); got {tuple(x.shape)}")
    n, t, c = x.shape
    _check_width(c, heads)
    _check_block_width(c)
    bf, dev = torch.bfloat16, x.device
    _check(x, "x", (n, t, c), bf, dev)
    for name, tensor, shape, dtype in (
        ("ln_weight", ln_weight, (c,), torch.float32), ("ln_bias", ln_bias, (c,), torch.float32),
        ("qkv_weight", qkv_weight, (3 * c, c), bf), ("qkv_bias", qkv_bias, (3 * c,), bf),
        ("proj_weight", proj_weight, (c, c), bf), ("proj_bias", proj_bias, (c,), bf),
    ):
        _check(tensor, name, shape, dtype, dev)
    if n > 65535 or n * t >= 2**31:
        raise ValueError(f"at most 65535 windows and 2³¹ − 1 tokens; got {n} x {t}")
    lib = kernels.load_library()
    qkv = torch.empty((n * t, 3 * c), dtype=bf, device=dev)
    attn = torch.empty((n * t, c), dtype=bf, device=dev)
    out = torch.empty_like(x)
    rc = lib.cryovit_window_block_attention(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), qkv_weight.data_ptr(),
        qkv_bias.data_ptr(), proj_weight.data_ptr(), proj_bias.data_ptr(), qkv.data_ptr(),
        attn.data_ptr(), out.data_ptr(), n, t, c, heads, float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "window_block_attention")
    kernels.count_launch("window_block_attention")
    return out


def window_block_mlp(
    x: torch.Tensor,
    ln_weight: torch.Tensor,
    ln_bias: torch.Tensor,
    fc1_weight: torch.Tensor,
    fc1_bias: torch.Tensor,
    fc2_weight: torch.Tensor,
    fc2_bias: torch.Tensor,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``x + fc2(GELU(fc1(LN(x))))`` per token of ``x (..., C)``, as
    :func:`window_block_mlp_reference` computes it. fc1 ``(F, C)`` /
    ``(F,)``, fc2 ``(C, F)`` / ``(C,)``. On a CUDA device: bf16 x and
    weights, contiguous, C and F multiples of 8, C at most
    :data:`MAX_BLOCK_WIDTH`; anything else raises."""
    if _device_of(x, "window-block MLP") == "cpu":
        return window_block_mlp_reference(
            x, ln_weight, ln_bias, fc1_weight, fc1_bias, fc2_weight, fc2_bias, eps
        )
    c = x.shape[-1]
    hidden_dim = fc1_weight.shape[0]
    _check_width(c)
    _check_block_width(c)
    _check_width(hidden_dim)
    rows = x.numel() // c
    bf, dev = torch.bfloat16, x.device
    _check(x, "x", x.shape, bf, dev)
    for name, tensor, shape, dtype in (
        ("ln_weight", ln_weight, (c,), torch.float32), ("ln_bias", ln_bias, (c,), torch.float32),
        ("fc1_weight", fc1_weight, (hidden_dim, c), bf), ("fc1_bias", fc1_bias, (hidden_dim,), bf),
        ("fc2_weight", fc2_weight, (c, hidden_dim), bf), ("fc2_bias", fc2_bias, (c,), bf),
    ):
        _check(tensor, name, shape, dtype, dev)
    if rows >= 2**31:
        raise ValueError(f"at most 2³¹ − 1 tokens; got {rows}")
    lib = kernels.load_library()
    hidden = torch.empty((rows, hidden_dim), dtype=bf, device=dev)
    out = torch.empty_like(x)
    rc = lib.cryovit_window_block_mlp(
        x.data_ptr(), ln_weight.data_ptr(), ln_bias.data_ptr(), fc1_weight.data_ptr(),
        fc1_bias.data_ptr(), fc2_weight.data_ptr(), fc2_bias.data_ptr(), hidden.data_ptr(),
        out.data_ptr(), rows, c, hidden_dim, float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(rc, "window_block_mlp")
    kernels.count_launch("window_block_mlp")
    return out


def window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int
) -> torch.Tensor:
    """Attention per (batch, head) as :func:`window_attention_reference`
    computes it; q (pre-scaled by ``D^-½·log2(e)``), k, v ``(B, T, H·D)``,
    output ``(B, T, H·D)``.

    On a CUDA device: bf16 q/k/v sharing strides with a unit column stride
    (views of one fused qkv output qualify), head dim in :data:`HEAD_DIMS`;
    the kernel loads them by TMA, which takes 16-byte aligned bases and row
    and batch strides that are multiples of 8 elements. Anything else
    raises.
    """
    if _device_of(q, "attention") == "cpu":
        return window_attention_reference(q, k, v, heads)
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, T, C) shape: {q.shape}, {k.shape}, {v.shape}")
    b, t, c = q.shape
    _check_width(c, heads)
    for name, tensor in (("q", q), ("k", k), ("v", v)):
        if tensor.device != q.device or tensor.dtype != torch.bfloat16:
            raise ValueError(f"the attention kernel takes bf16 on one device; {name} is "
                             f"{tensor.dtype} on {tensor.device}")
        if tensor.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (TMA)")
        if tensor.stride() != q.stride():
            raise ValueError("q, k and v must share strides")
    if q.stride(2) != 1 or q.stride(1) % 8 or q.stride(0) % 8 or q.stride(1) < c:
        raise ValueError(f"unsupported q/k/v strides {q.stride()}: TMA needs a unit column "
                         "stride and row and batch strides that are multiples of 8")
    if b > 65535 or heads > 65535:
        raise ValueError("batch and heads must each be at most 65535")
    lib = kernels.load_library()
    out = torch.empty((b, t, c), dtype=q.dtype, device=q.device)
    rc = lib.cryovit_window_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, heads, c // heads,
        q.stride(1), q.stride(0), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, "window_attention")
    kernels.count_launch("window_attention")
    return out
