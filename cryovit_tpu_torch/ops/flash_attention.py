"""Multi-head attention for DINOv2 with the q/k/v biases applied inside.

Counterpart of ``cryovit_tpu/ops/flash_attention.py:flash_attention_pairs``
in its channel-major form: q, k and v arrive in the qkv projection's natural
``(B, N, H·D)`` layout (column views of one fused projection are fine), the
biases are added inside, keys at or past ``true_len`` are excluded, and the
output comes back as ``(B, N, H·D)`` — no transposes around the call.

- :func:`flash_attention` is the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches the Hopper kernel
  (``csrc/flash_attention.cu``) or raises.
- :func:`flash_attention_reference` is the plain PyTorch version (einsum +
  softmax in f32), used on the CPU and as the kernel's oracle on the card.

The TPU kernel's head pairing into 128-lane planes and its token pad to
``preferred_len`` are TPU layout devices and have no counterpart here: the
CUDA kernel masks its own ragged tail.
"""

from __future__ import annotations

import torch

from cryovit_tpu_torch import kernels

__all__ = ["HEAD_DIM", "flash_attention", "flash_attention_reference"]

HEAD_DIM = 64  # the head width the CUDA kernel is built for (ViT-g: 24 x 64)
_LOG2E = 1.4426950408889634


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain attention: ``softmax(scale·(q+bq)(k+bk)ᵀ)(v+bv)`` per head.

    q, k, v: ``(B, N, H·D)``; bias: ``(3, H·D)`` rows q, k, v; keys at or
    past ``true_len`` (default N) are excluded; ``scale`` defaults to
    D^-½. The biases are added in the input dtype, the softmax runs in f32
    and the probabilities are rounded to v's dtype before the product with
    v, as in the kernel. Returns ``(B, N, H·D)`` in q's dtype.
    """
    b, n, c = q.shape
    d = c // num_heads
    kv_len = n if true_len is None else true_len
    scale = d**-0.5 if scale is None else scale

    def heads(x: torch.Tensor, row: int) -> torch.Tensor:
        return (x + bias[row]).float().reshape(b, n, num_heads, d)

    qh = heads(q, 0)
    kh = heads(k, 1)[:, :kv_len]
    vh = heads(v, 2)[:, :kv_len]
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vh)
    return out.reshape(b, n, c).to(q.dtype)


def _check_cuda_args(q, k, v, bias, num_heads, kv_len) -> None:
    tensors = {"q": q, "k": k, "v": v, "bias": bias}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bf16; {name} is {t.dtype}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, N, C) shape: {q.shape}, {k.shape}, {v.shape}")
    b, n, c = q.shape
    if c != num_heads * HEAD_DIM:
        raise ValueError(f"the kernel needs head dim {HEAD_DIM}: C={c}, heads={num_heads}")
    if k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k and v must share strides")
    if q.stride(2) != 1 or q.stride(1) % 8 or q.stride(0) % 8 or q.stride(1) < c:
        raise ValueError(f"unsupported q/k/v strides {q.stride()}")
    if tuple(bias.shape) != (3, c) or not bias.is_contiguous():
        raise ValueError(f"bias must be a contiguous (3, {c}) tensor, got {tuple(bias.shape)}")
    if not 1 <= kv_len <= n:
        raise ValueError(f"true_len={kv_len} outside [1, {n}]")
    if b > 65535 or num_heads > 65535:
        raise ValueError("batch and heads must each be at most 65535")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    num_heads: int,
    true_len: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Attention as :func:`flash_attention_reference` computes it.

    On a CUDA device the Hopper kernel runs: bf16 q/k/v/bias, head dim 64,
    q/k/v sharing strides with a unit column stride (views of one fused qkv
    output qualify). Anything it cannot take raises; it never falls back.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, num_heads, true_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    b, n, c = q.shape
    kv_len = n if true_len is None else true_len
    scale = HEAD_DIM**-0.5 if scale is None else scale
    _check_cuda_args(q, k, v, bias, num_heads, kv_len)
    lib = kernels.load_library()
    out = torch.empty((b, n, c), dtype=q.dtype, device=q.device)
    rc = lib.cryovit_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, n, num_heads, q.stride(1), q.stride(0), kv_len,
        float(scale * _LOG2E), torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, "flash_attention")
    kernels.count_launch("flash_attention")
    return out
