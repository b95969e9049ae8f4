"""Multi-head attention for DINOv2, on one Hopper kernel
(``csrc/flash_attention.cu``) with three wrappers.

- :func:`flash_attention`: counterpart of
  ``cryovit_tpu/ops/flash_attention.py:flash_attention_pairs`` in its
  channel-major form. q, k and v arrive in the qkv projection's natural
  ``(B, N, H·D)`` layout (column views of one fused projection are fine),
  the biases are added inside, keys at or past ``true_len`` are excluded,
  and the output comes back as ``(B, N, H·D)`` — no transposes around the
  call. The TPU kernel's head pairing into 128-lane planes and its token pad
  to ``preferred_len`` are TPU layout devices and have no counterpart here:
  the CUDA kernel masks its own ragged tail.
- :func:`flash_attention_bhnd`: counterpart of ``flash_attention_bhnd``
  (Pallas ``_flash_kernel``) on head-major ``(B, H, N, D)``: no bias, the
  softmax denominator summed from the f32 probabilities.
- :func:`flash_attention_bnhd`: counterpart of the JAX package's
  ``flash_attention`` (the same ``_flash_kernel``) on ``(B, N, H, D)``; the
  port's name ``flash_attention`` already belongs to the first wrapper.

Each wrapper takes its plain PyTorch version (``*_reference``) for CPU
tensors, launches the kernel for CUDA tensors or raises, and raises on any
other device. The TPU block sizes (``block_q``, ``block_k``) and
``interpret`` have no meaning here and are not arguments.
"""

from __future__ import annotations

import ctypes

import torch

from cryovit_tpu_torch import kernels

__all__ = [
    "HEAD_DIM",
    "flash_attention",
    "flash_attention_bhnd",
    "flash_attention_bhnd_reference",
    "flash_attention_bnhd",
    "flash_attention_bnhd_reference",
    "flash_attention_reference",
]

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


def flash_attention_bhnd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
) -> torch.Tensor:
    """Plain ``_flash_kernel`` math on head-major ``(B, H, N, D)``: f32
    scores scaled by D^-½, ``exp`` of the max-shifted scores, the
    denominator summed from those f32 probabilities, the probabilities
    rounded to v's dtype for the product with v. Returns ``(B, H, N, D)`` in
    q's dtype, laid out as ``(B, N, H, D)`` in memory like the kernel's
    output."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()).mul_(q.shape[-1] ** -0.5)
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float()).div_(denom)
    return out.to(q.dtype).transpose(1, 2).contiguous().transpose(1, 2)


def flash_attention_bnhd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Plain ``_flash_kernel`` math on ``(B, N, H, D)``, inputs cast to
    ``dtype`` first as the JAX ``flash_attention`` does; ``(B, N, H, D)`` in
    ``dtype``."""
    q, k, v = (t.to(dtype).transpose(1, 2) for t in (q, k, v))
    return flash_attention_bhnd_reference(q, k, v).transpose(1, 2)


def _check_bhnd_args(q, k, v) -> None:
    for name, t in {"q": q, "k": k, "v": v}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the attention kernel takes bf16; {name} is {t.dtype}")
        if t.data_ptr() % 16 or t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name} needs 16-byte aligned rows (unit last stride, the others multiples "
                f"of 8): strides {t.stride()}"
            )
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, N, D) shape: {q.shape}, {k.shape}, {v.shape}"
        )
    b, h, n, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernel needs head dim {HEAD_DIM}, got {d}")
    if n < 1 or b > 65535 or h > 65535:
        raise ValueError(f"unsupported shape {tuple(q.shape)}")


def _launch_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, name: str) -> torch.Tensor:
    """The kernel on ``(B, H, N, 64)`` views: output written in
    ``(B, N, H, 64)`` memory and returned as a ``(B, H, N, 64)`` view."""
    _check_bhnd_args(q, k, v)
    b, h, n, d = q.shape
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    lib = kernels.load_library()
    rc = lib.cryovit_flash_attention_strided(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, h,
        (ctypes.c_longlong * 12)(*strides), float(d**-0.5 * _LOG2E),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    kernels.check(rc, name)
    kernels.count_launch(name)
    return out


def flash_attention_bhnd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Attention on head-major ``(B, H, N, D)`` q, k, v →
    ``(B, H, N, D)``, as :func:`flash_attention_bhnd_reference` computes it.

    On a CUDA device the Hopper kernel runs: bf16, head dim 64, any strides
    with a unit last stride and 16-byte aligned rows (permuted views of one
    ``(B, N, 3, H, D)`` projection qualify, and are not copied). The result
    is a ``(B, H, N, D)`` view of ``(B, N, H, D)`` memory, so
    ``out.transpose(1, 2).reshape(B, N, H·D)`` is free. Anything the kernel
    cannot take raises; it never falls back."""
    if q.device.type == "cpu":
        return flash_attention_bhnd_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch_bhnd(q, k, v, "flash_attention_bhnd")


def flash_attention_bnhd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """Attention on ``(B, N, H, D)`` q, k, v cast to ``dtype`` →
    ``(B, N, H, D)`` contiguous in ``dtype``: the JAX package's
    ``flash_attention`` (named apart here because :func:`flash_attention` is
    the channel-major wrapper). On a CUDA device ``dtype`` must be bf16 and
    the same kernel as :func:`flash_attention_bhnd` runs on the transposed
    views, without copies."""
    if q.device.type == "cpu":
        return flash_attention_bnhd_reference(q, k, v, dtype)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    q, k, v = (t.to(dtype).transpose(1, 2) for t in (q, k, v))
    return _launch_bhnd(q, k, v, "flash_attention_bnhd").transpose(1, 2)
