"""Fused residual add + LayerScale + LayerNorm for the DINOv2 block.

Counterpart of ``cryovit_tpu/ops/fused_norm.py:residual_layernorm`` (Pallas
kernel ``_residual_ln_kernel``): ``x' = x + γ·h`` and ``y = LN(x')·s + b`` in
one pass over the ``(…, C)`` activation — x and h read once, x' and y
written once.

- :func:`residual_layernorm` is the wrapper: a CPU tensor takes the plain
  version, a CUDA tensor launches the Hopper kernel (``csrc/fused_norm.cu``)
  or raises, any other device raises.
- :func:`residual_layernorm_reference` is the plain PyTorch version.

Both follow the Pallas kernel rather than the JAX package's XLA oracle: x'
is computed in f32 and stored in x's dtype, the mean and the *centered*
variance come from the f32 x' (the oracle uses E[x²] − E[x]²), and γ, the
scale and the bias are upcast to f32. The TPU wrapper's 16-row / 128-channel
condition is a TPU tiling constraint with no counterpart here: the CUDA
kernel takes any number of rows and C a multiple of 8 up to 2048.
"""

from __future__ import annotations

import torch

from cryovit_tpu_torch import kernels

__all__ = ["MAX_CHANNELS", "residual_layernorm", "residual_layernorm_reference"]

MAX_CHANNELS = 2048  # one warp per row, 8 chunks of 8 channels per lane
# the (x, h) dtype pairs the model hands the kernel: bf16 stream, f32
# stream with a bf16 branch, f32 stream with the f32 deferred residual
_KERNEL_DTYPES = {(torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
                  (torch.float32, torch.float32)}


def residual_layernorm_reference(
    x: torch.Tensor,
    h: torch.Tensor,
    gamma: torch.Tensor | None,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-6,
    y_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x + γ·h, LayerNorm(x + γ·h)·scale + bias)`` with f32 statistics;
    ``gamma=None`` is a plain add. Returns x' in x's dtype and y in
    ``y_dtype``."""
    hf = h.float()
    if gamma is not None:
        hf = hf * gamma.float()
    xn = x.float() + hf
    cen = xn - xn.mean(dim=-1, keepdim=True)
    var = (cen * cen).mean(dim=-1, keepdim=True)
    y = cen * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return xn.to(x.dtype), y.to(y_dtype)


def _check_cuda_args(x, h, gamma, scale, bias, y_dtype) -> None:
    c = x.shape[-1]
    params = {"scale": scale, "bias": bias} | ({} if gamma is None else {"gamma": gamma})
    if (x.dtype, h.dtype) not in _KERNEL_DTYPES:
        raise TypeError(f"the residual_layernorm kernel takes (x, h) in bf16 or f32, an f32 h "
                        f"only with an f32 x; got {x.dtype}, {h.dtype}")
    for name, t in {"x": x, "h": h, **params}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if y_dtype != torch.bfloat16:
        raise TypeError(f"the residual_layernorm kernel writes y in bf16, not {y_dtype}")
    if h.shape != x.shape:
        raise ValueError(f"x and h shapes differ: {tuple(x.shape)}, {tuple(h.shape)}")
    if c % 8 or c > MAX_CHANNELS:
        raise ValueError(f"the kernel needs C a multiple of 8 up to {MAX_CHANNELS}, got {c}")
    for name, t in params.items():
        if tuple(t.shape) != (c,) or t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be a ({c},) bf16 vector, as the model holds it; got "
                            f"{tuple(t.shape)} {t.dtype}")


def residual_layernorm(
    x: torch.Tensor,
    h: torch.Tensor,
    gamma: torch.Tensor | None,
    scale: torch.Tensor,
    bias: torch.Tensor,
    eps: float = 1e-6,
    y_dtype: torch.dtype = torch.bfloat16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(x', y)`` as :func:`residual_layernorm_reference` computes them.

    - ``x``: residual stream ``(…, C)``; its dtype is kept in x',
    - ``h``: branch output to accumulate,
    - ``gamma``: LayerScale ``(C,)`` or ``None`` for a plain add,
    - ``scale``/``bias``: LayerNorm affine ``(C,)``,
    - ``y_dtype``: dtype of the normalized output.

    On a CUDA device the Hopper kernel runs: x and h contiguous, (x, h) in
    (bf16, bf16), (f32, bf16) or (f32, f32); gamma, scale and bias bf16; y in
    bf16; C a multiple of 8 up to 2048. Anything it cannot take raises; it
    never falls back."""
    if x.device.type == "cpu":
        return residual_layernorm_reference(x, h, gamma, scale, bias, eps, y_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no residual_layernorm kernel for device {x.device}")
    _check_cuda_args(x, h, gamma, scale, bias, y_dtype)
    c = x.shape[-1]
    x_out = torch.empty_like(x)
    y = torch.empty(x.shape, dtype=y_dtype, device=x.device)
    f32 = torch.float32
    rc = kernels.load_library().cryovit_residual_layernorm(
        x.data_ptr(), h.data_ptr(), None if gamma is None else gamma.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), x_out.data_ptr(), y.data_ptr(),
        x.numel() // c, c, x.dtype == f32, h.dtype == f32, float(eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "residual_layernorm")
    kernels.count_launch("residual_layernorm")
    return x_out, y
