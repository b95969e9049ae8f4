"""Symmetric int8 quantization and the w8a8 product of the opt-in ``--int8``
mode (port of ``cryovit_tpu/ops/quant.py``).

- :func:`int8_quant`: per-token (activations, over the last dim) or
  per-output-channel (weights, over the input dim) symmetric int8
  quantization, bit for bit JAX's ``int8_quant``: f32 from the input,
  ``scale = max(amax, 1e-12) · f32(1/127)``, ``round(x / scale)`` (half to
  even), clipped to ±127.
- :func:`quantize_weight`: a torch Linear weight ``(N, K)`` → its int8 values
  and ``(N,)`` f32 per-output-channel scales (JAX's ``int8_quant(kernel,
  axis=0)`` of the ``(K, N)`` kernel).
- :func:`int8_matmul`: the int8×int8→int32 product and JAX's dequantization
  epilogue (``qeinsum``, and the tail of ``hiera._Dense``): ``acc · sx · sw``
  in f32, cast to the compute dtype, then the bias added in that dtype. The
  int32 accumulator is dequantized in place: the f32 values overwrite it.
- :func:`int8_linear`: :func:`int8_quant` of the activation per token, then
  :func:`int8_matmul`.

The product is ``torch._int_mm`` on both devices: cuBLASLt's int8 path on a
GPU (JAX leaves this product to XLA, outside any Pallas kernel), an exact
int32 product on the CPU (an f32 product of int8 values is not exact past
2^24). On a CUDA tensor :func:`int8_matmul` checks what ``_int_mm`` takes
there (more than 16 rows, K and N multiples of 8, the activation row-major,
the weight ``(N, K)`` contiguous so that its transpose is the column-major
operand cuBLASLt's int8 path asks for) and raises on anything else; it never
falls back. Each product adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import torch

__all__ = [
    "LAUNCHES",
    "int8_linear",
    "int8_matmul",
    "int8_quant",
    "launch_count",
    "quantize_weight",
    "reset_launch_count",
]

LAUNCHES = {"int8_matmul": 0}  # int8 products since the last reset


def reset_launch_count() -> None:
    LAUNCHES["int8_matmul"] = 0


def launch_count() -> int:
    return LAUNCHES["int8_matmul"]


def int8_quant(x: torch.Tensor, dim: int | tuple[int, ...]) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values int8, scale f32 with dim kept as size 1)`` such that
    ``values · scale ≈ x``, the amax taken over ``dim``."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-12) * (1.0 / 127.0)
    return torch.round(xf / scale).clamp_(-127.0, 127.0).to(torch.int8), scale


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A Linear weight ``(N, K)`` → ``(int8 (N, K) contiguous, f32 (N,))``,
    one scale per output channel."""
    wq, sw = int8_quant(weight, 1)
    return wq.contiguous(), sw.view(-1)


def _check_cuda_args(xq: torch.Tensor, wq: torch.Tensor) -> None:
    (m, k), n = xq.shape, wq.shape[0]
    problems = []
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        problems.append(f"int8 operands (got {xq.dtype}, {wq.dtype})")
    if m <= 16:
        problems.append(f"more than 16 rows (got {m})")
    if k % 8 or n % 8:
        problems.append(f"K and N multiples of 8 (got K={k}, N={n})")
    if not (xq.is_contiguous() and wq.is_contiguous()):
        problems.append("a row-major activation and a contiguous (N, K) weight")
    if problems:
        raise ValueError("int8_matmul on CUDA (torch._int_mm, cuBLASLt's int8 path) needs "
                         + "; ".join(problems))


def int8_matmul(
    xq: torch.Tensor,
    sx: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    dtype: torch.dtype,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(xq @ wqᵀ) · sx · sw`` → ``dtype``, plus ``bias`` in ``dtype``:
    ``xq`` int8 ``(M, K)``, ``sx`` f32 ``(M, 1)``, ``wq`` int8 ``(N, K)``,
    ``sw`` f32 ``(N,)``. Returns ``(M, N)``."""
    if xq.device.type == "cuda":
        _check_cuda_args(xq, wq)
    elif xq.device.type != "cpu":
        raise ValueError(f"int8_matmul runs on CUDA or the CPU, not {xq.device}")
    LAUNCHES["int8_matmul"] += 1
    acc = torch._int_mm(xq, wq.t())
    out = acc.view(torch.float32)  # the f32 values overwrite the int32 ones
    torch.mul(acc, sx, out=out)
    out.mul_(sw)
    y = out.to(dtype)
    if bias is not None:
        y.add_(bias.to(dtype))
    return y


def int8_linear(
    x: torch.Tensor,
    wq: torch.Tensor,
    sw: torch.Tensor,
    bias: torch.Tensor | None,
    dtype: torch.dtype,
) -> torch.Tensor:
    """The w8a8 projection of ``x (…, K)``: per-token quantization, then
    :func:`int8_matmul`; ``(…, N)`` in ``dtype``."""
    xq, sx = int8_quant(x, -1)
    k = x.shape[-1]
    y = int8_matmul(xq.reshape(-1, k).contiguous(), sx.reshape(-1, 1), wq, sw, dtype, bias)
    return y.view(*x.shape[:-1], wq.shape[0])
