"""2× lateral ConvTranspose on depth-major activations (the decoder tail).

Counterpart of ``cryovit_tpu/ops/convt_dm.py:convt2x_dm``: kernel
``(1, 2, 2)``, stride ``(1, 2, 2)``, x ``(B, D, Ci, H, W)``, the kernel in
flax's unflipped ``(1, 2, 2, Ci, Co)`` layout, output ``(B, D, Co, 2H, 2W)``
in x's dtype with f32 sums. flax's convention puts tap ``(a, c)`` at output
parity ``(1−a, 1−c)``: ``y[2h+a, 2w+c] = Σ x[h, w]·K[0, 1−a, 1−c]``.

- :func:`convt2x_dm` is the wrapper: a CPU tensor takes the plain version, a
  CUDA tensor launches the Hopper kernel (``csrc/convt_dm.cu``) or raises.
- :func:`convt2x_dm_reference` is the plain PyTorch version: the four parity
  products as one einsum, and the interleave as a reshape.
"""

from __future__ import annotations

import torch

from cryovit_tpu_torch import kernels

__all__ = ["KERNEL_COUT", "KERNEL_MAX_CIN", "convt2x_dm", "convt2x_dm_reference"]

KERNEL_COUT = (1, 8, 16, 32)
KERNEL_MAX_CIN = 64


def _parity_weights(kernel: torch.Tensor) -> torch.Tensor:
    """flax ``(1, 2, 2, Ci, Co)`` → ``(2, 2, Ci, Co)`` indexed by the output
    parity each tap lands on."""
    return kernel[0].flip(0, 1)


def convt2x_dm_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain 2× ConvTranspose on depth-major ``(B, D, Ci, H, W)``, f32 sums."""
    b, d, _, h, w = x.shape
    co = kernel.shape[-1]
    wp = _parity_weights(kernel).float()
    y = torch.einsum("bdihw,acio->bdohawc", x.float(), wp)  # (B,D,Co,H,2,W,2)
    return y.reshape(b, d, co, 2 * h, 2 * w).to(x.dtype)


def convt2x_dm(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The ConvTranspose as :func:`convt2x_dm_reference` computes it.

    On a CUDA device the Hopper kernel runs: contiguous bf16 x with
    Ci ≤ :data:`KERNEL_MAX_CIN`, Co in :data:`KERNEL_COUT`. Anything else
    raises; it never falls back.
    """
    if x.device.type == "cpu":
        return convt2x_dm_reference(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"no convt2x_dm kernel for device {x.device}")
    if x.dim() != 5 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            f"convt2x_dm kernel takes contiguous bf16 (B, D, Ci, H, W); got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    b, d, ci, h, w = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (1, 2, 2, ci):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not (1, 2, 2, {ci}, Co)")
    co = kernel.shape[4]
    if co not in KERNEL_COUT or ci > KERNEL_MAX_CIN:
        raise ValueError(
            f"convt2x_dm kernel supports Ci <= {KERNEL_MAX_CIN} and Co in "
            f"{KERNEL_COUT}, got Ci={ci}, Co={co}"
        )
    if b * d > 65535:
        raise ValueError("B·D must be at most 65535")
    if kernel.device != x.device:
        raise ValueError(f"kernel is on {kernel.device}, x on {x.device}")
    lib = kernels.load_library()
    wmat = _parity_weights(kernel).to(torch.float32).contiguous()
    y = torch.empty((b, d, co, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = lib.cryovit_convt2x_dm(
        x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, d, ci, co, h, w,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "convt2x_dm")
    kernels.count_launch("convt2x_dm")
    return y
