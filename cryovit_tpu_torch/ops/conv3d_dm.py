"""SAME 3×3×3 convolution on depth-major activations (the decoder tail).

Counterpart of ``cryovit_tpu/ops/conv3d_dm.py:conv3d_dm``: x is
``(B, D, Ci, H, W)``, the kernel is in the flax ``(3, 3, 3, Ci, Co)`` tap
order, dilation acts on depth only, out-of-range taps count as zero, sums
accumulate in f32 and the output ``(B, D, Co, H, W)`` has x's dtype.

- :func:`conv3d_dm` is the wrapper: a CPU tensor takes the plain version, a
  CUDA tensor launches the Hopper kernel (``csrc/conv3d_dm.cu``) or raises.
  Unlike the TPU kernel it takes any W (no ``W % 128`` gate).
- :func:`conv3d_dm_reference` is the plain PyTorch version (``F.conv3d`` on a
  permuted view, in f32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cryovit_tpu_torch import kernels

__all__ = ["KERNEL_COUT", "conv3d_dm", "conv3d_dm_reference"]

KERNEL_COUT = (1, 8, 16, 32)  # output widths the CUDA kernel is built for


def conv3d_dm_reference(
    x: torch.Tensor, kernel: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """Plain SAME k=3³ conv on depth-major ``(B, D, Ci, H, W)``, f32 sums."""
    dilation = tuple(int(s) for s in dilation)
    xt = x.permute(0, 2, 1, 3, 4).float()  # (B, Ci, D, H, W)
    wt = kernel.permute(4, 3, 0, 1, 2).float()  # (Co, Ci, kd, kh, kw)
    y = F.conv3d(xt, wt, padding=dilation, dilation=dilation)
    return y.permute(0, 2, 1, 3, 4).to(x.dtype).contiguous()


def conv3d_dm(
    x: torch.Tensor, kernel: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """The conv as :func:`conv3d_dm_reference` computes it.

    On a CUDA device the Hopper kernel runs: contiguous bf16 x, a
    ``(3, 3, 3, Ci, Co)`` kernel with Co in :data:`KERNEL_COUT`, dilation
    ``(d, 1, 1)``. Anything else raises; it never falls back.
    """
    if x.device.type == "cpu":
        return conv3d_dm_reference(x, kernel, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_dm kernel for device {x.device}")
    dd, dh, dw = (int(s) for s in dilation)
    if x.dim() != 5 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            f"conv3d_dm kernel takes contiguous bf16 (B, D, Ci, H, W); got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    b, d, ci, h, w = x.shape
    if tuple(kernel.shape[:4]) != (3, 3, 3, ci) or kernel.dim() != 5:
        raise ValueError(f"kernel {tuple(kernel.shape)} is not (3, 3, 3, {ci}, Co)")
    co = kernel.shape[4]
    if co not in KERNEL_COUT:
        raise ValueError(f"conv3d_dm kernel supports Co in {KERNEL_COUT}, got {co}")
    if (dh, dw) != (1, 1) or dd < 1:
        raise ValueError(f"conv3d_dm dilates depth only, got {(dd, dh, dw)}")
    if b * d > 65535:
        raise ValueError("B·D must be at most 65535")
    if kernel.device != x.device:
        raise ValueError(f"kernel is on {kernel.device}, x on {x.device}")
    lib = kernels.load_library()
    wmat = kernel.to(torch.float32).contiguous()
    y = torch.empty((b, d, co, h, w), dtype=x.dtype, device=x.device)
    rc = lib.cryovit_conv3d_dm(
        x.data_ptr(), wmat.data_ptr(), y.data_ptr(), b, d, ci, co, h, w, dd,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "conv3d_dm")
    kernels.count_launch("conv3d_dm")
    return y
