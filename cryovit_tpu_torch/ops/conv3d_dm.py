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

Its weight gradient, counterpart of ``conv3d_dm_dw`` (all 27 taps from one
pass over x and the cotangent g, f32 ``(3, 3, 3, Ci, Co)``):

- :func:`conv3d_dm_dw` is the wrapper (``csrc/conv3d_dm_dw.cu`` on a GPU);
- :func:`conv3d_dm_dw_reference` is the plain version: 27 shifted-window
  contractions in f32.

The input gradient needs no kernel of its own: it is :func:`conv3d_dm` with
the tap-flipped, in/out-swapped kernel (``models/cryovit.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cryovit_tpu_torch import kernels

__all__ = [
    "KERNEL_COUT",
    "conv3d_dm",
    "conv3d_dm_dw",
    "conv3d_dm_dw_reference",
    "conv3d_dm_reference",
]

KERNEL_COUT = (1, 8, 16, 32)  # output widths the CUDA kernel is built for


def _check_activation(t: torch.Tensor, name: str) -> None:
    if t.dim() != 5 or t.dtype != torch.bfloat16 or not t.is_contiguous():
        raise ValueError(
            f"{name} kernel takes contiguous bf16 (B, D, C, H, W); got "
            f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}"
        )


def _depth_dilation(dilation, name: str) -> int:
    dd, dh, dw = (int(s) for s in dilation)
    if (dh, dw) != (1, 1) or dd < 1:
        raise ValueError(f"{name} dilates depth only, got {(dd, dh, dw)}")
    return dd


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
    dd = _depth_dilation(dilation, "conv3d_dm")
    _check_activation(x, "conv3d_dm")
    b, d, ci, h, w = x.shape
    if tuple(kernel.shape[:4]) != (3, 3, 3, ci) or kernel.dim() != 5:
        raise ValueError(f"kernel {tuple(kernel.shape)} is not (3, 3, 3, {ci}, Co)")
    co = kernel.shape[4]
    if co not in KERNEL_COUT:
        raise ValueError(f"conv3d_dm kernel supports Co in {KERNEL_COUT}, got {co}")
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


def conv3d_dm_dw_reference(
    x: torch.Tensor, g: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """Plain weight gradient of :func:`conv3d_dm_reference`: for each of the
    27 taps, the shifted window of the zero-padded x contracted with g over
    (B, D, H, W), in f32. Returns ``(3, 3, 3, Ci, Co)`` f32."""
    dd = int(dilation[0])
    _, d, _, h, w = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1, 0, 0, dd, dd))  # pads W, H, (not C), D
    gf = g.float()
    taps = [
        torch.einsum(
            "bdihw,bdohw->io", xp[:, kd * dd : kd * dd + d, :, kh : kh + h, kw : kw + w], gf
        )
        for kd in range(3)
        for kh in range(3)
        for kw in range(3)
    ]
    return torch.stack(taps).reshape(3, 3, 3, x.shape[2], g.shape[2])


def conv3d_dm_dw(
    x: torch.Tensor, g: torch.Tensor, dilation=(1, 1, 1)
) -> torch.Tensor:
    """The weight gradient as :func:`conv3d_dm_dw_reference` computes it.

    On a CUDA device the Hopper kernel runs: contiguous bf16 x
    ``(B, D, Ci, H, W)`` and g ``(B, D, Co, H, W)`` with Co in
    :data:`KERNEL_COUT`, dilation ``(d, 1, 1)``. Anything else raises; it
    never falls back. Sums run in a fixed order, so the result does not
    change from run to run.
    """
    if x.device.type == "cpu":
        return conv3d_dm_dw_reference(x, g, dilation)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3d_dm_dw kernel for device {x.device}")
    dd = _depth_dilation(dilation, "conv3d_dm_dw")
    _check_activation(x, "conv3d_dm_dw")
    _check_activation(g, "conv3d_dm_dw")
    b, d, ci, h, w = x.shape
    co = g.shape[2]
    if (g.shape[0], g.shape[1], g.shape[3], g.shape[4]) != (b, d, h, w):
        raise ValueError(f"g {tuple(g.shape)} does not match x {tuple(x.shape)}")
    if co not in KERNEL_COUT:
        raise ValueError(f"conv3d_dm_dw kernel supports Co in {KERNEL_COUT}, got {co}")
    if g.device != x.device:
        raise ValueError(f"g is on {g.device}, x on {x.device}")
    lib = kernels.load_library()
    n_items = b * d * -(-h // 8) * -(-w // 32)  # the kernel's 8 x 32 tiles
    nblocks = kernels.grid_blocks(x.device, n_items)
    partial = torch.empty(nblocks * 27 * ci * co, dtype=torch.float32, device=x.device)
    dw = torch.empty((3, 3, 3, ci, co), dtype=torch.float32, device=x.device)
    rc = lib.cryovit_conv3d_dm_dw(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), b, d, ci, co, h, w,
        dd, nblocks, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "conv3d_dm_dw")
    kernels.count_launch("conv3d_dm_dw")
    return dw
