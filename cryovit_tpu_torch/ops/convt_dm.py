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

Its backward, counterpart of ``convt2x_dm_bwd`` (dx and dW from one pass):

- :func:`convt2x_dm_bwd` is the wrapper (``csrc/convt_dm_bwd.cu`` on a GPU);
- :func:`convt2x_dm_bwd_reference` is the plain version: a stride-2
  contraction for dx and four parity contractions for dW, f32 sums.
"""

from __future__ import annotations

import torch

from cryovit_tpu_torch import kernels

__all__ = [
    "BWD_KERNEL_CHANNELS",
    "KERNEL_COUT",
    "KERNEL_MAX_CIN",
    "convt2x_dm",
    "convt2x_dm_bwd",
    "convt2x_dm_bwd_reference",
    "convt2x_dm_reference",
]

KERNEL_COUT = (1, 8, 16, 32)
KERNEL_MAX_CIN = 64
BWD_KERNEL_CHANNELS = (8, 16, 32)  # Ci and Co the backward kernel is built for


def _parity_weights(kernel: torch.Tensor) -> torch.Tensor:
    """flax ``(1, 2, 2, Ci, Co)`` → ``(2, 2, Ci, Co)`` indexed by the output
    parity each tap lands on."""
    return kernel[0].flip(0, 1)


def _check_operands(x: torch.Tensor, kernel: torch.Tensor, name: str):
    """What both kernels take of x and the flax kernel; returns
    ``(B, D, Ci, H, W, Co)``."""
    if x.dim() != 5 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            f"{name} kernel takes contiguous bf16 (B, D, Ci, H, W); got "
            f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )
    b, d, ci, h, w = x.shape
    if kernel.dim() != 5 or tuple(kernel.shape[:4]) != (1, 2, 2, ci):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not (1, 2, 2, {ci}, Co)")
    if kernel.device != x.device:
        raise ValueError(f"kernel is on {kernel.device}, x on {x.device}")
    return b, d, ci, h, w, kernel.shape[4]


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
    b, d, ci, h, w, co = _check_operands(x, kernel, "convt2x_dm")
    if co not in KERNEL_COUT or ci > KERNEL_MAX_CIN:
        raise ValueError(
            f"convt2x_dm kernel supports Ci <= {KERNEL_MAX_CIN} and Co in "
            f"{KERNEL_COUT}, got Ci={ci}, Co={co}"
        )
    if b * d > 65535:
        raise ValueError("B·D must be at most 65535")
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


def convt2x_dm_bwd_reference(
    g: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain backward of :func:`convt2x_dm_reference` for the cotangent g
    ``(B, D, Co, 2H, 2W)``: dx ``(B, D, Ci, H, W)`` in x's dtype and the
    kernel's gradient ``(1, 2, 2, Ci, Co)`` in f32, all sums in f32."""
    b, d, co, h2, w2 = g.shape
    gp = g.float().reshape(b, d, co, h2 // 2, 2, w2 // 2, 2)  # parity (a, c) apart
    dx = torch.einsum("bdohawc,acio->bdihw", gp, _parity_weights(kernel).float())
    dwp = torch.einsum("bdihw,bdohawc->acio", x.float(), gp)
    # parity (a, c) is the flax tap (1 - a, 1 - c)
    return dx.to(x.dtype), dwp.flip(0, 1)[None]


def convt2x_dm_bwd(
    g: torch.Tensor, x: torch.Tensor, kernel: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dW)`` as :func:`convt2x_dm_bwd_reference` computes them.

    On a CUDA device the Hopper kernel runs, one pass for both: contiguous
    bf16 g and x with Ci and Co in :data:`BWD_KERNEL_CHANNELS`. Anything
    else raises; it never falls back. dW sums run in a fixed order, so the
    result does not change from run to run.
    """
    if x.device.type == "cpu":
        return convt2x_dm_bwd_reference(g, x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"no convt2x_dm_bwd kernel for device {x.device}")
    b, d, ci, h, w, co = _check_operands(x, kernel, "convt2x_dm_bwd")
    if g.dtype != torch.bfloat16 or not g.is_contiguous() or g.device != x.device:
        raise ValueError(
            f"convt2x_dm_bwd kernel takes a contiguous bf16 g on {x.device}; got "
            f"{g.dtype} on {g.device} contiguous={g.is_contiguous()}"
        )
    if tuple(g.shape) != (b, d, co, 2 * h, 2 * w):
        raise ValueError(f"g {tuple(g.shape)} is not {(b, d, co, 2 * h, 2 * w)}")
    if ci not in BWD_KERNEL_CHANNELS or co not in BWD_KERNEL_CHANNELS:
        raise ValueError(
            f"convt2x_dm_bwd kernel supports Ci and Co in {BWD_KERNEL_CHANNELS}, "
            f"got Ci={ci}, Co={co}"
        )
    lib = kernels.load_library()
    wmat = _parity_weights(kernel).to(torch.float32).contiguous()
    n_items = b * d * -(-h // 4) * -(-w // 32)  # the kernel's 4 x 32 tiles
    nblocks = kernels.grid_blocks(x.device, n_items)
    partial = torch.empty(nblocks * 4 * ci * co, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dwp = torch.empty((2, 2, ci, co), dtype=torch.float32, device=x.device)
    rc = lib.cryovit_convt2x_dm_bwd(
        g.data_ptr(), x.data_ptr(), wmat.data_ptr(), dx.data_ptr(), partial.data_ptr(),
        dwp.data_ptr(), b, d, ci, co, h, w, nblocks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check(rc, "convt2x_dm_bwd")
    kernels.count_launch("convt2x_dm_bwd")
    return dx, dwp.flip(0, 1)[None]
