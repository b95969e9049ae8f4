"""PyTorch + CUDA port of ``cryovit_tpu`` for NVIDIA Hopper GPUs.

The package mirrors ``cryovit_tpu``'s layout (``io/``, ``types.py``,
``data/``, ``ops/``, ``models/``, ``run/``, ``train/``, ``cli/``). Every Pallas
kernel on its path is a hand-written CUDA kernel in ``csrc/``, built on first
use by ``kernels/``; each kernel's wrapper in ``ops/`` runs the plain PyTorch
version for CPU tensors. It imports no JAX, flax or ``cryovit_tpu``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

__all__ = ["compute_dtype", "require_bf16_on_cuda", "resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the GPU.

    The port runs on the card unless the caller names the CPU: without CUDA,
    None (or a CUDA device) raises instead of quietly running on the CPU.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: cryovit_tpu_torch runs on an NVIDIA GPU unless the "
            "CPU is asked for by name (device='cpu', or --device cpu on the "
            "command line)"
        )
    return device


def compute_dtype(device: torch.device) -> torch.dtype:
    """The default compute dtype on ``device``: bf16 on a GPU (the kernels'
    dtype), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def require_bf16_on_cuda(device: torch.device, dtype: torch.dtype, what: str,
                         kernels: str) -> None:
    """Refuse a compute dtype other than bf16 on a CUDA device, before any
    weight or step is built: the port's CUDA ``kernels`` take bf16 only (the
    JAX package computes f32 there too; the port builds no f32 kernels).
    The CPU takes f32 through the plain versions."""
    if torch.device(device).type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(
            f"{what}: {dtype} on a CUDA device is not supported; the port's CUDA kernels "
            f"({kernels}) take bf16 only. Compute in bf16 on the GPU, or in f32 on the CPU "
            "(device='cpu')"
        )
