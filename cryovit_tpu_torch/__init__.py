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

__all__ = ["compute_dtype", "resolve_device"]


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
