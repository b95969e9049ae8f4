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
    """``device`` as a ``torch.device``; None picks the first GPU when there
    is one and the CPU otherwise."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def compute_dtype(device: torch.device) -> torch.dtype:
    """The default compute dtype on ``device``: bf16 on a GPU (the kernels'
    dtype), f32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
