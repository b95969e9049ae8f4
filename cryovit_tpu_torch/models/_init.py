"""Random initialisation with flax's laws, from an explicit ``torch.Generator``.

Used where no trained weights exist (benchmark and smoke runs): the same
distributions as the JAX package's ``model.init`` — lecun-normal kernels,
zero biases — though not the same numbers, since ``jax.random`` and torch's
generators differ.
"""

from __future__ import annotations

import math

import torch

__all__ = ["lecun_normal"]

# flax's variance_scaling "truncated_normal": the stddev of a unit normal
# truncated to [-2, 2] is 0.8796..., so the draw is rescaled by its inverse
_TRUNC_STD = 0.87962566103423978


def lecun_normal(
    shape: tuple[int, ...],
    fan_in: int,
    generator: torch.Generator,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Truncated normal (±2 std) with variance 1/fan_in, drawn on the
    generator's device by inverse-CDF sampling."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    t = torch.empty(shape, device=generator.device, dtype=torch.float32)
    t.uniform_(lo, hi, generator=generator).erfinv_().mul_(std * math.sqrt(2.0))
    return t.to(dtype)
