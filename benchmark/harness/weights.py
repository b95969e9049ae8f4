"""Weights drawn from the seed on the device, in one large draw per model.

A configuration's ``init`` lists rules ``[pattern, law, a, (b)]`` for the
state dict's names, first match wins:

- ``normal``: ``a``·N(0, 1);
- ``around``: ``a`` + ``b``·N(0, 1);
- ``fan_in``: ``a``·N(0, 1) / √(fan-in), the fan-in the product of the
  weight's dims after the first (Conv and Linear weights ``(Co, Ci, …)``);
- ``fan_in_t``: ``a``·N(0, 1) / √(dim 0) (a stride-2 k2 ConvTranspose's
  ``(Ci, Co, …)``, whose every output voxel takes one tap of each input
  channel).

The names and shapes come from the plain reference's module (built on the
meta device), which carries the reference's parameter names, the names
the port's constructors load strictly.
"""

from __future__ import annotations

import math
import re

import torch

ALIGN = 128  # elements: every leaf starts 256-byte aligned, as kernels' vector loads want


def _scale_shift(name: str, shape: tuple[int, ...], rules) -> tuple[float, float]:
    for rule in rules:
        pattern, law, a = rule[0], rule[1], float(rule[2])
        if not re.search(pattern, name):
            continue
        if law == "normal":
            return a, 0.0
        if law == "around":
            return float(rule[3]), a
        if law == "fan_in":
            return a / math.sqrt(math.prod(shape[1:])), 0.0
        if law == "fan_in_t":
            return a / math.sqrt(shape[0]), 0.0
        raise ValueError(f"unknown init law {law!r} for {name}")
    raise ValueError(f"no init rule matches {name}")


def draw(shapes: dict[str, tuple[int, ...]], rules, gen: torch.Generator,
         dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """A state dict of ``shapes`` in ``dtype`` on the generator's device:
    one normal draw of every element, then each leaf's law applied to its
    view in place (each leaf a view of the draw at an aligned offset)."""
    sizes = [math.prod(s) for s in shapes.values()]
    total = sum(-(-n // ALIGN) * ALIGN for n in sizes)
    flat = torch.empty(total, dtype=dtype, device=gen.device).normal_(generator=gen)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        leaf = flat[at:at + n].view(shape)
        at += -(-n // ALIGN) * ALIGN
        scale, shift = _scale_shift(name, shape, rules)
        leaf.mul_(scale)
        if shift:
            leaf.add_(shift)
        out[name] = leaf
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, tuple[int, ...]]:
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}
