"""Layers of the SAM2 heads that compute in their input's dtype.

The JAX package builds the heads from flax modules with ``dtype=``: f32
parameters cast to the compute dtype at use, LayerNorm statistics in f32.
These subclasses keep the torch parameter layout (so the state dict has the
reference's names and shapes) and do the same: weights are cast to x's
dtype, LayerNorm runs in f32 and returns x's dtype. Convolutions take and
return channels-last tensors, as the JAX package's do.

The heads run once per slice, so inside :func:`casts_kept_in` a frozen
parameter (``requires_grad`` off) is cast once and its copy kept across
passes for as long as the parameter is unchanged, as the encoder's compute
copy is. A trained parameter is cast at each use: its gradient then sums
over the slices in f32, as the JAX package's scan sums the cotangent of its
f32 parameter.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

from cryovit_tpu_torch.ops.window_attention import layer_norm_f32

__all__ = ["Conv2d", "Conv3d", "ConvTranspose2d", "LayerNorm", "Linear", "cast", "casts_kept_in"]

_KEPT: contextvars.ContextVar[dict | None] = contextvars.ContextVar("sam2_kept_casts", default=None)


@contextlib.contextmanager
def casts_kept_in(kept: dict):
    """Keep the compute-dtype copies of frozen parameters in ``kept`` while
    the block runs (the caller empties it when its weights are replaced)."""
    token = _KEPT.set(kept)
    try:
        yield
    finally:
        _KEPT.reset(token)


def cast(t: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """``t`` in x's dtype (a kept copy for a frozen parameter, see above)."""
    if t is None or t.dtype == x.dtype:
        return t
    kept = _KEPT.get()
    if kept is None or t.requires_grad or not isinstance(t, nn.Parameter):
        return t.to(x.dtype)
    key = (id(t), x.dtype)
    hit = kept.get(key)
    if hit is None or hit[0] is not t or hit[1] != (t._version, t.data_ptr()):
        # a normal tensor even under inference_mode, so a later train step
        # may save it for its backward
        with torch.inference_mode(False), torch.no_grad():
            hit = kept[key] = (t, (t._version, t.data_ptr()), t.to(x.dtype))
    return hit[2]


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, cast(self.weight, x), cast(self.bias, x))


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last axis with f32 statistics (``layer_norm_f32``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_f32(x, self.weight, self.bias, self.eps)


class Conv2d(nn.Conv2d):
    """``(B, H, W, Cin)`` → ``(B, H', W', Cout)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), cast(self.weight, x), cast(self.bias, x),
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1)


class Conv3d(nn.Conv3d):
    """Channels-first ``(B, C, D, H, W)``, as the prompt predictor keeps its
    volume (one layout change in and one out)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, cast(self.weight, x), cast(self.bias, x), self.stride, self.padding)


class ConvTranspose2d(nn.ConvTranspose2d):
    """2×2 stride-2 transposed convolution, ``(B, H, W, Cin)`` →
    ``(B, 2H, 2W, Cout)``, as flax's ``ConvTranspose(k=2, s=2, "SAME")``
    computes it from the weight the JAX package stores: flax places tap
    ``1 − a`` at output offset ``a`` where torch places tap ``a``, so the
    taps are flipped here (the stored weight is the JAX package's export,
    ``kernel.transpose(2, 3, 0, 1)``, unflipped)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = cast(self.weight, x).flip(-2, -1)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, cast(self.bias, x), stride=2)
        return y.permute(0, 2, 3, 1)
