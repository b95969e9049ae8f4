"""Segmentation losses on masked voxels (port of ``cryovit_tpu/models/losses.py``).

Each loss takes probabilities in [0, 1], the labels and an explicit ``mask``
of the voxels that count (``y_true > -1``), and computes mask-weighted sums:
padding and unlabeled voxels contribute exactly zero. ``mesh`` (the JAX
package's ``axis_name``) sums each masked sum over the ranks of a
data-parallel or depth-sharded mesh (:func:`~cryovit_tpu_torch.parallel.global_sum`):
the value is the global-batch loss, and each rank's gradient is its own
data's share of it.
"""

from __future__ import annotations

import torch

from cryovit_tpu_torch.parallel.mesh import Mesh, global_sum

__all__ = ["DiceLoss", "FocalLoss", "dice_loss", "focal_loss"]


def dice_loss(
    y_pred: torch.Tensor, y_true: torch.Tensor, mask: torch.Tensor, mesh: Mesh | None = None
) -> torch.Tensor:
    """Soft Dice loss: ``1 − 2·Σ(y·ŷ) / (Σy + Σŷ + 1e-3)`` over masked voxels."""
    mask = mask.to(y_pred.dtype)
    y_true = y_true.to(y_pred.dtype) * mask
    y_pred = y_pred * mask
    intersection = global_sum(y_true * y_pred, mesh)
    denom = global_sum(y_true, mesh) + global_sum(y_pred, mesh)
    return 1.0 - (2.0 * intersection) / (denom + 1e-3)


def focal_loss(
    y_pred: torch.Tensor,
    y_true: torch.Tensor,
    mask: torch.Tensor,
    gamma: float = 2.0,
    eps: float = 1e-7,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Focal loss on probabilities with a class-balance alpha equal to the
    background fraction of the masked voxels (the JAX package's form, which
    applies no second sigmoid)."""
    mask = mask.to(y_pred.dtype)
    y_true = y_true.to(y_pred.dtype)
    total = global_sum(mask, mesh).clamp_min(1.0)
    alpha = global_sum((1.0 - y_true) * mask, mesh) / total

    p = y_pred.clamp(eps, 1.0 - eps)
    ce = -(y_true * torch.log(p) + (1.0 - y_true) * torch.log1p(-p))
    p_t = y_true * p + (1.0 - y_true) * (1.0 - p)
    alpha_t = y_true * alpha + (1.0 - y_true) * (1.0 - alpha)
    loss = alpha_t * (1.0 - p_t) ** gamma * ce
    return global_sum(loss * mask, mesh) / total


class DiceLoss:
    """The ``dice_loss`` entry of a model's losses (``config.LOSSES``)."""

    name = "DiceLoss"

    def __call__(self, y_pred, y_true, mask, mesh=None):
        return dice_loss(y_pred, y_true, mask, mesh=mesh)


class FocalLoss:
    """The ``focal_loss`` entry of a model's losses (``config.LOSSES``)."""

    name = "FocalLoss"

    def __init__(self, gamma: float = 2.0) -> None:
        self.gamma = gamma

    def __call__(self, y_pred, y_true, mask, mesh=None):
        return focal_loss(y_pred, y_true, mask, gamma=self.gamma, mesh=mesh)
