"""Segmentation metrics on masked voxels (port of ``cryovit_tpu/models/metrics.py``).

Each metric returns a per-batch score; an epoch aggregates a
``(Σ score, #batches)`` pair (:class:`MetricState`, torchmetrics'
``dist_reduce_fx="sum"`` state in the reference).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DiceMetric", "F1Metric", "MetricState", "dice_metric", "f1_metric"]


def dice_metric(
    y_pred: torch.Tensor, y_true: torch.Tensor, mask: torch.Tensor, threshold: float = 0.5
) -> torch.Tensor:
    """Hard-threshold Dice score over masked voxels (reference ``metrics.py:31-46``)."""
    mask = mask.float()
    y_true = y_true.float() * mask
    hard = (y_pred >= threshold).float() * mask
    intersection = (y_true * hard).sum()
    denom = y_true.sum() + hard.sum()
    return 2.0 * intersection / (denom + 1e-3)


def f1_metric(
    y_pred: torch.Tensor, y_true: torch.Tensor, mask: torch.Tensor, threshold: float = 0.5
) -> torch.Tensor:
    """Per-batch F1 at ``threshold`` (reference ``metrics.py:74-87``)."""
    mask = mask.float()
    y_true = y_true.float()
    hard = (y_pred > threshold).float()
    tp = (y_true * hard * mask).sum()
    fp = ((1.0 - y_true) * hard * mask).sum()
    fn = (y_true * (1.0 - hard) * mask).sum()
    precision = tp / (tp + fp + 1e-6)
    recall = tp / (tp + fn + 1e-6)
    return 2.0 * precision * recall / (precision + recall + 1e-6)


@dataclasses.dataclass
class MetricState:
    """(Σ score, #batches) accumulator; :meth:`merge` is associative."""

    total: float = 0.0
    count: float = 0.0

    def update(self, score: torch.Tensor | float) -> "MetricState":
        return MetricState(self.total + float(score), self.count + 1.0)

    def merge(self, other: "MetricState") -> "MetricState":
        return MetricState(self.total + other.total, self.count + other.count)

    def compute(self) -> float:
        return self.total / self.count if self.count > 0 else 0.0


class DiceMetric:
    """The ``dice_metric`` entry of a model's metrics (``config.METRICS``)."""

    name = "DiceMetric"
    higher_is_better = True

    def __init__(self, threshold: float = 0.5) -> None:
        self.threshold = threshold

    def __call__(self, y_pred, y_true, mask):
        return dice_metric(y_pred, y_true, mask, threshold=self.threshold)


class F1Metric:
    """The ``f1_metric`` entry of a model's metrics (``config.METRICS``)."""

    name = "F1Metric"
    higher_is_better = True

    def __init__(self, threshold: float = 0.5) -> None:
        self.threshold = threshold

    def __call__(self, y_pred, y_true, mask):
        return f1_metric(y_pred, y_true, mask, threshold=self.threshold)
