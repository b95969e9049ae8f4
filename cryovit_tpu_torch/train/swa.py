"""Stochastic Weight Averaging (port of ``cryovit_tpu/train/swa.py``).

Reference ``configs/callbacks/stochastic_weight_average.yaml``: Lightning's
SWA with ``swa_lrs = model.lr``, ``swa_epoch_start = 0.8`` and
``annealing_epochs = 0``. Those two settings are fixed here: the learning
rate stays constant and is never annealed, and the weights of the epochs
after ``swa_epoch_start`` are averaged and swapped in at the end of
training. The decoder normalises with GroupNorm, so no batch-norm
statistics need re-estimating. The average lives on the parameters' device.
"""

from __future__ import annotations

import torch

__all__ = ["StochasticWeightAveraging"]


class StochasticWeightAveraging:
    """Callback: running average of the named parameters over the SWA window."""

    def __init__(self, swa_epoch_start: float = 0.8) -> None:
        self.swa_epoch_start = float(swa_epoch_start)
        self.swa_params: dict[str, torch.Tensor] | None = None
        self.count = 0

    def start_epoch(self, max_epochs: int) -> int:
        return int(self.swa_epoch_start * max_epochs)

    @torch.no_grad()
    def on_train_epoch_end(self, epoch: int, max_epochs: int, params: dict[str, torch.Tensor]) -> None:
        if epoch + 1 <= self.start_epoch(max_epochs):
            return
        if self.swa_params is None:
            self.swa_params = {k: p.detach().clone() for k, p in params.items()}
            self.count = 1
            return
        n = self.count
        for k, avg in self.swa_params.items():
            avg.copy_((avg * n + params[k]) / (n + 1))
        self.count = n + 1

    def on_fit_end(self, params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """The averaged parameters, or ``params`` if SWA never started."""
        return self.swa_params if self.swa_params is not None else params
