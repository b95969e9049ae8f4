"""The Trainer: the fit loop of ``cryovit_tpu/train/loop.py`` in PyTorch.

Replaces PyTorch Lightning (reference ``BaseTrainer`` config and the
``BaseModel`` step methods) with an explicit loop on one device:

- :meth:`Trainer.train_step`: forward, masked losses, backward (through the
  decoder tail's kernels on a GPU), gradient norms and optional clipping,
  one AdamW update, the train metrics;
- a validation epoch after each training epoch, in ``torch.no_grad``;
- callbacks (:class:`~cryovit_tpu_torch.train.swa.StochasticWeightAveraging`
  and any ``on_train_epoch_end``), loggers' ``log_scalars``, and an optional
  ``last.ckpt`` (``torch.save`` of model, optimizer, epoch and step) to
  resume from.

The logged names are the JAX package's: ``train_<loss>``,
``train_<metric>``, ``grad_norm_preclip``, ``grad_norm``, ``epoch_*``,
``val_*`` and ``epoch_time_s``. Not ported yet: the device mesh
(``shard_map`` data parallelism), ``prepare_inputs`` (SAM2), and
``test``/``predict``.
"""

from __future__ import annotations

import logging
import random
import time
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch
from torch import nn

from cryovit_tpu_torch import resolve_device
from cryovit_tpu_torch.models.base import BaseModel, clip_gradients, prediction_mask
from cryovit_tpu_torch.train.swa import StochasticWeightAveraging
from cryovit_tpu_torch.types import TomogramBatch

logger = logging.getLogger(__name__)

__all__ = ["Trainer", "seed_everything"]


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch, and return a CPU generator for the
    model's initial weights (the JAX package returns a PRNG key; reference
    ``seed_everything(42, workers=True)``)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


class Trainer:
    """Explicit training loop with the reference trainer's config surface.

    ``device`` is where the model trains: a GPU unless the caller names the
    CPU (:func:`cryovit_tpu_torch.resolve_device`).
    """

    def __init__(
        self,
        precision: str = "bf16",
        max_epochs: int | None = None,
        log_every_n_steps: int = 1,
        enable_checkpointing: bool = False,
        enable_model_summary: bool = True,
        default_root_dir: str | Path | None = None,
        gradient_clip_val: float | None = None,
        gradient_clip_algorithm: str = "norm",
        callbacks: Sequence[Any] = (),
        loggers: Sequence[Any] = (),
        seed: int = 42,
        device: torch.device | str | None = None,
    ) -> None:
        self.precision = precision
        self.max_epochs = max_epochs or 1
        self.log_every_n_steps = max(1, log_every_n_steps)
        self.enable_checkpointing = enable_checkpointing
        self.enable_model_summary = enable_model_summary
        self.default_root_dir = Path(default_root_dir) if default_root_dir else None
        self.gradient_clip_val = gradient_clip_val
        self.gradient_clip_algorithm = gradient_clip_algorithm
        self.callbacks = list(callbacks)
        self.loggers = list(loggers)
        self.seed = seed
        self.device = resolve_device(device)
        self.model: BaseModel | None = None
        self.module: nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.step = 0
        self.logged: dict[str, float] = {}

    # ---- steps ------------------------------------------------------------

    def to_device(self, batch: TomogramBatch) -> tuple[torch.Tensor, torch.Tensor]:
        """A host batch's data and labels on the training device."""
        data = torch.from_numpy(np.ascontiguousarray(batch.data)).to(self.device)
        label = torch.from_numpy(np.ascontiguousarray(batch.label)).to(self.device)
        return data, label

    def train_step(self, data: torch.Tensor, label: torch.Tensor) -> dict[str, torch.Tensor]:
        """One optimizer step on a batch already on the device; returns the
        step's logs as device scalars (nothing is synchronised here)."""
        module, model, optimizer = self.module, self.model, self.optimizer
        module.train()
        optimizer.zero_grad(set_to_none=True)
        preds = module(data)
        mask = prediction_mask(label)
        losses = model.compute_losses(preds, label, mask)
        losses["total"].backward()
        # the reference logs the post-clip norm; the pre-clip one is what
        # explosion monitoring needs, so both are logged
        pre, post = clip_gradients(
            list(module.parameters()), self.gradient_clip_val, self.gradient_clip_algorithm
        )
        optimizer.step()
        with torch.no_grad():
            metrics = model.compute_metrics(preds.detach(), label, mask)
        logs = {f"train_{k}": v.detach() for k, v in losses.items()}
        logs.update({f"train_{k}": v for k, v in metrics.items()})
        logs["grad_norm_preclip"] = pre
        logs["grad_norm"] = post
        return logs

    @torch.no_grad()
    def _run_eval_epoch(self, loader) -> dict[str, float]:
        """Mean losses and metrics over the loader's batches (fit-time
        validation masks only ``y > -1``, as the reference's
        ``validation_step`` does)."""
        module, model = self.module, self.model
        module.eval()
        sums: dict[str, float] = {}
        count = 0
        for batch, _ in loader:
            data, label = self.to_device(batch)
            preds = module(data)
            mask = prediction_mask(label)
            losses = model.compute_losses(preds, label, mask)
            for k, v in {**losses, **model.compute_metrics(preds, label, mask)}.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}

    def _log(self, step: int, logs: dict[str, Any]) -> None:
        scalars = {k: float(v) for k, v in logs.items()}
        self.logged = scalars
        for lg in self.loggers:
            if hasattr(lg, "log_scalars"):
                lg.log_scalars(scalars, step)

    # ---- fit ----------------------------------------------------------------

    def fit(
        self,
        model: BaseModel,
        datamodule,
        variables: dict[str, torch.Tensor] | None = None,
        ckpt_path: str | Path | None = None,
    ) -> nn.Module:
        """Train ``model`` on the datamodule's loaders for ``max_epochs``.

        ``variables`` is a state dict with the reference's names to start
        from (random weights from the seed otherwise); ``ckpt_path`` a
        ``last.ckpt`` to resume from. Returns the trained module, with the
        SWA average swapped in when that callback ran.
        """
        generator = seed_everything(self.seed)
        train_loader = datamodule.train_loader()
        try:
            val_loader = datamodule.val_loader()
        except ValueError:
            val_loader = None

        first_batch, _ = next(iter(train_loader))
        module = model.build_module(
            variables, self.device, generator=generator, in_channels=first_batch.data.shape[-1]
        )
        if self.enable_model_summary:
            n = sum(p.numel() for p in module.parameters())
            logger.info("model %s: %.2fM params on %s", model.name, n / 1e6, self.device)
        optimizer = model.make_optimizer(module.parameters())
        self.model, self.module, self.optimizer = model, module, optimizer
        self.step = 0
        start_epoch = 0
        if ckpt_path is not None and Path(ckpt_path).exists():
            ckpt = torch.load(ckpt_path, map_location=self.device, weights_only=True)
            module.load_state_dict(ckpt["model"])
            optimizer.load_state_dict(ckpt["optimizer"])
            start_epoch, self.step = int(ckpt["epoch"]), int(ckpt["step"])
            logger.info("resumed from %s at epoch %d", ckpt_path, start_epoch)

        swa = next((c for c in self.callbacks if isinstance(c, StochasticWeightAveraging)), None)
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            train_loader.set_epoch(epoch)
            logs: dict[str, Any] = {}
            for batch, _ in train_loader:
                logs = self.train_step(*self.to_device(batch))
                self.step += 1
                if self.step % self.log_every_n_steps == 0:
                    self._log(self.step, logs)

            epoch_logs = {f"epoch_{k}": float(v) for k, v in logs.items()}
            if val_loader is not None:
                vals = self._run_eval_epoch(val_loader)
                epoch_logs.update({f"val_{k}": v for k, v in vals.items()})
            epoch_logs["epoch_time_s"] = time.perf_counter() - t0
            self._log(self.step, epoch_logs)

            if swa is not None:
                swa.on_train_epoch_end(epoch, self.max_epochs, dict(module.named_parameters()))
            for cb in self.callbacks:
                if hasattr(cb, "on_train_epoch_end") and cb is not swa:
                    cb.on_train_epoch_end(epoch, epoch_logs)

            if self.enable_checkpointing and self.default_root_dir is not None:
                self.default_root_dir.mkdir(parents=True, exist_ok=True)
                torch.save(
                    {"model": module.state_dict(), "optimizer": optimizer.state_dict(),
                     "epoch": epoch + 1, "step": self.step},
                    self.default_root_dir / "last.ckpt",
                )

        if swa is not None:
            averaged = swa.on_fit_end(dict(module.named_parameters()))
            with torch.no_grad():
                for name, p in module.named_parameters():
                    p.copy_(averaged[name])
        return module
