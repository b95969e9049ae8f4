"""The Trainer: the fit loop of ``cryovit_tpu/train/loop.py`` in PyTorch.

Replaces PyTorch Lightning (reference ``BaseTrainer`` config and the
``BaseModel`` step methods) with an explicit loop on one device, or on each
rank of a mesh (``mesh_shape``, ``parallel/``):

- :meth:`Trainer.train_step`: forward, masked losses, backward (through the
  decoder tail's kernels on a GPU), gradient norms and optional clipping,
  one AdamW update, the train metrics;
- a validation epoch after each training epoch, in ``torch.no_grad``;
- callbacks (:class:`~cryovit_tpu_torch.train.swa.StochasticWeightAveraging`
  and any ``on_train_epoch_end``), loggers' ``log_scalars``, and an optional
  ``last.ckpt`` (``torch.save`` of model, optimizer, epoch and step) to
  resume from;
- :meth:`Trainer.test` and :meth:`Trainer.predict`: a model's losses,
  metrics and predictions over a datamodule's test or prediction loader, in
  ``torch.inference_mode``, unpadded to each tomogram's shape and handed to
  the callbacks' ``on_test_batch_end`` / ``on_predict_batch_end``.

The logged names are the JAX package's: ``train_<loss>``,
``train_<metric>``, ``grad_norm_preclip``, ``grad_norm``, ``epoch_*``,
``val_*`` and ``epoch_time_s``.

The model family's hooks are the JAX package's: ``prepare_inputs(data,
items)`` turns a batch on the device into the module's input (SAM2's
conditioning-slice draw and cached pyramids), ``train_mode`` is set around
the fit epochs, ``apply_with_aux`` returns the extra outputs that
``compute_losses(..., aux=...)`` reads (SAM2's prompt loss), and
``make_optimizer(module)`` builds the optimizer with the family's parameter
groups.

Under a mesh of more than one process (the JAX package's ``shard_map``
steps, written out on ``torch.distributed``):

- every rank iterates the same loader (same seed, same order) and keeps its
  part of each batch (:meth:`Trainer.place`): a slice of the batch axis
  when it divides the mesh (data parallelism; SAM2's dict input splits its
  ``slices`` and keeps the cond-slice draw whole), else, for a family with
  a depth-sharded forward (CryoVIT, and UNet3D when each slab is a
  multiple of ``2 ** pools`` slices), a slab of the depth axis, else the
  whole batch: the replicated step (a UNet3D depth its pools would split,
  SAM2's cached pyramids, the mito-masked test path), which for SAM2 hands
  the mesh to the forward to split its frozen encoder when the depth it
  sees divides the mesh (the encoder-split step);
- the losses and metrics of a split batch carry the mesh (global values,
  equal to the single-process ones), and the parameter gradients are
  summed over the ranks (JAX's ``psum(grads)``; averaging, DDP's default,
  would be wrong by the world size since the losses are already global)
  before the norms, clipping and AdamW; the replicated and encoder-split
  steps compute the whole batch's losses on every rank and take rank 0's
  gradients, so the parameters stay identical on every rank;
- the parameters and optimizer state start from rank 0's, SWA runs on every
  rank, every rank holds the same logs and the gathered predictions, and
  rank 0 alone runs the loggers, the checkpoint and the callbacks that
  write (everything but SWA).
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

from cryovit_tpu_torch import require_bf16_on_cuda, resolve_device
from cryovit_tpu_torch.config import PRECISION_DTYPES
from cryovit_tpu_torch.models.base import BaseModel, clip_gradients, prediction_mask
from cryovit_tpu_torch.models.cryovit import BF16_KERNELS
from cryovit_tpu_torch.parallel.mesh import Mesh, Sharding, make_mesh, replicate
from cryovit_tpu_torch.parallel.spatial import (
    batch_divides,
    encoder_divides,
    place_batch,
    warn_replicated,
)
from cryovit_tpu_torch.train.swa import StochasticWeightAveraging
from cryovit_tpu_torch.types import BatchedModelResult, TomogramBatch, TomogramData

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
    CPU (:func:`cryovit_tpu_torch.resolve_device`). ``mesh_shape`` (e.g.
    ``{"data": -1}``) trains on a mesh over the process group
    (:func:`~cryovit_tpu_torch.parallel.make_mesh`, which initialises it from
    a ``torchrun`` environment); each rank's device is then the mesh's.
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
        mesh_shape: dict[str, int] | None = None,
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
        require_bf16_on_cuda(self.device, PRECISION_DTYPES[precision],
                             f"Trainer(precision={precision!r})", BF16_KERNELS)
        self.mesh: Mesh | None = make_mesh(mesh_shape, device=self.device) if mesh_shape else None
        if self.mesh is not None:
            self.device = self.mesh.device
        self.model: BaseModel | None = None
        self.module: nn.Module | None = None
        self.optimizer: torch.optim.Optimizer | None = None
        self.step = 0
        self.logged: dict[str, float] = {}

    # ---- the mesh -----------------------------------------------------------

    @property
    def is_main(self) -> bool:
        """Whether this process writes (rank 0, or no mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def _multi(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def place(
        self, model: BaseModel, batch: TomogramBatch, items, replicated: bool = False,
        labels: bool = True,
    ) -> tuple[Any, torch.Tensor | None, Sharding | None]:
        """This rank's module input and labels (None unless ``labels``) for a
        host batch, on the device, and how they lie on the mesh (None
        without one): the batch axis, else the depth axis (families with a
        depth-sharded forward, slabs of a multiple of their
        ``depth_multiple``), else the whole batch (``replicated`` asks for
        that). A family with ``prepare_inputs`` builds its input from the
        whole batch, as in JAX (its cond-slice draw rank 0's), and keeps
        its slice (``split_inputs``) when the batch axis splits; else a
        family with ``encoder_split_depth`` takes the encoder-split step
        when the depth its encoder sees divides the mesh (the whole batch,
        the mesh handed to the forward), and replicates without a warning
        an input its encoder does not run on (SAM2's cached pyramids)."""
        if not self._multi():
            data, label = self.to_device(batch, labels)
            return self.prepare(model, data, items), label, None
        whole = Sharding(self.mesh, None)
        prepare = getattr(model, "prepare_inputs", None)
        if prepare is None:
            if replicated:
                data, label = self.to_device(batch, labels)
                return data, label, whole
            placed, sharding = place_batch(batch, self.mesh, depth=model.depth_shardable,
                                           multiple=model.depth_multiple)
            data, label = self.to_device(placed, labels)
            return data, label, sharding
        data, label = self.to_device(batch, labels)
        inputs = prepare(data, items, mesh=self.mesh)
        if not replicated and batch_divides(self.mesh, data):
            sharding = Sharding(self.mesh, 0)
            local = model.split_inputs(inputs, sharding)
            if local is not None:
                return local, None if label is None else sharding.local(label), sharding
        depth = None
        if model.encoder_split_depth is not None:
            encoder = Sharding(self.mesh, None, encoder=True)
            if model.split_inputs(inputs, encoder) is None:
                return inputs, label, whole  # no encoder runs on this input
            depth = min(batch.data.shape[1], model.encoder_split_depth)
            if encoder_divides(self.mesh, depth):
                return inputs, label, encoder
        if not replicated and not batch_divides(self.mesh, batch.data):
            warn_replicated(batch, self.mesh, depth=False, encoder_depth=depth)
        return inputs, label, whole

    @staticmethod
    def _step_mesh(sharding: Sharding | None) -> Mesh | None:
        """The mesh the losses and metrics sum over: that of a sharded batch."""
        return sharding.mesh if sharding is not None and sharding.dim is not None else None

    @staticmethod
    def _forward(model: BaseModel, module: nn.Module, data, sharding: Sharding | None):
        """The family's forward, handed the mesh for a depth slab or an
        encoder split."""
        if sharding is not None and (sharding.dim == 1 or sharding.encoder):
            return model.apply_with_aux(module, data, mesh=sharding.mesh)
        return model.apply_with_aux(module, data)

    def _reduce_gradients(self, sharding: Sharding | None) -> None:
        """The gradients of the optimizer's parameters summed over the ranks
        of a sharded batch, or rank 0's for a replicated one (the
        encoder-split step's too: each rank's are the whole batch's)."""
        if sharding is None or sharding.mesh.size == 1:
            return
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        for grads in by_dtype.values():
            if sharding.dim is None:
                sharding.mesh.broadcast_flat_(grads)
            else:
                sharding.mesh.all_reduce_flat_(grads)

    @staticmethod
    def _gather(preds: torch.Tensor, sharding: Sharding | None) -> torch.Tensor:
        """A sharded batch's predictions whole, on every rank."""
        if sharding is None or sharding.dim is None:
            return preds
        return sharding.mesh.gather(preds, sharding.dim)

    def _callbacks(self, hook: str) -> list:
        """The callbacks with ``hook`` (rank 0 only: they write)."""
        if not self.is_main:
            return []
        return [cb for cb in self.callbacks if hasattr(cb, hook)]

    # ---- steps ------------------------------------------------------------

    def to_device(
        self, batch: TomogramBatch, labels: bool = True
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """A host batch's data and labels (None unless ``labels``) on the
        training device."""
        data = torch.from_numpy(np.ascontiguousarray(batch.data)).to(self.device)
        if not labels:
            return data, None
        label = torch.from_numpy(np.ascontiguousarray(batch.label)).to(self.device)
        return data, label

    @staticmethod
    def prepare(model: BaseModel, data: torch.Tensor, items) -> Any:
        """The module's input for a batch on the device: the family's
        ``prepare_inputs(data, items)`` where it has one, else ``data``."""
        prepare = getattr(model, "prepare_inputs", None)
        return prepare(data, items) if prepare is not None else data

    def train_step(
        self, data, label: torch.Tensor, sharding: Sharding | None = None
    ) -> dict[str, torch.Tensor]:
        """One optimizer step on a batch already on the device (``data`` as
        :meth:`prepare` gives it, or this rank's part as :meth:`place` gives
        it with its ``sharding``); returns the step's logs as device scalars
        (nothing is synchronised here, but the collectives of a mesh)."""
        module, model, optimizer = self.module, self.model, self.optimizer
        mesh = self._step_mesh(sharding)
        module.train()
        optimizer.zero_grad(set_to_none=True)
        preds, aux = self._forward(model, module, data, sharding)
        mask = prediction_mask(label)
        losses = model.compute_losses(preds, label, mask, aux=aux, mesh=mesh)
        losses["total"].backward()
        # a parameter the loss did not reach still takes AdamW's weight
        # decay, as optax applies it to a zero gradient
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self._reduce_gradients(sharding)
        # the reference logs the post-clip norm; the pre-clip one is what
        # explosion monitoring needs, so both are logged
        pre, post = clip_gradients(
            list(module.parameters()), self.gradient_clip_val, self.gradient_clip_algorithm
        )
        optimizer.step()
        with torch.no_grad():
            metrics = model.compute_metrics(preds.detach(), label, mask, mesh=mesh)
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
        for batch, items in loader:
            data, label, sharding = self.place(model, batch, items)
            mesh = self._step_mesh(sharding)
            preds, aux = self._forward(model, module, data, sharding)
            mask = prediction_mask(label)
            losses = model.compute_losses(preds, label, mask, aux=aux, mesh=mesh)
            metrics = model.compute_metrics(preds, label, mask, mesh=mesh)
            for k, v in {**losses, **metrics}.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            count += 1
        return {k: v / max(count, 1) for k, v in sums.items()}

    # ---- test / predict -----------------------------------------------------

    def _eval_module(self, module: nn.Module | None) -> nn.Module:
        """``module``, or the one :meth:`fit` trained, in eval mode on the
        trainer's device. It computes in its own dtype: the runners load a
        ``.model`` in the trainer's precision."""
        module = module if module is not None else self.module
        if module is None:
            raise ValueError("no module: pass one, or call fit first")
        device = next(module.parameters()).device
        if device.type != self.device.type:
            raise ValueError(f"the module is on {device}, the trainer on {self.device}")
        return module.eval()

    def _aux_mask(
        self, model: BaseModel, batch: TomogramBatch, items: Sequence[TomogramData]
    ) -> torch.Tensor | None:
        """Ground-truth mito mask for granule/cristae evaluation (reference
        ``base_model.py:91-112`` + ``test_step``): applied when every item's
        aux data carries ``labels/mito`` and the model does not turn
        ``use_mito_mask`` off."""
        if not model.custom_kwargs.get("use_mito_mask", True):
            return None
        masks = []
        for item in items:
            src = (item.aux_data or {}).get("labels/mito")
            if src is None:
                return None
            m = np.zeros(batch.label.shape[1:], dtype=np.int8)
            m[: src.shape[0], : src.shape[1], : src.shape[2]] = src
            masks.append(m)
        return torch.from_numpy(np.stack(masks)).to(self.device)

    @torch.inference_mode()
    def eval_step(
        self, module: nn.Module, model: BaseModel, data, label: torch.Tensor,
        aux_mask: torch.Tensor | None = None, sharding: Sharding | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor], dict[str, torch.Tensor]]:
        """Predictions, losses and metrics of a batch on the device (``data``
        as :meth:`prepare` gives it, or this rank's part as :meth:`place`
        gives it with its ``sharding``: the losses and metrics are then
        global, the predictions this rank's)."""
        mesh = self._step_mesh(sharding)
        preds, aux = self._forward(model, module, data, sharding)
        mask = prediction_mask(label, aux_mask)
        losses = model.compute_losses(preds, label, mask, aux=aux, mesh=mesh)
        return preds, losses, model.compute_metrics(preds, label, mask, mesh=mesh)

    @torch.inference_mode()
    def predict_step(
        self, module: nn.Module, data, model: BaseModel, sharding: Sharding | None = None
    ) -> torch.Tensor:
        return self._forward(model, module, data, sharding)[0]

    def test(
        self, model: BaseModel, datamodule, module: nn.Module | None = None
    ) -> list[BatchedModelResult]:
        """``model``'s losses and metrics on each batch of the datamodule's
        test loader, with ``module`` (default: the module :meth:`fit`
        trained). Each batch's result goes to the callbacks'
        ``on_test_batch_end``."""
        module = self._eval_module(module)
        results = []
        for batch, items in datamodule.test_loader():
            aux_mask = self._aux_mask(model, batch, items)
            # the mito-masked path takes the replicated step, as in JAX
            data, label, sharding = self.place(model, batch, items, replicated=aux_mask is not None)
            preds, losses, metrics = self.eval_step(module, model, data, label, aux_mask, sharding)
            preds = self._gather(preds, sharding)
            result = self._build_result(preds.float().cpu().numpy(), losses, metrics, items)
            for cb in self._callbacks("on_test_batch_end"):
                cb.on_test_batch_end(result)
            results.append(result)
        return results

    def predict(
        self, datamodule, module: nn.Module | None = None, model: BaseModel | None = None
    ) -> list[BatchedModelResult]:
        """Predictions for each batch of the datamodule's prediction loader;
        each batch's result goes to the callbacks' ``on_predict_batch_end``.
        ``model`` (default: the family :meth:`fit` trained) prepares the
        inputs and runs the forward."""
        module = self._eval_module(module)
        model = model if model is not None else self.model
        if model is None:
            raise ValueError("Trainer.predict needs the model family: pass model= or fit first")
        results = []
        for batch, items in datamodule.predict_loader():
            data, _, sharding = self.place(model, batch, items, labels=False)
            preds = self._gather(self.predict_step(module, data, model, sharding), sharding)
            result = self._build_result(preds.float().cpu().numpy(), {}, {}, items)
            for cb in self._callbacks("on_predict_batch_end"):
                cb.on_predict_batch_end(result)
            results.append(result)
        return results

    @staticmethod
    def _build_result(
        preds: np.ndarray,
        losses: dict[str, Any],
        metrics: dict[str, Any],
        items: Sequence[TomogramData],
    ) -> BatchedModelResult:
        """Unpad each tomogram's predictions back to its label's shape."""
        pred_list, data_list, label_list = [], [], []
        for i, item in enumerate(items):
            d, h, w = item.label.shape
            pred_list.append(preds[i, :d, :h, :w])
            label_list.append(item.label)
            aux = item.aux_data or {}
            data_list.append(np.asarray(aux.get("data", item.data[..., 0])))
        return BatchedModelResult(
            batch_size=len(items),
            samples=[it.sample for it in items],
            tomo_names=[it.tomo_name for it in items],
            split_id=[it.split_id for it in items],
            data=data_list,
            label=label_list,
            preds=pred_list,
            losses={k: float(v) for k, v in losses.items()},
            metrics={k: float(v) for k, v in metrics.items()},
        )

    def _log(self, step: int, logs: dict[str, Any]) -> None:
        scalars = {k: float(v) for k, v in logs.items()}
        self.logged = scalars
        for lg in self.loggers if self.is_main else ():
            if hasattr(lg, "log_scalars"):
                lg.log_scalars(scalars, step)

    # ---- fit ----------------------------------------------------------------

    @staticmethod
    def _trained(module: nn.Module) -> dict[str, nn.Parameter]:
        return {n: p for n, p in module.named_parameters() if p.requires_grad}

    def fit(
        self,
        model: BaseModel,
        datamodule,
        variables: dict[str, torch.Tensor] | None = None,
        ckpt_path: str | Path | None = None,
        pretrained_variables: dict | None = None,
    ) -> nn.Module:
        """Train ``model`` on the datamodule's loaders for ``max_epochs``.

        ``variables`` is a state dict with the reference's names to start
        from (random weights from the seed otherwise); ``pretrained_variables``
        a partial one laid over the initial weights (SAM2's published
        checkpoint: every module but the LoRA factors and the prompt
        predictor); ``ckpt_path`` a ``last.ckpt`` to resume from. Returns the
        trained module, with the SWA average swapped in when that callback
        ran.
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
        if variables is None and pretrained_variables is not None:
            own = module.state_dict()
            unknown = sorted(set(pretrained_variables) - set(own))
            if unknown:
                logger.warning("%d pretrained tensors have no place in the model: %s",
                               len(unknown), ", ".join(unknown[:12]))
            module.load_state_dict(
                {k: torch.as_tensor(np.asarray(v, dtype=np.float32)) for k, v in
                 pretrained_variables.items() if k in own}, strict=False)
            logger.info("laid pretrained weights over the initialization")
        if self.enable_model_summary:
            n = sum(p.numel() for p in module.parameters())
            logger.info("model %s: %.2fM params on %s", model.name, n / 1e6, self.device)
        optimizer = model.make_optimizer(module)
        self.model, self.module, self.optimizer = model, module, optimizer
        self.step = 0
        start_epoch = 0
        if ckpt_path is not None and Path(ckpt_path).exists():
            ckpt = torch.load(ckpt_path, map_location=self.device, weights_only=True)
            module.load_state_dict(ckpt["model"])
            optimizer.load_state_dict(ckpt["optimizer"])
            start_epoch, self.step = int(ckpt["epoch"]), int(ckpt["step"])
            logger.info("resumed from %s at epoch %d", ckpt_path, start_epoch)
        if self.mesh is not None:  # every rank starts from rank 0's state
            replicate(module, self.mesh)
            replicate(optimizer, self.mesh)

        swa = next((c for c in self.callbacks if isinstance(c, StochasticWeightAveraging)), None)
        for epoch in range(start_epoch, self.max_epochs):
            t0 = time.perf_counter()
            train_loader.set_epoch(epoch)
            model.train_mode = True  # SAM2 draws its cond slices by phase
            logs: dict[str, Any] = {}
            for batch, items in train_loader:
                data, label, sharding = self.place(model, batch, items)
                logs = self.train_step(data, label, sharding)
                self.step += 1
                if self.step % self.log_every_n_steps == 0:
                    self._log(self.step, logs)

            epoch_logs = {f"epoch_{k}": float(v) for k, v in logs.items()}
            model.train_mode = False
            if val_loader is not None:
                vals = self._run_eval_epoch(val_loader)
                epoch_logs.update({f"val_{k}": v for k, v in vals.items()})
            epoch_logs["epoch_time_s"] = time.perf_counter() - t0
            self._log(self.step, epoch_logs)

            if swa is not None:  # frozen parameters are not averaged: they stay bit for bit
                swa.on_train_epoch_end(epoch, self.max_epochs, self._trained(module))
            for cb in self._callbacks("on_train_epoch_end"):
                if cb is not swa:
                    cb.on_train_epoch_end(epoch, epoch_logs)

            if self.enable_checkpointing and self.default_root_dir is not None and self.is_main:
                self.default_root_dir.mkdir(parents=True, exist_ok=True)
                torch.save(
                    {"model": module.state_dict(), "optimizer": optimizer.state_dict(),
                     "epoch": epoch + 1, "step": self.step},
                    self.default_root_dir / "last.ckpt",
                )

        if swa is not None:
            averaged = swa.on_fit_end(self._trained(module))
            with torch.no_grad():
                for name, p in self._trained(module).items():
                    p.copy_(averaged[name])
        return module
