"""Model family wrappers: hyperparameters + module + losses and metrics.

Port of ``cryovit_tpu/models/base.py`` (reference ``models/base_model.py``,
a LightningModule holding AdamW hyperparameters, a loss dict, per-phase
metrics and the masked prediction). The wrapper is a recipe: it builds the
``nn.Module`` and the optimizer; the training state lives in the
:class:`~cryovit_tpu_torch.train.loop.Trainer`.

Masked prediction (reference ``base_model.py:91-112``): the loss mask is
``y_true > -1`` (−1 = unlabeled voxels and padding), optionally AND-ed with
a ground-truth auxiliary mask.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from cryovit_tpu_torch.types import ModelType

__all__ = ["BaseModel", "clip_gradients", "global_norm", "prediction_mask"]

LossFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def prediction_mask(y_true: torch.Tensor, aux_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Valid-voxel mask: ``y_true > -1``, optionally AND the auxiliary mask."""
    mask = y_true > -1
    if aux_mask is not None:
        mask = mask & (aux_mask > 0)
    return mask


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all ``tensors`` together, in f32 (``optax.global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_gradients(
    params: list[nn.Parameter], clip_val: float | None, algorithm: str = "norm"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Clip the gradients of ``params`` in place and return the global norm
    before and after: by the global norm (``optax.clip_by_global_norm``) or
    element-wise (``optax.clip``); no clipping when ``clip_val`` is None."""
    grads = [p.grad for p in params if p.grad is not None]
    pre = global_norm(grads)
    if clip_val is None:
        return pre, pre
    clip = float(clip_val)
    if algorithm == "norm":
        # optax scales by clip / norm only when the norm exceeds clip
        scale = torch.where(pre < clip, torch.ones_like(pre), clip / pre)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        return pre, torch.minimum(pre, torch.tensor(clip, device=pre.device))
    for g in grads:
        g.clamp_(-clip, clip)
    return pre, global_norm(grads)


class BaseModel:
    """Abstract model family (reference ``base_model.py:20-56``).

    Subclasses set ``model_type`` and define :meth:`build_module`, which
    returns the trainable ``nn.Module`` for a state dict with the
    reference's parameter names (random weights when none is given).
    """

    model_type: ModelType

    def __init__(
        self,
        name: str,
        input_key: str,
        lr: float,
        losses: dict[str, LossFn],
        metrics: dict[str, LossFn],
        weight_decay: float = 1e-3,
        model_dir: str | None = None,
        custom_kwargs: dict[str, Any] | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        self.name = name
        self.input_key = input_key
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.model_dir = model_dir
        self.custom_kwargs = dict(custom_kwargs or {})
        self.dtype = dtype
        self.losses = dict(losses)
        self.metrics = dict(metrics)

    def build_module(
        self,
        state_dict: dict[str, torch.Tensor] | None,
        device: torch.device,
        generator: torch.Generator | None = None,
        in_channels: int | None = None,
    ) -> nn.Module:
        raise NotImplementedError

    def compute_losses(
        self, y_pred: torch.Tensor, y_true: torch.Tensor, mask: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        """All losses and their sum as ``total`` (reference
        ``base_model.py:114-119``). Keys are the config names
        (``dice_loss``), the reference's metrics-CSV columns."""
        out = {key: fn(y_pred, y_true, mask) for key, fn in self.losses.items()}
        out["total"] = sum(out.values())
        return out

    def compute_metrics(
        self, y_pred: torch.Tensor, y_true: torch.Tensor, mask: torch.Tensor
    ) -> dict[str, torch.Tensor]:
        """Metric keys are config names (``dice_metric``, ``f1_metric``)."""
        return {key: fn(y_pred, y_true, mask) for key, fn in self.metrics.items()}

    def make_optimizer(self, params, lr: float | None = None) -> torch.optim.AdamW:
        """AdamW(lr, weight_decay) with optax's defaults (β 0.9/0.999, ε
        1e-8; reference ``base_model.py:58-63``). Gradient clipping, when
        the trainer asks for it, is :func:`clip_gradients` before the step."""
        return torch.optim.AdamW(
            params, lr=lr if lr is not None else self.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=self.weight_decay,
        )
