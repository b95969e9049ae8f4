"""The SAM2 / MedSAM model family: training recipe around :class:`SAM2Model`.

Port of ``cryovit_tpu/models/sam2/family.py`` (reference ``SAM2``
Lightning wrapper, ``models/sam2.py:48-315``):

- the forward resizes each slice to 512² (``jax.image.resize``'s linear
  weights, antialiased on a downscale), caps the depth at
  :data:`MAX_SAM_DEPTH`, upsamples the probabilities back and zero-pads the
  depth;
- the parameter groups: ``prompt`` (the prompt predictor, ``prompt_lr``),
  ``train`` (the LoRA factors and the SAM2-level embeddings, ``lr``) and
  ``frozen`` (encoder, prompt encoder, memory modules, the decoder's base
  weights): ``requires_grad_(False)`` and left out of the optimizer, which
  is ``optax.set_to_zero`` (no update, no decay);
- the total loss adds ``mask_loss``, the Dice loss of the sigmoid prompts;
- ``prepare_inputs`` draws the conditioning slices (reference
  ``prepare_prompt_inputs``, ``models/sam2.py:404-443``) from the family's
  own numpy ``Generator`` (rank 0's draw on every rank of a mesh, as JAX
  draws once) and passes cached ``sam_features`` pyramids on when a file
  carries them;
- under a mesh (``encoder_split_depth``): a batch the batch axis splits takes
  the data-parallel step, each rank tracking its own tomograms; a batch it
  does not split (the reference's batch of one) hands the mesh to the
  forward, which splits only the frozen encoder over the ranks
  (``SAM2Model``), the rest running whole on every rank.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from cryovit_tpu_torch import require_bf16_on_cuda
from cryovit_tpu_torch.models.base import BaseModel
from cryovit_tpu_torch.models.losses import dice_loss
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.hiera import check_window_rule
from cryovit_tpu_torch.models.sam2.model import SAM2Model, random_sam2_state_dict
from cryovit_tpu_torch.ops.resize import resize_linear_2d
from cryovit_tpu_torch.parallel.mesh import Mesh
from cryovit_tpu_torch.types import ModelType

logger = logging.getLogger(__name__)

__all__ = ["MAX_SAM_DEPTH", "SAM2", "param_group"]

MAX_SAM_DEPTH = 255  # reference models/sam2.py:41
LORA_RANK, LORA_ALPHA = 128, 128.0  # reference models/sam2.py:343-346

_FROZEN_ROOTS = ("image_encoder", "sam_prompt_encoder", "memory_encoder", "memory_attention")


def param_group(name: str) -> str:
    """``prompt``, ``train`` or ``frozen`` for a :class:`SAM2Model`
    parameter name (the JAX package's ``SAM2._param_group``)."""
    if name.startswith("prompt_predictor."):
        return "prompt"
    parts = name.split(".")
    if any(root in parts for root in _FROZEN_ROOTS):
        return "frozen"
    if "sam_mask_decoder" in parts:
        return "train" if ("w_a" in parts or "w_b" in parts) else "frozen"
    return "train"


class _SAM2Forward(SAM2Model):
    """Resize → track → resize back, on ``(B, D, H, W, 1)`` volumes in
    [0, 1]; returns ``{"preds", "prompts"}`` probabilities ``(B, D, H, W)``."""

    def forward(self, data: torch.Tensor, backbone: dict | None = None, order=None,
                num_cond=None, mesh: Mesh | None = None) -> dict[str, torch.Tensor]:
        b, d, h, w = data.shape[:4]
        s = self.cfg.image_size
        x = data[..., 0].float()
        if d > MAX_SAM_DEPTH:
            x, d = x[:, :MAX_SAM_DEPTH], MAX_SAM_DEPTH
        if (h, w) != (s, s):
            x = resize_linear_2d(x, s, s)
        out = super().forward(x, backbone, order=order, num_cond=num_cond, mesh=mesh)
        preds, prompts = out["preds"], out["prompts"]
        if (h, w) != (s, s):
            preds, prompts = resize_linear_2d(preds, h, w), resize_linear_2d(prompts, h, w)
        pad = data.shape[1] - d
        if pad:
            preds = F.pad(preds, (0, 0, 0, 0, 0, pad))
            prompts = F.pad(prompts, (0, 0, 0, 0, 0, pad))
        return {"preds": preds, "prompts": torch.sigmoid(prompts)}


def make_sam2(state_dict: dict, cfg: SAM2Config, device: torch.device | str | None = None,
              dtype: torch.dtype = torch.float32, lora_rank: int = LORA_RANK,
              lora_alpha: float = LORA_ALPHA,
              encoder_chunk: int = 64, model_type: ModelType = ModelType.SAM2,
              kv_cache: bool = False) -> _SAM2Forward:
    """The family's module with ``state_dict`` (the reference's trained
    names, loaded strictly) on ``device``: f32 parameters computing in
    ``dtype``, the ``frozen`` group with ``requires_grad`` off; ``kv_cache``
    takes the cached memory attention (``SAM2Model``). On a CUDA device
    ``dtype`` must be bf16, the window kernels' (C3)."""
    require_bf16_on_cuda(torch.device(device or "cpu"), dtype, f"SAM2 in {dtype}",
                         "window_block_attention, window_block_mlp, window_attention")
    with torch.device("meta"):
        module = _SAM2Forward(cfg, lora_rank, lora_alpha, dtype, encoder_chunk, kv_cache)
    sd = {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
          .to(device=device, dtype=torch.float32).clone() for k, v in state_dict.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    for name, p in module.named_parameters():
        p.requires_grad_(param_group(name) != "frozen")
    module.model_type = model_type
    return module


class SAM2(BaseModel):
    """SAM2 / MedSAM family (reference ``models/sam2.py``). ``custom_kwargs``:
    ``prompt_lr``, ``use_cache_features``, ``encoder_chunk``,
    ``num_init_cond_slices`` / ``rand_init_cond_slices`` (train, eval),
    ``test_config`` (``SAM2Config.tiny_test()``) and ``cond_seed`` (the
    seed of the cond-slice draws)."""

    model_type = ModelType.SAM2
    encoder_split_depth = MAX_SAM_DEPTH

    def __init__(self, **kwargs: Any) -> None:
        custom = dict(kwargs.get("custom_kwargs") or {})
        self.prompt_lr = float(custom.pop("prompt_lr", 1e-4))
        self.use_cache_features = bool(custom.pop("use_cache_features", False))
        self.encoder_chunk = int(custom.pop("encoder_chunk", 64))
        self.num_init_cond_slices = tuple(custom.pop("num_init_cond_slices", (1, 1)))
        self.rand_init_cond_slices = tuple(custom.pop("rand_init_cond_slices", (True, False)))
        self.rng = np.random.default_rng(custom.pop("cond_seed", None))
        kwargs["custom_kwargs"] = custom
        super().__init__(**kwargs)
        medsam = str(self.name).lower().startswith("medsam")
        if medsam:
            self.model_type = ModelType.MEDSAM
        cfg = SAM2Config.medsam_tiny() if medsam else SAM2Config.large()
        if self.custom_kwargs.get("test_config"):
            cfg = SAM2Config.tiny_test()
        check_window_rule(cfg.hiera)  # MedSAM's Hiera-T is refused here (ROADMAP C2)
        max_cond = max(1, *map(int, self.num_init_cond_slices))
        if max_cond > cfg.max_cond_slices:
            cfg = dataclasses.replace(cfg, max_cond_slices=max_cond)
        self.sam_cfg = cfg

    def build_module(self, state_dict, device, generator=None, in_channels=None) -> _SAM2Forward:
        """The module with ``state_dict``, or with weights drawn from
        ``generator`` (``random_sam2_state_dict``); ``in_channels`` is always
        1 (raw voxels)."""
        if state_dict is None:
            state_dict = random_sam2_state_dict(self.sam_cfg, generator, LORA_RANK, LORA_ALPHA)
        return make_sam2(state_dict, self.sam_cfg, device, self.dtype, LORA_RANK, LORA_ALPHA,
                         self.encoder_chunk, self.model_type)

    # ---- pretrained weights ---------------------------------------------

    def load_pretrained(self, sam_dir: str | Path) -> dict[str, np.ndarray] | None:
        """The pretrained weights in ``sam_dir`` as a partial state dict to
        overlay on the initial weights, from the first file there in the
        JAX package's order: ``sam2_weights.msgpack`` (its
        ``tools/convert_sam2.py`` writes it; ``convert.sam2_from_jax``), then
        the published ``sam2.1_hiera_large.pt`` (``convert.sam2_from_published``).
        Both give the same names: the LoRA factors and the prompt predictor
        are in neither and stay fresh, as the reference applies LoRA after
        its strict load. None, with a warning, when the directory holds
        neither: training then starts from random weights, as the JAX
        package does (no file is downloaded). MedSAM is refused when the
        family is built (ROADMAP C2), so its files are not looked for."""
        from cryovit_tpu_torch.convert import sam2_from_jax, sam2_from_published
        from cryovit_tpu_torch.train.msgpack import msgpack_read

        sam_dir = Path(sam_dir)
        names = ("sam2_weights.msgpack", "sam2.1_hiera_large.pt")
        for name in names:
            path = sam_dir / name
            if not path.exists():
                continue
            if path.suffix == ".msgpack":
                logger.info("loading the converted SAM2 weights %s", path)
                return sam2_from_jax(msgpack_read(path))
            logger.info("loading the published SAM2 checkpoint %s", path)
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "model" in sd:
                sd = sd["model"]
            return sam2_from_published(sd)
        logger.warning("no pretrained SAM2 weights found in %s (looked for %s); "
                       "training from random initialization", sam_dir, ", ".join(names))
        return None

    # ---- inputs, forward and losses ---------------------------------------

    def _sample_cond_slices(self, d_eff: int, min_slices: int, mesh: Mesh | None = None):
        """The conditioning slices: in train mode ``k ~ U[1, n]`` when the
        train flag is set, the eval count otherwise; the cond set is
        ``{0} ∪ sample(1..min_slices)``. ``(order, num_cond)``, or
        ``(None, None)`` for the default single-cond path. On a ``mesh``
        every rank draws and takes rank 0's draw."""
        phase = 0 if self.train_mode else 1
        n = int(self.num_init_cond_slices[phase])
        if n <= 1:
            return None, None
        if self.rand_init_cond_slices[phase]:
            n = int(self.rng.integers(1, n + 1))
        n = min(n, min_slices)
        cond = [0]
        if n > 1:
            cond += self.rng.choice(np.arange(1, min_slices), size=n - 1, replace=False).tolist()
        rest = [i for i in range(d_eff) if i not in cond]
        if mesh is not None and mesh.size > 1:
            drawn = mesh.broadcast_(torch.tensor([len(cond), *cond, *rest], device=mesh.device))
            return drawn[1:].tolist(), int(drawn[0])
        return cond + rest, len(cond)

    def prepare_inputs(self, data: torch.Tensor, items, mesh: Mesh | None = None):
        """``data`` on the device, plus the cond-slice draw (as ``order`` /
        ``num_cond``; on a ``mesh``, rank 0's) and, with
        ``use_cache_features`` and one item carrying ``sam_features``, its
        cached pyramids (depth-padded or cut to the depth the forward sees)
        in place of the live encoder."""
        d_eff = min(int(data.shape[1]), MAX_SAM_DEPTH)
        min_slices = d_eff
        if items:
            min_slices = min(min(int(it.label.shape[0]) for it in items), d_eff)
        order, num_cond = self._sample_cond_slices(d_eff, max(min_slices, 1), mesh)
        extra = {} if order is None else {"order": order, "num_cond": num_cond}
        aux = (items[0].aux_data or {}) if items and len(items) == 1 else {}
        if not self.use_cache_features or "sam_features" not in aux:
            return {"slices": data, **extra} if extra else data

        def to_flat(levels):
            out = []
            for arr in levels:  # file layout (D, C, h, w) → (D, h, w, C)
                cl = np.moveaxis(np.asarray(arr, dtype=np.float32), 1, -1)
                if cl.shape[0] < d_eff:
                    cl = np.pad(cl, ((0, d_eff - cl.shape[0]), (0, 0), (0, 0), (0, 0)))
                out.append(torch.from_numpy(np.ascontiguousarray(cl[:d_eff])).to(data.device))
            return out

        cached = aux["sam_features"]
        backbone = {k: to_flat(cached[k]) for k in ("backbone_fpn", "vision_pos_enc")}
        return {"slices": data, "backbone": backbone, **extra}

    def split_inputs(self, inputs, sharding):
        """The tensor input as the base class splits it; of the cond-slice
        dict the ``slices`` split and the draw stays whole. Cached pyramids
        take neither the batch split nor the encoder split (no encoder runs
        on them): None."""
        if not isinstance(inputs, dict):
            return super().split_inputs(inputs, sharding)
        if "backbone" in inputs:
            return inputs if sharding.dim is None and not sharding.encoder else None
        return {**inputs, "slices": sharding.local(inputs["slices"])}

    def apply(self, module, data, mesh=None):
        return self.apply_with_aux(module, data, mesh)[0]

    def apply_with_aux(self, module, data, mesh=None):
        """Probabilities and the prompts; ``mesh`` splits the live encoder
        over its ranks, every rank holding the whole batch."""
        if isinstance(data, dict):
            out = module(data["slices"], data.get("backbone"), order=data.get("order"),
                         num_cond=data.get("num_cond"), mesh=mesh)
        else:
            out = module(data, mesh=mesh)
        return out["preds"], {"prompts": out["prompts"]}

    def compute_losses(self, y_pred, y_true, mask, aux=None, mesh=None):
        losses = super().compute_losses(y_pred, y_true, mask, mesh=mesh)
        if aux and "prompts" in aux:
            # Dice of the predicted prompts, supervising the prompt
            # predictor (reference models/sam2.py:145-148)
            losses["mask_loss"] = dice_loss(aux["prompts"], y_true, mask, mesh=mesh)
            losses["total"] = losses["total"] + losses["mask_loss"]
        return losses

    def make_optimizer(self, params, lr: float | None = None) -> torch.optim.AdamW:
        """AdamW over two groups of the module's trainable parameters:
        ``train`` at ``lr`` and ``prompt`` at ``prompt_lr``, with the same
        weight decay; the frozen group is left out."""
        groups: dict[str, list] = {"train": [], "prompt": []}
        for name, p in params.named_parameters():
            group = param_group(name)
            if group != "frozen":
                groups[group].append(p)
        return torch.optim.AdamW(
            [{"params": groups["train"], "lr": lr if lr is not None else self.lr},
             {"params": groups["prompt"], "lr": self.prompt_lr}],
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay,
        )
