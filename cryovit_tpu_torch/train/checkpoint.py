"""The distributable ``.model`` artifact in the reference torch format.

A ``.model`` file is a pickle of the reference ``cryovit.utils.SavedModel``
(name, model type, label key, an omegaconf model config, and a torch
``state_dict`` with the reference's parameter names; reference
``utils.py:335-468``). This is the format the JAX package writes with
``train/torch_export.py:save_torch_model`` and reads with
``train/torch_import.py``:

- :func:`load_model` reads it without the reference package or omegaconf,
  through a restricted unpickler that admits only torch's tensor-rebuild
  functions, plain containers and stand-ins for the reference's own classes;
- :func:`save_model` writes it, so the reference stack and the JAX package
  read it back.

SAM2 and MedSAM artifacts hold the reference SAM2 wrapper's full trained
state dict (``model.*`` and ``prompt_predictor.*``, the names
``cryovit_tpu.train.torch_export_sam2.export_sam2_state_dict`` writes),
loaded strictly into the port's ``SAM2Model``; the architecture (the test
config or the published one, the LoRA rank) is read off the tensors' shapes.

:func:`load_model` also reads the JAX package's own ``.model`` (its
``cryovit_tpu.train.checkpoint.SavedModel``, whose weights are flax msgpack
bytes: decoded by ``train/msgpack.py`` without flax, then mapped onto the
reference names by the ``convert.py`` bridge of the model type), and
:func:`load_jax_weights` its ``weights.msgpack`` for a named model type.
MedSAM is refused either way (ROADMAP C2).
"""

from __future__ import annotations

import enum
import io
import pickle
import sys
import types as pytypes
from collections import OrderedDict
from functools import partial
from pathlib import Path
from typing import Any

import numpy as np
import torch

from cryovit_tpu_torch.convert import cryovit_from_jax, sam2_from_jax, unet3d_from_jax
from cryovit_tpu_torch.models.cryovit import CryoVIT, make_cryovit
from cryovit_tpu_torch.models.sam2.config import HieraConfig, SAM2Config
from cryovit_tpu_torch.models.sam2.family import make_sam2
from cryovit_tpu_torch.models.sam2.model import SAM2Model
from cryovit_tpu_torch.models.unet3d import UNet3D, make_unet3d
from cryovit_tpu_torch.train.msgpack import msgpack_read, msgpack_restore
from cryovit_tpu_torch.types import ModelType

__all__ = ["load_jax_weights", "load_model", "reference_model_cfg", "save_model"]


def _sam2_config_of(state_dict: dict, model_type: ModelType) -> tuple[SAM2Config, int]:
    """The ``SAM2Config`` and LoRA rank of a SAM2 state dict, from its
    shapes: the test config when the trunk is the test Hiera's width,
    otherwise ``large()`` (SAM2) or ``medsam_tiny()`` (MedSAM); the rank is
    the LoRA factors' (0 without them)."""
    width = state_dict["model.image_encoder.trunk.patch_embed.proj.weight"].shape[0]
    if width == HieraConfig.test().embed_dim:
        cfg = SAM2Config.tiny_test()
    else:
        cfg = SAM2Config.medsam_tiny() if model_type == ModelType.MEDSAM else SAM2Config.large()
    lora = [v for k, v in state_dict.items() if k.endswith(".w_a.weight")]
    return cfg, (lora[0].shape[0] if lora else 0)


def _make_sam2(state_dict, device=None, dtype=torch.float32, model_type=ModelType.SAM2):
    cfg, rank = _sam2_config_of(state_dict, model_type)
    return make_sam2(state_dict, cfg, device, dtype, lora_rank=rank, lora_alpha=float(rank or 1),
                     model_type=model_type)


# the model families whose .model artifacts the port reads and writes
_MODULES = {
    ModelType.CRYOVIT: (CryoVIT, make_cryovit),
    ModelType.UNET3D: (UNet3D, make_unet3d),
    ModelType.SAM2: (SAM2Model, partial(_make_sam2, model_type=ModelType.SAM2)),
    ModelType.MEDSAM: (SAM2Model, partial(_make_sam2, model_type=ModelType.MEDSAM)),
}


# the JAX package's variables → the reference state dict, by model type
_JAX_BRIDGES = {
    ModelType.CRYOVIT: cryovit_from_jax,
    ModelType.UNET3D: unet3d_from_jax,
    ModelType.SAM2: sam2_from_jax,
    ModelType.MEDSAM: sam2_from_jax,  # then refused by the trunk's window rule (C2)
}


def _from_jax(variables: dict, model_type: ModelType) -> dict[str, torch.Tensor]:
    """The JAX package's variables tree for ``model_type`` → the reference
    state dict, as torch tensors."""
    sd = _JAX_BRIDGES[model_type](variables)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def load_jax_weights(path: str | Path, model_type: ModelType | str) -> dict[str, torch.Tensor]:
    """A JAX ``weights.msgpack`` (``cryovit_tpu.train.checkpoint.save_weights``:
    the flax msgpack of a model's variables) as the reference state dict of
    ``model_type``."""
    return _from_jax(msgpack_read(path), ModelType(model_type))


class _Stub:
    """Inert stand-in for config classes (omegaconf nodes, hydra dataclasses):
    accepts any construction or setstate protocol, keeps nothing usable."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        self._args, self._kwargs = args, kwargs

    def __setstate__(self, state: Any) -> None:
        self._state = state


class _RawSavedModel:
    """Field capture for the reference ``SavedModel`` dataclass."""

    name: str = ""
    model_type: Any = None
    label_key: str = ""
    model_cfg: Any = None
    weights: Any = None

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        for field, value in zip(["name", "model_type", "label_key", "model_cfg", "weights"], args):
            setattr(self, field, value)
        for key, value in kwargs.items():
            setattr(self, key, value)

    def __setstate__(self, state: Any) -> None:
        if isinstance(state, dict):
            self.__dict__.update(state)


_SAFE_GLOBALS = {
    ("collections", "OrderedDict"),
    ("torch._utils", "_rebuild_tensor_v2"),
    ("torch._utils", "_rebuild_parameter"),
    ("torch.storage", "_load_from_bytes"),
    ("torch", "Size"),
    ("torch", "device"),
}
_SAFE_BUILTINS = {"dict", "list", "tuple", "set", "frozenset", "int", "float", "str", "bytes", "bool"}


class _ReferenceUnpickler(pickle.Unpickler):
    """Unpickle ``.model`` files without the reference package or the JAX
    one. ``SavedModel`` and ``ModelType`` (the reference's ``cryovit.utils``
    / ``cryovit.types`` ones and the JAX package's
    ``cryovit_tpu.train.checkpoint`` / ``cryovit_tpu.types`` ones) map to
    local stand-ins by name and are never imported, config classes to inert
    stubs; anything else outside the safe set is refused."""

    def find_class(self, module: str, name: str) -> Any:
        root = module.split(".")[0]
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if module == "torch" and (
            name.endswith("Storage") or isinstance(getattr(torch, name, None), torch.dtype)
        ):
            return super().find_class(module, name)
        if name == "SavedModel":
            return _RawSavedModel
        if name == "ModelType":
            return ModelType
        if root in ("omegaconf", "hydra", "cryovit", "dataclasses", "enum", "typing"):
            return _Stub
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name} from a .model file")


def load_model(
    model_path: str | Path,
    device: torch.device | str | None = None,
    dtype: torch.dtype = torch.float32,
) -> tuple[CryoVIT | UNet3D | SAM2Model, ModelType, str, str]:
    """Read a reference-format ``.model`` artifact.

    Returns ``(model, model_type, name, label_key)``; ``model`` is the
    CryoVIT decoder or the U-Net with its weights on ``device`` in ``dtype``,
    or the SAM2 module (f32 weights computing in ``dtype``).
    """
    model_path = Path(model_path)
    if not model_path.exists():
        raise FileNotFoundError(f"Model file {model_path} does not exist.")
    with open(model_path, "rb") as f:
        raw = _ReferenceUnpickler(f).load()
    if not isinstance(raw, _RawSavedModel):
        raise ValueError(f"{model_path} does not contain a SavedModel")
    model_type = raw.model_type
    if not isinstance(model_type, ModelType):
        model_type = ModelType(str(model_type))
    if isinstance(raw.weights, (bytes, bytearray)):  # the JAX package's own format
        sd = _from_jax(msgpack_restore(raw.weights), model_type)
    else:
        sd = {str(k): v for k, v in dict(raw.weights).items()}
    model = _MODULES[model_type][1](sd, device=device, dtype=dtype)
    return model, model_type, str(raw.name), str(raw.label_key)


def reference_model_cfg(model_type: ModelType) -> dict[str, Any]:
    """The reference's composed ``cfg.model`` as a plain dict (reference
    ``configs/model/{cryovit,unet3d,sam2,medsam}.yaml`` + ``default.yaml`` /
    ``default_sam.yaml``; ``cryovit_tpu/train/torch_export.py:169-223``).
    The reference loader instantiates the model from it."""
    custom = None
    if model_type == ModelType.CRYOVIT:
        head = {"_target_": "cryovit.models.CryoVIT", "name": "CryoVIT",
                "input_key": "dino_features", "lr": 1e-4}
    elif model_type == ModelType.UNET3D:
        head = {"_target_": "cryovit.models.UNet3D", "name": "UNet3D",
                "input_key": "data", "lr": 3e-3}
    elif model_type in (ModelType.SAM2, ModelType.MEDSAM):
        head = {"_target_": "cryovit.models.sam2.SAM2",
                "name": "MedSAM" if model_type == ModelType.MEDSAM else "SAM2",
                "input_key": "data", "lr": 5e-5}
        custom = {"prompt_lr": 1e-4, "num_init_cond_slices": [1, 1],
                  "rand_init_cond_slices": [True, False], "use_cache_features": True}
    else:
        raise NotImplementedError(f"{model_type.value} models are not yet ported")
    return {
        **head,
        "model_dir": None,
        "weight_decay": 1e-3,
        "losses": {"dice_loss": {"_target_": "cryovit.models.losses.DiceLoss"}},
        "metrics": {
            "dice_metric": {"_target_": "cryovit.models.metrics.DiceMetric", "threshold": 0.5},
            "f1_metric": {"_target_": "cryovit.models.metrics.F1Metric"},
        },
        "custom_kwargs": custom,
    }


class _StubRegistry:
    """Registers stand-in classes under the reference's module paths while
    pickling, so ``pickle`` stores them by reference; removes them after.
    The bytes then resolve to the real ``cryovit.utils.SavedModel``,
    ``cryovit.types.ModelType`` and ``omegaconf.OmegaConf.create`` in the
    reference stack."""

    def __enter__(self):
        self._created: list[tuple[pytypes.ModuleType, str]] = []
        self._new_modules: list[str] = []

        def module(name: str) -> pytypes.ModuleType:
            if name not in sys.modules:
                self._new_modules.append(name)
                sys.modules[name] = pytypes.ModuleType(name)
            return sys.modules[name]

        cu = module("cryovit.utils")
        ct = module("cryovit.types")
        module("cryovit")
        oo = module("omegaconf.omegaconf")
        om = module("omegaconf")

        class SavedModel:
            pass

        SavedModel.__module__ = "cryovit.utils"
        SavedModel.__qualname__ = "SavedModel"
        ref_model_type = enum.Enum(
            "ModelType", {m.name: m.value for m in ModelType},
            module="cryovit.types", qualname="ModelType",
        )

        class OmegaConf:
            @staticmethod
            def create(obj):  # never called while pickling
                return obj

        OmegaConf.__module__ = "omegaconf.omegaconf"
        OmegaConf.__qualname__ = "OmegaConf"
        OmegaConf.create.__module__ = "omegaconf.omegaconf"
        OmegaConf.create.__qualname__ = "OmegaConf.create"
        for mod, name, obj in (
            (cu, "SavedModel", SavedModel),
            (ct, "ModelType", ref_model_type),
            (oo, "OmegaConf", OmegaConf),
            (om, "OmegaConf", OmegaConf),
        ):
            if not hasattr(mod, name):
                setattr(mod, name, obj)
                self._created.append((mod, name))
        self.SavedModel = SavedModel
        self.ModelType = ref_model_type
        self.OmegaConf = OmegaConf
        return self

    def __exit__(self, *exc):
        for mod, name in self._created:
            delattr(mod, name)
        for name in self._new_modules:
            sys.modules.pop(name, None)
        return False


class _DeferredOmegaConf:
    """Pickles as ``OmegaConf.create(cfg_dict)``: a real DictConfig where
    omegaconf exists, an inert stub in the JAX package and here."""

    def __init__(self, cfg: dict, create_fn):
        self._cfg = cfg
        self._create = create_fn

    def __reduce__(self):
        return (self._create, (self._cfg,))


def save_model(
    model_name: str,
    label_key: str,
    model: CryoVIT | UNet3D | SAM2Model,
    save_path: str | Path,
) -> Path:
    """Write ``model`` as a reference-format ``.model`` artifact (the format
    of ``cryovit_tpu.train.torch_export.save_torch_model``): f32 CPU tensors
    under the reference's parameter names, the model type and config of its
    family (a SAM2 module says whether it is MedSAM's)."""
    model_type = getattr(model, "model_type", None) or next(
        t for t, (cls, _) in _MODULES.items() if isinstance(model, cls))
    sd = OrderedDict(
        (k, v.detach().to("cpu", torch.float32).contiguous())
        for k, v in model.state_dict().items()
    )
    save_path = Path(save_path)
    save_path.parent.mkdir(parents=True, exist_ok=True)
    with _StubRegistry() as stubs:
        artifact = stubs.SavedModel()
        artifact.__dict__.update(
            name=model_name,
            model_type=stubs.ModelType(model_type.value),
            label_key=label_key,
            model_cfg=_DeferredOmegaConf(reference_model_cfg(model_type), stubs.OmegaConf.create),
            weights=sd,
        )
        buf = io.BytesIO()
        pickle.dump(artifact, buf, protocol=4)
    save_path.write_bytes(buf.getvalue())
    return save_path
