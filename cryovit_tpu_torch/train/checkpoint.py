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

The JAX package's own ``.model`` (flax msgpack weights inside the pickle)
needs flax to decode and is refused with a clear error.
"""

from __future__ import annotations

import enum
import io
import pickle
import sys
import types as pytypes
from collections import OrderedDict
from pathlib import Path
from typing import Any

import torch

from cryovit_tpu_torch.models.cryovit import CryoVIT, make_cryovit
from cryovit_tpu_torch.types import ModelType

__all__ = ["load_model", "reference_model_cfg", "save_model"]


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
    """Unpickle ``.model`` files without the reference package. The
    reference's ``SavedModel``/``ModelType`` map to local stand-ins, config
    classes to inert stubs; anything else outside the safe set is refused."""

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
) -> tuple[CryoVIT, ModelType, str, str]:
    """Read a reference-format ``.model`` artifact.

    Returns ``(model, model_type, name, label_key)``; ``model`` is the
    decoder with its weights on ``device`` in ``dtype``. Only CryoVIT models
    are ported so far.
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
    if isinstance(raw.weights, (bytes, bytearray)):
        raise ValueError(
            f"{model_path} holds flax msgpack weights (cryovit_tpu's own .model "
            "format), which cannot be read without flax; export it with "
            "cryovit_tpu.train.torch_export.save_torch_model first."
        )
    if model_type != ModelType.CRYOVIT:
        raise NotImplementedError(f"{model_type.value} models are not yet ported (CryoVIT only)")
    sd = {str(k): v for k, v in dict(raw.weights).items()}
    model = make_cryovit(sd, device=device, dtype=dtype)
    return model, model_type, str(raw.name), str(raw.label_key)


def reference_model_cfg(model_type: ModelType) -> dict[str, Any]:
    """The reference's composed ``cfg.model`` for CryoVIT as a plain dict
    (reference ``configs/model/cryovit.yaml`` + ``default.yaml``). The
    reference loader instantiates the model from it."""
    if model_type != ModelType.CRYOVIT:
        raise NotImplementedError(f"{model_type.value} models are not yet ported")
    return {
        "_target_": "cryovit.models.CryoVIT",
        "name": "CryoVIT",
        "input_key": "dino_features",
        "lr": 1e-4,
        "model_dir": None,
        "weight_decay": 1e-3,
        "losses": {"dice_loss": {"_target_": "cryovit.models.losses.DiceLoss"}},
        "metrics": {
            "dice_metric": {"_target_": "cryovit.models.metrics.DiceMetric", "threshold": 0.5},
            "f1_metric": {"_target_": "cryovit.models.metrics.F1Metric"},
        },
        "custom_kwargs": None,
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
    model: CryoVIT,
    save_path: str | Path,
) -> Path:
    """Write ``model`` as a reference-format ``.model`` artifact (the format
    of ``cryovit_tpu.train.torch_export.save_torch_model``): f32 CPU tensors
    under the reference's parameter names."""
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
            model_type=stubs.ModelType(ModelType.CRYOVIT.value),
            label_key=label_key,
            model_cfg=_DeferredOmegaConf(
                reference_model_cfg(ModelType.CRYOVIT), stubs.OmegaConf.create
            ),
            weights=sd,
        )
        buf = io.BytesIO()
        pickle.dump(artifact, buf, protocol=4)
    save_path.write_bytes(buf.getvalue())
    return save_path
