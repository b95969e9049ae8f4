"""DINOv2 feature extraction (port of ``cryovit_tpu/run/dino_features.py``).

Output layout matches the reference file format: ``(1536, D, H/16, W/16)``
fp16 ``dino_features`` beside a gzip ``data`` volume. Slice batches run on
the device one after another; the resize, the backbone and the fp16 cast all
happen there, and only fp16 features come back to the host.
"""

from __future__ import annotations

import logging
import os
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch

from cryovit_tpu_torch import compute_dtype, resolve_device
from cryovit_tpu_torch.convert import dinov2_from_torch_hub
from cryovit_tpu_torch.data.transforms import (
    dino_device_preprocess,
    dino_grid_shape,
    pad_slices_to_multiple,
)
from cryovit_tpu_torch.io import load_data
from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.models.dinov2 import DinoV2, DinoV2Config, make_dinov2

logger = logging.getLogger(__name__)

__all__ = [
    "DinoExtractor",
    "TORCH_HUB_WEIGHTS",
    "default_model_dir",
    "extract_features",
    "load_dinov2_variables",
    "load_extractor",
    "run_dino",
    "save_feature_hdf",
]

TORCH_HUB_WEIGHTS = "dinov2_vitg14_reg4_pretrain.pth"


def default_model_dir(family: str = "DINOv2") -> Path:
    """The JAX package's default weights directory of a foundation model
    (``configs/paths/default.yaml``, ``configs/{dino,sam}_features.yaml``):
    ``$CRYOVIT_MODEL_DIR/<family>`` (``DINOv2`` or ``SAM2``), where
    ``CRYOVIT_MODEL_DIR`` defaults to ``$CRYOVIT_DATA_DIR/foundation_models``
    and ``CRYOVIT_DATA_DIR`` to ``/tmp/cryovit-data``."""
    data_dir = os.environ.get("CRYOVIT_DATA_DIR", "/tmp/cryovit-data")
    return Path(os.environ.get("CRYOVIT_MODEL_DIR", f"{data_dir}/foundation_models")) / family


def _random_dinov2_state_dict(
    cfg: DinoV2Config, generator: torch.Generator
) -> dict[str, torch.Tensor]:
    """flax's init laws for ``DinoV2``: lecun-normal kernels, pos-embed
    N(0, 0.02), LayerScale 1e-5, unit LayerNorm scales, zero biases and
    tokens — drawn on the generator's device."""
    device = generator.device
    with torch.device("meta"):
        template = DinoV2(cfg).state_dict()
    out = {}
    for name, t in template.items():
        shape = tuple(t.shape)
        if name == "pos_embed":
            out[name] = torch.randn(shape, generator=generator, device=device) * 0.02
        elif name.endswith(".gamma"):
            out[name] = torch.full(shape, 1e-5, device=device)
        elif name.startswith("norm") or ".norm" in name:
            out[name] = (torch.ones if name.endswith(".weight") else torch.zeros)(shape, device=device)
        elif name.endswith(".weight"):  # Linear (out, in) or patch conv (E, 1, p, p)
            out[name] = lecun_normal(shape, t[0].numel(), generator)
        else:  # biases, cls and register tokens
            out[name] = torch.zeros(shape, device=device)
    return out


def load_dinov2_variables(
    model_dir: str | Path | None = None,
    random_init: bool = False,
    cfg: DinoV2Config | None = None,
    device: torch.device | str | None = None,
    seed: int = 0,
) -> tuple[dict[str, torch.Tensor], bool]:
    """The backbone's state dict (port names) and whether it is random.

    ``random_init`` draws weights from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (benchmark and smoke runs). Otherwise the
    published torch hub checkpoint :data:`TORCH_HUB_WEIGHTS` is read from
    ``model_dir`` and its patch embed folded to one channel.
    """
    cfg = cfg or DinoV2Config.giant()
    device = resolve_device(device)
    if random_init:
        logger.warning("using RANDOM DINOv2 weights (benchmark mode)")
        generator = torch.Generator(device=device).manual_seed(seed)
        return _random_dinov2_state_dict(cfg, generator), True
    path = Path(model_dir if model_dir is not None else default_model_dir()) / TORCH_HUB_WEIGHTS
    if not path.exists():
        raise FileNotFoundError(
            f"DINOv2 weights not found at {path}: place the torch hub "
            f"checkpoint {TORCH_HUB_WEIGHTS} there (the default directory is "
            f"$CRYOVIT_MODEL_DIR/DINOv2)."
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k: torch.from_numpy(v) for k, v in dinov2_from_torch_hub(sd).items()}, False


def load_extractor(
    model_dir: str | Path | None = None,
    random_init: bool = False,
    cfg: DinoV2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> DinoV2:
    """The backbone, built from :func:`load_dinov2_variables`, on ``device``
    (default: the GPU if there is one) in ``dtype`` (default: bf16 on a GPU,
    f32 on the CPU)."""
    device = resolve_device(device)
    sd, _ = load_dinov2_variables(model_dir, random_init, cfg, device)
    return make_dinov2(sd, cfg, device=device, dtype=dtype or compute_dtype(device))


class DinoExtractor:
    """Slice-batch feature extractor. Output layout matches the reference
    file format: ``(1536, D, H/16, W/16)`` fp16."""

    def __init__(self, model: DinoV2, batch_size: int = 128) -> None:
        self.model = model
        self.batch_size = batch_size
        self.device = model.pos_embed.device

    @torch.inference_mode()
    def extract(self, stack: np.ndarray | torch.Tensor) -> np.ndarray:
        """``(D, H, W)`` padded-to-16 slice stack → ``(C, D, gh, gw)`` fp16.
        f32 input is taken as already normalized; uint8 transfers raw and is
        scaled to [0, 1] on the device."""
        stack = torch.as_tensor(stack)
        d = stack.shape[0]
        gh, gw = dino_grid_shape(*stack.shape[-2:])
        feats = torch.cat(
            [self.model(dino_device_preprocess(b.to(self.device))).to(torch.float16)
             for b in stack.split(self.batch_size)]
        )  # (D, gh·gw, C)
        # (C, D, gh, gw) laid out on the device: one transfer, no host transpose
        return feats.permute(2, 0, 1).reshape(-1, d, gh, gw).contiguous().cpu().numpy()


def save_feature_hdf(
    source: dict[str, np.ndarray],
    features: np.ndarray | dict[str, list[np.ndarray]],
    tomo_name: str,
    dst_dir: Path,
) -> Path:
    """Write the training-ready HDF5 (reference ``_save_data:109-153``):
    gzip ``data`` + ``labels/<k>`` copied from the source, then either
    ``dino_features`` fp16 uncompressed or, for a dict of SAM2 pyramids,
    ``sam_features/<key>/<level>`` (a source's ``dino_features`` is kept,
    gzip)."""
    import h5py

    dst_dir = Path(dst_dir)
    dst_dir.mkdir(parents=True, exist_ok=True)
    path = dst_dir / tomo_name
    with h5py.File(path, "w") as f:
        for key, arr in source.items():
            if key == "data":
                f.create_dataset("data", data=arr, compression="gzip")
            elif key != "dino_features":
                f.create_dataset(f"labels/{key}", data=arr, compression="gzip")
        if isinstance(features, dict):
            if "dino_features" in source:
                f.create_dataset("dino_features", data=source["dino_features"], compression="gzip")
            for key, levels in features.items():
                for i, level in enumerate(levels):
                    f.create_dataset(f"sam_features/{key}/{i}", data=np.ascontiguousarray(level))
        else:
            f.create_dataset("dino_features", data=features)
    return path


def extract_features(
    train_data: list[Path], extractor: DinoExtractor
) -> Iterator[tuple[Path, np.ndarray, np.ndarray]]:
    """For each tomogram file: ``(path, volume, features)``, where volume is
    the normalized ``(D, H, W)`` f32 data and features the
    ``(C, D, H16/16, W16/16)`` fp16 extraction of its padded slices. The
    step :func:`run_dino` runs below its HDF5 writer."""
    for path in train_data:
        data, _ = load_data(Path(path))
        volume = data[0]
        yield Path(path), volume, extractor.extract(pad_slices_to_multiple(volume))


def run_dino(
    train_data: list[Path],
    result_dir: Path,
    batch_size: int = 64,
    random_init: bool = False,
    dino_cfg: DinoV2Config | None = None,
    model_dir: str | Path | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> list[Path]:
    """Extract features for explicit tomogram files →
    ``result_dir/<stem>.hdf`` (reference ``run_dino:210-298``)."""
    if not train_data:
        raise ValueError("No valid tomogram files found.")
    model = load_extractor(model_dir, random_init, dino_cfg, device, dtype)
    extractor = DinoExtractor(model, batch_size=batch_size)
    written = []
    for path, volume, features in extract_features(train_data, extractor):
        out_path = save_feature_hdf(
            {"data": volume}, features, f"{path.stem}.hdf", Path(result_dir)
        )
        logger.info("wrote %s (%s)", out_path, features.shape)
        written.append(out_path)
    return written
