"""DINOv2 feature extraction (port of ``cryovit_tpu/run/dino_features.py``):
``cryovit-torch features`` (:func:`run_dino`) and the experiment mode's
per-sample sweep (:func:`run_trainer`, ``python -m
cryovit_tpu_torch.training.dino_features``).

Output layout matches the reference file format: ``(1536, D, H/16, W/16)``
fp16 ``dino_features`` beside a gzip ``data`` volume. Slice batches run on
the device one after another; the resize, the backbone and the fp16 cast all
happen there, and only fp16 features come back to the host.
"""

from __future__ import annotations

import csv
import logging
import os
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch

from cryovit_tpu_torch import compute_dtype, resolve_device
from cryovit_tpu_torch.composer import DotDict
from cryovit_tpu_torch.config import samples as ALL_SAMPLES
from cryovit_tpu_torch.config import tomogram_exts, validate_dino_config
from cryovit_tpu_torch.convert import dinov2_from_jax, dinov2_from_torch_hub
from cryovit_tpu_torch.data.transforms import (
    dino_device_preprocess,
    dino_grid_shape,
    pad_slices_to_multiple,
)
from cryovit_tpu_torch.io import load_data
from cryovit_tpu_torch.models._init import lecun_normal
from cryovit_tpu_torch.models.dinov2 import DinoV2, DinoV2Config, make_dinov2
from cryovit_tpu_torch.parallel.mesh import Mesh, batch_sharding
from cryovit_tpu_torch.train.msgpack import msgpack_read

logger = logging.getLogger(__name__)

__all__ = [
    "DinoExtractor",
    "JAX_WEIGHTS",
    "TORCH_HUB_WEIGHTS",
    "default_model_dir",
    "extract_features",
    "load_dinov2_variables",
    "load_extractor",
    "run_dino",
    "run_trainer",
    "save_feature_hdf",
    "sweep_sources",
]

# the weights files of model_dir, in the order they are tried: the JAX
# package's (tools/convert_dinov2.py writes it), then the published torch hub
# checkpoint
JAX_WEIGHTS = "dinov2_vitg14_reg.msgpack"
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
    ``seed`` on ``device`` (benchmark and smoke runs). Otherwise the weights
    in ``model_dir`` (default ``$CRYOVIT_MODEL_DIR/DINOv2``), as the JAX
    package reads them: :data:`JAX_WEIGHTS` where it is there, taken as
    stored (its patch embed is already folded to one channel, ImageNet
    normalization too unless it was written with ``--no-normalize``), else
    the published checkpoint :data:`TORCH_HUB_WEIGHTS`, its patch embed
    folded here.
    """
    cfg = cfg or DinoV2Config.giant()
    device = resolve_device(device)
    if random_init:
        logger.warning("using RANDOM DINOv2 weights (benchmark mode)")
        generator = torch.Generator(device=device).manual_seed(seed)
        return _random_dinov2_state_dict(cfg, generator), True
    model_dir = Path(model_dir if model_dir is not None else default_model_dir())
    converted, hub = model_dir / JAX_WEIGHTS, model_dir / TORCH_HUB_WEIGHTS
    if converted.exists():
        logger.info("loading the converted DINOv2 weights %s", converted)
        sd = dinov2_from_jax(msgpack_read(converted))
    elif hub.exists():
        logger.info("loading the torch hub DINOv2 checkpoint %s", hub)
        sd = dinov2_from_torch_hub(torch.load(hub, map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(
            f"DINOv2 weights not found in {model_dir}: neither {JAX_WEIGHTS} (write it "
            f"once with the JAX package's tools/convert_dinov2.py) nor the torch hub "
            f"checkpoint {TORCH_HUB_WEIGHTS} is there (the default directory is "
            f"$CRYOVIT_MODEL_DIR/DINOv2)."
        )
    return {k: torch.from_numpy(v) for k, v in sd.items()}, False


def load_extractor(
    model_dir: str | Path | None = None,
    random_init: bool = False,
    cfg: DinoV2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    quant_int8: bool = False,
) -> DinoV2:
    """The backbone, built from :func:`load_dinov2_variables`, on ``device``
    in ``dtype`` (default: bf16 on a GPU, f32 on the CPU); ``quant_int8``
    takes the opt-in w8a8 mode (``make_dinov2``). The default device is the
    GPU: without one, :func:`resolve_device` raises, and the CPU is taken
    only when named (``device="cpu"``)."""
    device = resolve_device(device)
    sd, _ = load_dinov2_variables(model_dir, random_init, cfg, device)
    return make_dinov2(sd, cfg, device=device, dtype=dtype or compute_dtype(device),
                       quant_int8=quant_int8)


class DinoExtractor:
    """Slice-batch feature extractor. Output layout matches the reference
    file format: ``(1536, D, H/16, W/16)`` fp16.

    With a ``mesh`` of more than one rank (``cryovit_tpu_torch.parallel``),
    every rank calls :meth:`extract` on the same stack with the same
    weights: ``batch_size`` is rounded up to a multiple of the mesh size,
    each batch is zero-padded to it, each rank runs its slice of every
    batch, and the features are gathered on every rank."""

    def __init__(self, model: DinoV2, batch_size: int = 128, mesh: Mesh | None = None) -> None:
        self.model = model
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if self.mesh is not None and batch_size % self.mesh.size:
            # equal shards per rank; the tail batch is padded anyway
            batch_size = -(-batch_size // self.mesh.size) * self.mesh.size
            logger.info("batch_size rounded up to %d (mesh of %d)", batch_size, self.mesh.size)
        self.batch_size = batch_size
        self.device = model.pos_embed.device

    def _batch(self, b: torch.Tensor) -> torch.Tensor:
        """``(n, gh·gw, C)`` fp16 features of one batch of slices."""
        if self.mesh is None:
            return self.model(dino_device_preprocess(b.to(self.device))).to(torch.float16)
        n, bs = b.shape[0], self.batch_size
        if n < bs:  # the tail batch, padded as the JAX package pads it
            b = torch.cat([b, b.new_zeros((bs - n, *b.shape[1:]))])
        mine = batch_sharding(self.mesh).local(b)
        feats = self.model(dino_device_preprocess(mine.to(self.device))).to(torch.float16)
        return self.mesh.gather(feats)[:n]

    @torch.inference_mode()
    def extract_device(self, stack: np.ndarray | torch.Tensor) -> torch.Tensor:
        """``(D, H, W)`` padded-to-16 slice stack → ``(C, D, gh, gw)`` fp16 on
        the device. f32 input is taken as already normalized; uint8
        transfers raw and is scaled to [0, 1] on the device."""
        stack = torch.as_tensor(stack)
        d = stack.shape[0]
        gh, gw = dino_grid_shape(*stack.shape[-2:])
        feats = torch.cat([self._batch(b) for b in stack.split(self.batch_size)])  # (D, gh·gw, C)
        # (C, D, gh, gw) laid out on the device: one transfer, no host transpose
        return feats.permute(2, 0, 1).reshape(-1, d, gh, gw).contiguous()

    def extract(self, stack: np.ndarray | torch.Tensor) -> np.ndarray:
        """:meth:`extract_device`'s features copied to the host."""
        return self.extract_device(stack).cpu().numpy()


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


def _extract(extractor: DinoExtractor, stack: np.ndarray, volume: np.ndarray, name: str,
             image_dir: Path | None) -> np.ndarray:
    """The stack's features on the host; with ``image_dir``, first the PCA
    maps of ``volume`` and the features while they are on the device
    (``image_dir/name/<z>.png``)."""
    if image_dir is None:
        return extractor.extract(stack)
    from cryovit_tpu_torch.visualization.dino_pca import export_pca

    feats = extractor.extract_device(stack)
    export_pca(volume, feats, name, image_dir)
    return feats.cpu().numpy()


def extract_features(
    train_data: list[Path], extractor: DinoExtractor, visualize: Path | None = None
) -> Iterator[tuple[Path, np.ndarray, np.ndarray]]:
    """For each tomogram file: ``(path, volume, features)``, where volume is
    the normalized ``(D, H, W)`` f32 data and features the
    ``(C, D, H16/16, W16/16)`` fp16 extraction of its padded slices. The
    step :func:`run_dino` runs below its HDF5 writer. With ``visualize``,
    each file's PCA maps go to ``visualize/<stem>/<stem>/<z>.png``, the JAX
    package's layout."""
    for path in train_data:
        path = Path(path)
        data, _ = load_data(path)
        volume = data[0]
        image_dir = None if visualize is None else Path(visualize) / path.stem
        yield path, volume, _extract(extractor, pad_slices_to_multiple(volume), volume,
                                     path.stem, image_dir)


def run_dino(
    train_data: list[Path],
    result_dir: Path,
    batch_size: int = 64,
    random_init: bool = False,
    dino_cfg: DinoV2Config | None = None,
    model_dir: str | Path | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
    quant_int8: bool = False,
    visualize: bool = False,
) -> list[Path]:
    """Extract features for explicit tomogram files →
    ``result_dir/<stem>.hdf`` (reference ``run_dino:210-298``);
    ``quant_int8`` takes the opt-in w8a8 mode; ``visualize`` (``features
    -v``) also writes each file's PCA maps under ``result_dir/dino_images``,
    computed on the device."""
    if not train_data:
        raise ValueError("No valid tomogram files found.")
    model = load_extractor(model_dir, random_init, dino_cfg, device, dtype, quant_int8)
    extractor = DinoExtractor(model, batch_size=batch_size)
    image_dir = Path(result_dir) / "dino_images" if visualize else None
    written = []
    for path, volume, features in extract_features(train_data, extractor, image_dir):
        out_path = save_feature_hdf(
            {"data": volume}, features, f"{path.stem}.hdf", Path(result_dir)
        )
        logger.info("wrote %s (%s)", out_path, features.shape)
        written.append(out_path)
    return written


# ---- experiment path ------------------------------------------------------

def _read_source(path: Path) -> dict[str, np.ndarray]:
    """Flat dict of an annotated tomogram's datasets (the ``labels`` group
    flattened to bare names), mirroring the reference's source-copy walk."""
    import h5py

    from cryovit_tpu_torch.io.hdf import read_dataset

    out: dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        for key in f:
            item = f[key]
            if isinstance(item, h5py.Group):
                for sub in item:
                    out[sub] = np.asarray(read_dataset(item[sub]))
            else:
                out[key] = np.asarray(read_dataset(item))
    return out


def sweep_sources(cfg: DotDict) -> list[tuple[str, Path, list[str]]]:
    """The extraction sweep's ``(sample, source dir, tomogram names)``:
    ``cfg.sample`` or every sample with a directory under
    ``data_dir/<feature_name>``, the names from ``csv/<sample>.csv``'s
    ``tomo_name`` column (read with the ``csv`` module) or else the
    directory's ``.hdf`` / ``.mrc`` files, sorted."""
    data_dir = Path(cfg.paths.data_dir)
    src_dir = data_dir / cfg.paths.feature_name
    csv_dir = data_dir / cfg.paths.csv_name
    sample_names = (
        [cfg.sample] if cfg.get("sample") else [s for s in ALL_SAMPLES if (src_dir / s).exists()]
    )
    out = []
    for sample in sample_names:
        tomo_dir = src_dir / sample
        csv_file = csv_dir / f"{sample}.csv"
        if csv_file.exists():
            with open(csv_file, newline="") as f:
                names = [row["tomo_name"] for row in csv.DictReader(f)]
        else:
            names = sorted(f.name for f in tomo_dir.glob("*") if f.suffix in tomogram_exts)
        out.append((sample, tomo_dir, names))
    return out


def run_trainer(
    cfg: DotDict, dino_cfg: DinoV2Config | None = None, device: torch.device | str | None = None
) -> None:
    """Per-sample feature extraction sweep (reference ``run_trainer:304-350``):
    src = ``data_dir/<feature_name>/<sample>`` (annotated tomograms), dst =
    ``data_dir/<tomo_name>/<sample>`` (training-ready files). ``random_init``
    draws seeded weights; ``quant_int8`` takes the w8a8 mode
    (``features --int8``); ``export_features`` writes each tomogram's PCA
    maps, computed on the device, to ``exp_dir/dino_images/<sample>/<stem>``.
    Runs on the GPU unless ``device`` names the CPU."""
    from cryovit_tpu_torch.run.common import pipeline_io

    validate_dino_config(cfg)
    device = resolve_device(device)
    image_dir = Path(cfg.paths.exp_dir) / "dino_images" if cfg.get("export_features") else None
    dst_dir = Path(cfg.paths.data_dir) / cfg.paths.tomo_name
    model = load_extractor(cfg.model_dir, bool(cfg.get("random_init", False)), dino_cfg, device,
                           quant_int8=bool(cfg.get("quant_int8", False)))
    extractor = DinoExtractor(model, batch_size=int(cfg.batch_size))

    for sample, tomo_dir, names in sweep_sources(cfg):

        def read(i, _names=names, _dir=tomo_dir):
            return _read_source(_dir / _names[i])

        def compute(i, source, _names=names, _sample=sample):
            data = source["data"]
            # uint8 stays uint8: the extractor scales it on the device
            stack = data if data.dtype == np.uint8 else data.astype(np.float32)
            return source, _extract(extractor, pad_slices_to_multiple(stack), data,
                                    Path(_names[i]).stem,
                                    None if image_dir is None else image_dir / _sample)

        def write(i, result, _names=names, _sample=sample):
            source, features = result
            save_feature_hdf(source, features, _names[i], dst_dir / _sample)
            logger.info("[%s] %s → %s", _sample, _names[i], features.shape)

        # HDF5 decode / device compute / gzip write overlap
        pipeline_io(len(names), read, compute, write)
