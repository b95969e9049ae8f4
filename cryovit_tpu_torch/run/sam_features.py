"""SAM2 image-encoder feature extraction (port of ``cryovit_tpu/run/sam_features.py``).

Runs the frozen Hiera + FPN encoder over every slice at 512² and stores the
``backbone_fpn`` / ``vision_pos_enc`` pyramids as fp16 in the training-ready
HDF5 (``sam_features/<key>/<level>``, channels-first ``(D, C, h, w)``), so
SAM2 training with ``use_cache_features=True`` skips the encoder.

Slice batches run on the device one after another: the resize to 512², the
encoder and the fp16 cast happen there. The tail batch is zero-padded to the
batch size, as in the JAX package. The position encodings do not depend on
the slices, so one slice's worth comes back to the host and is broadcast
over the depth there.
"""

from __future__ import annotations

import logging
from collections.abc import Iterator
from pathlib import Path

import numpy as np
import torch

from cryovit_tpu_torch import compute_dtype, resolve_device
from cryovit_tpu_torch.convert import sam2_encoder_from_published
from cryovit_tpu_torch.io import load_data
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.encoder import (
    ImageEncoder,
    fold_rgb_patch_embed,
    make_image_encoder,
    random_encoder_state_dict,
)
from cryovit_tpu_torch.ops.resize import resize_linear_2d
from cryovit_tpu_torch.run.dino_features import default_model_dir, save_feature_hdf

logger = logging.getLogger(__name__)

__all__ = [
    "SAM2_CHECKPOINT",
    "SamFeatureExtractor",
    "extract_sam_features",
    "load_sam_encoder",
    "make_sam_encoder_state",
    "run_sam",
]

SAM2_CHECKPOINT = "sam2.1_hiera_large.pt"


def make_sam_encoder_state(
    model_dir: str | Path | None = None,
    cfg: SAM2Config | None = None,
    random_init: bool = False,
    device: torch.device | str | None = None,
    seed: int = 0,
) -> dict[str, torch.Tensor]:
    """The encoder's state dict (port names), patch embed folded to one
    channel.

    ``random_init`` draws the weights from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (benchmark and smoke runs). Otherwise the
    published checkpoint :data:`SAM2_CHECKPOINT` is read from ``model_dir``
    (default ``$CRYOVIT_MODEL_DIR/SAM2``, ``dino_features.default_model_dir``).
    """
    cfg = cfg or SAM2Config.large()
    device = resolve_device(device)
    if random_init:
        logger.warning("using RANDOM SAM2 encoder weights")
        generator = torch.Generator(device=device).manual_seed(seed)
        return fold_rgb_patch_embed(random_encoder_state_dict(cfg, generator))
    path = Path(model_dir if model_dir is not None else default_model_dir("SAM2")) / SAM2_CHECKPOINT
    if not path.exists():
        raise FileNotFoundError(
            f"SAM2 weights not found at {path}: place the published checkpoint "
            f"{SAM2_CHECKPOINT} there (the default directory is $CRYOVIT_MODEL_DIR/SAM2)."
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = sam2_encoder_from_published(ckpt.get("model", ckpt))
    return fold_rgb_patch_embed({k: torch.from_numpy(v) for k, v in sd.items()})


def load_sam_encoder(
    model_dir: str | Path | None = None,
    random_init: bool = False,
    cfg: SAM2Config | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> ImageEncoder:
    """The encoder, built from :func:`make_sam_encoder_state`, on ``device``
    (default: the GPU if there is one) computing in ``dtype`` (default: bf16
    on a GPU, f32 on the CPU)."""
    device = resolve_device(device)
    sd = make_sam_encoder_state(model_dir, cfg, random_init, device)
    return make_image_encoder(sd, cfg, device=device, dtype=dtype or compute_dtype(device))


class SamFeatureExtractor:
    """Slice-batch pyramid extractor: ``(D, H, W)`` f32 slices → per level
    ``(D, C, h, w)`` fp16 ``backbone_fpn`` and ``vision_pos_enc``."""

    def __init__(self, encoder: ImageEncoder, batch_size: int = 64) -> None:
        self.encoder = encoder
        self.batch_size = batch_size
        self.device = encoder.trunk.pos_embed.device
        self.image_size = encoder.cfg.image_size
        self.in_chans = encoder.trunk.patch_embed.proj.in_channels

    @torch.inference_mode()
    def extract(self, stack: np.ndarray) -> dict[str, list[np.ndarray]]:
        d = stack.shape[0]
        s, bs = self.image_size, self.batch_size
        feats: list[list[torch.Tensor]] = []
        pos_enc: list[np.ndarray] = []
        for i in range(0, d, bs):
            batch = np.asarray(stack[i : i + bs], dtype=np.float32)
            n = batch.shape[0]
            if n < bs:  # the tail batch, padded as the JAX package pads it
                batch = np.concatenate([batch, np.zeros((bs - n, *batch.shape[1:]), np.float32)])
            x = torch.from_numpy(batch).to(self.device)
            if x.shape[1:] != (s, s):
                x = resize_linear_2d(x, s, s)
            x = x[..., None].expand(-1, -1, -1, self.in_chans)
            out = self.encoder(x)
            feats.append([f[:n].permute(0, 3, 1, 2).to(torch.float16) for f in out["backbone_fpn"]])
            if not pos_enc:
                pos_enc = [p[0].permute(2, 0, 1).to(torch.float16).cpu().numpy()
                           for p in out["vision_pos_enc"]]
        levels = [torch.cat(parts).contiguous().cpu().numpy() for parts in zip(*feats)]
        return {
            "backbone_fpn": levels,
            "vision_pos_enc": [np.broadcast_to(p[None], (d, *p.shape)) for p in pos_enc],
        }


def extract_sam_features(
    train_data: list[Path], extractor: SamFeatureExtractor
) -> Iterator[tuple[Path, np.ndarray, dict[str, list[np.ndarray]]]]:
    """For each tomogram file: ``(path, volume, pyramids)``, where volume is
    its ``(D, H, W)`` f32 data. The step :func:`run_sam` runs below its
    HDF5 writer."""
    for path in train_data:
        data, _ = load_data(Path(path))
        volume = data[0].astype(np.float32)
        yield Path(path), volume, extractor.extract(volume)


def run_sam(
    train_data: list[Path],
    result_dir: Path,
    batch_size: int = 64,
    random_init: bool = False,
    sam_cfg: SAM2Config | None = None,
    model_dir: str | Path | None = None,
    device: torch.device | str | None = None,
    dtype: torch.dtype | None = None,
) -> list[Path]:
    """Extract SAM2 pyramids for explicit tomogram files →
    ``result_dir/<stem>.hdf``."""
    if not train_data:
        raise ValueError("No valid tomogram files found.")
    encoder = load_sam_encoder(model_dir, random_init, sam_cfg, device, dtype)
    extractor = SamFeatureExtractor(encoder, batch_size=batch_size)
    written = []
    for path, volume, feats in extract_sam_features(train_data, extractor):
        out_path = save_feature_hdf({"data": volume}, feats, f"{path.stem}.hdf", Path(result_dir))
        logger.info("wrote %s", out_path)
        written.append(out_path)
    return written
