"""Segmentation overlay videos (port of ``cryovit_tpu/visualization/segmentations.py``):
per-label coloured predictions over the raw slices, side by side with the
plain slices, written as mp4 with cv2; and the walker that collects each
tomogram's prediction HDF5s of an experiment.

cv2, seaborn (for its palette) and h5py are imported where they are used,
cv2 and seaborn first: a missing one raises an ``ImportError`` naming it
before any file is read.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from cryovit_tpu_torch.visualization._plotting import require

logger = logging.getLogger(__name__)

__all__ = ["process_file", "process_experiment"]

_LABEL_ORDER = ["mito", "cristae", "microtubule", "granule"]


def _palette() -> dict[str, tuple[float, float, float]]:
    (sns,) = require("seaborn")
    colors = sns.color_palette("deep")[: len(_LABEL_ORDER)]
    return dict(zip(_LABEL_ORDER, colors))


def process_file(
    file_name: str,
    label_dict: dict[str, Path],
    result_dir: Path,
    threshold: float = 0.5,
    fps: int = 30,
) -> Path:
    """Overlay per-label predictions on raw slices → side-by-side mp4 at
    ``result_dir/<sample>/<file_name>.mp4``."""
    cv2, _, h5py = require("cv2", "seaborn", "h5py")
    hue_palette = _palette()
    label_data: dict[str, np.ndarray] = {}
    sample = "unknown"
    for label, f_path in label_dict.items():
        sample = Path(f_path).parent.name
        with h5py.File(f_path, "r") as fh:
            if "data" not in label_data:
                data = np.asarray(fh["data"][()], dtype=np.float32)
                if data.max() > 1.0:
                    data = data / 255.0
                label_data["data"] = data
            pred_key = f"{label}_preds" if f"{label}_preds" in fh else label
            label_data[label] = np.asarray(fh[pred_key][()], dtype=np.float32)

    base = np.clip(label_data["data"], 0, 1)
    combined = np.zeros((*base.shape, 3), dtype=np.float32)
    for label, seg in label_data.items():
        if label == "data":
            continue
        color = np.asarray(hue_palette.get(label, (1.0, 1.0, 1.0))).reshape(1, 1, 1, 3)
        combined += seg[..., None] * color
    combined = np.clip(combined, 0, 1)

    gray_rgb = np.stack([base] * 3, axis=-1)
    overlay = np.where(combined > threshold, combined, gray_rgb)
    frames = (np.concatenate([gray_rgb, overlay], axis=2) * 255).astype(np.uint8)

    out_path = Path(result_dir) / sample / f"{file_name}.mp4"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(str(out_path), cv2.VideoWriter.fourcc(*"mp4v"), fps, (w, h))
    for frame in frames:
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
    logger.info("saved video to %s", out_path)
    return out_path


def process_experiment(
    exp_dir: Path,
    result_dir: Path,
    labels: list[str] | None = None,
    threshold: float = 0.5,
) -> list[Path]:
    """Walk ``predictions/<name>/<sample>/<tomo>.hdf`` trees and render one
    video per tomogram, combining all labels found for it."""
    _, _, h5py = require("cv2", "seaborn", "h5py")
    exp_dir = Path(exp_dir)
    labels = labels or _LABEL_ORDER
    by_tomo: dict[tuple[str, str], dict[str, Path]] = {}
    for f in sorted(exp_dir.rglob("*.hdf")):
        sample, name = f.parent.name, f.stem
        with h5py.File(f) as fh:
            file_labels = [lb for lb in labels if lb in fh or f"{lb}_preds" in fh]
        for lb in file_labels:
            by_tomo.setdefault((sample, name), {})[lb] = f
    return [process_file(name, label_dict, Path(result_dir), threshold)
            for (_, name), label_dict in by_tomo.items()]
