"""Callbacks and loggers (port of parts of ``cryovit_tpu/callbacks.py``).

- :class:`PredictionWriter` (reference ``models/callbacks.py:61-109``):
  thresholded uint8 segmentations in HDF5, byte-compatible with the
  reference layout;
- :class:`TensorBoardLogger`: the trainer's scalars through torch's
  ``SummaryWriter`` (``cryovit-torch train --log-training``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from cryovit_tpu_torch.types import BatchedModelResult

logger = logging.getLogger(__name__)

__all__ = ["PredictionWriter", "TensorBoardLogger", "threshold_masks"]


def threshold_masks(preds: np.ndarray, threshold: float) -> np.ndarray:
    """Probabilities → uint8 masks (1 where ``preds >= threshold``)."""
    return (np.asarray(preds) >= threshold).astype(np.uint8)


class PredictionWriter:
    """Writes ``<results_dir>/<tomo stem>.hdf`` with gzip f32 ``data`` and
    uint8 ``<label_key>_preds`` for every tomogram of a batch."""

    def __init__(self, results_dir: str | Path, label_key: str, threshold: float = 0.5) -> None:
        self.results_dir = Path(results_dir)
        self.label_key = label_key
        self.threshold = threshold
        self.result_paths: list[Path] = []

    def on_predict_batch_end(self, prediction: BatchedModelResult) -> None:
        import h5py

        for n in range(prediction.batch_size):
            path = (self.results_dir / prediction.tomo_names[n]).with_suffix(".hdf")
            path.parent.mkdir(parents=True, exist_ok=True)
            segs = threshold_masks(prediction.preds[n], self.threshold)
            with h5py.File(path, "w") as f:
                f.create_dataset(
                    "data", data=prediction.data[n].astype(np.float32), compression="gzip"
                )
                f.create_dataset(f"{self.label_key}_preds", data=segs, compression="gzip")
            self.result_paths.append(path)


class TensorBoardLogger:
    """Scalar logging to ``<save_dir>/tb/<name>`` via torch's
    ``SummaryWriter``; logs nothing, with a warning, where the tensorboard
    package is not installed."""

    def __init__(self, save_dir: str | Path, name: str = "run") -> None:
        self.log_dir = Path(save_dir) / "tb" / name
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            logger.warning("TensorBoard unavailable (%s); scalars not logged", e)
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._writer = SummaryWriter(log_dir=str(self.log_dir))

    def log_scalars(self, scalars: dict[str, float], step: int) -> None:
        if self._writer is None:
            return
        for key, val in scalars.items():
            self._writer.add_scalar(key, val, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
