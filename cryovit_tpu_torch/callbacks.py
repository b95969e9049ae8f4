"""Callbacks and loggers (port of ``cryovit_tpu/callbacks.py``).

- :class:`ProgressBar`: one log line per training epoch (stands in for
  Lightning's RichProgressBar);
- :class:`TestPredictionWriter` (reference ``models/callbacks.py:15-58``):
  evaluation inputs, labels and probabilities in HDF5;
- :class:`PredictionWriter` (reference ``models/callbacks.py:61-109``):
  thresholded uint8 segmentations in HDF5, byte-compatible with the
  reference layout;
- :class:`CsvWriter` (reference ``models/callbacks.py:112-206``): per-sample
  metrics CSVs, one row per tomogram, replaced on a rerun;
- :class:`TensorBoardLogger`: the trainer's scalars and the experiment's
  hyperparameters through torch's ``SummaryWriter`` (``cryovit-torch train
  --log-training``, ``configs/logger/tensorboard.yaml``);
- :class:`WandbLogger` (``configs/logger/wandb.yaml``): Weights & Biases,
  imported when the logger is made; without wandb it logs nothing, with a
  warning.

h5py is imported only where a writer opens a file; ``TestPredictionWriter``
opens its files in one method (``_write``).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Any

import numpy as np

from cryovit_tpu_torch.types import BatchedModelResult

logger = logging.getLogger(__name__)

__all__ = [
    "CsvWriter",
    "PredictionWriter",
    "ProgressBar",
    "TensorBoardLogger",
    "TestPredictionWriter",
    "WandbLogger",
    "threshold_masks",
]


def threshold_masks(preds: np.ndarray, threshold: float) -> np.ndarray:
    """Probabilities → uint8 masks (1 where ``preds >= threshold``)."""
    return (np.asarray(preds) >= threshold).astype(np.uint8)


class ProgressBar:
    """Console progress reporting (stands in for RichProgressBar): the first
    eight of an epoch's logged values, by name, once per training epoch."""

    def on_train_epoch_end(self, epoch: int, logs: dict[str, float]) -> None:
        parts = [f"{k}={v:.4f}" for k, v in sorted(logs.items()) if "time" not in k]
        logger.info("epoch %d | %s", epoch, " ".join(parts[:8]))


class TestPredictionWriter:
    """Writes ``<results_dir>/<sample>/<tomo_name>`` with ``data``, the
    labels as ``<label_key>`` and the probabilities as
    ``<label_key>_preds`` (both gzip) for every tomogram of a test batch."""

    def __init__(self, results_dir: str | Path, label_key: str) -> None:
        self.results_dir = Path(results_dir)
        self.label_key = label_key

    def _write(self, path: Path, data: np.ndarray, label: np.ndarray, preds: np.ndarray) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("data", data=data)
            f.create_dataset(self.label_key, data=label, compression="gzip")
            f.create_dataset(f"{self.label_key}_preds", data=preds, compression="gzip")

    def on_test_batch_end(self, outputs: BatchedModelResult) -> None:
        for n in range(outputs.batch_size):
            path = self.results_dir / outputs.samples[n] / outputs.tomo_names[n]
            path.parent.mkdir(parents=True, exist_ok=True)
            self._write(path, outputs.data[n], outputs.label[n], outputs.preds[n])


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


class CsvWriter:
    """Per-sample CSV of test metrics: ``<results_dir>/<sample>.csv`` (or
    ``<sample>_<split_id>.csv``) with columns ``sample, tomo_name,
    <metrics...>[, split_id]``, one row per tomogram. A rerun replaces the
    tomogram's row rather than adding one. Written with the ``csv`` module
    (the JAX package uses pandas); ``pandas.read_csv`` reads the same
    frame back."""

    def __init__(self, results_dir: str | Path) -> None:
        self.results_dir = Path(results_dir)
        self.results_dir.mkdir(parents=True, exist_ok=True)

    def on_test_batch_end(self, outputs: BatchedModelResult) -> None:
        if outputs.batch_size != 1:
            raise ValueError("CsvWriter takes single-tomogram batches")
        sample, tomo_name, split_id = outputs.samples[0], outputs.tomo_names[0], outputs.split_id[0]
        path = self.results_dir / (
            f"{sample}.csv" if split_id is None else f"{sample}_{split_id}.csv"
        )
        row: dict[str, object] = {"sample": sample, "tomo_name": tomo_name, **outputs.metrics}
        if split_id is not None:
            row["split_id"] = split_id
        columns, rows = list(row), []
        if path.exists():
            with open(path, newline="") as f:
                reader = csv.DictReader(f)
                columns = list(reader.fieldnames or []) + [c for c in row if c not in
                                                           (reader.fieldnames or [])]
                rows = list(reader)

        def same_tomogram(old: dict[str, str]) -> bool:
            if old.get("sample") != sample or old.get("tomo_name") != tomo_name:
                return False
            return split_id is None or "split_id" not in old or old["split_id"] == str(split_id)

        kept = [r for r in rows if not same_tomogram(r)]
        if len(kept) < len(rows):
            logger.warning("Replacing %d existing row(s) for %s/%s split %s",
                           len(rows) - len(kept), sample, tomo_name, split_id)
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=columns if kept else list(row))
            writer.writeheader()
            writer.writerows(kept)
            writer.writerow(row)


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

    def log_hparams(self, hparams: dict[str, Any]) -> None:
        """The experiment's hyperparameters as one text entry, ``key: value``
        a line (reference ``run/train_model.py:251-287``)."""
        if self._writer is None:
            return
        self._writer.add_text("hparams", "\n".join(f"{k}: {v}" for k, v in hparams.items()))

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class WandbLogger:
    """Weights & Biases scalar and hyperparameter logging (reference
    ``configs/logger/wandb.yaml`` and the hparams of
    ``run/train_model.py:251-287``). wandb is imported when the logger is
    made: without it (air-gapped machines) the logger logs nothing, with a
    warning, and TensorBoard stays the default."""

    def __init__(
        self,
        save_dir: str | Path,
        entity: str | None = None,
        project: str = "CryoVIT",
        group: str | None = None,
        log_model: bool = False,
    ) -> None:
        self.log_model = log_model  # kept for config parity: no model is uploaded
        self._run = None
        try:
            import wandb
        except ImportError:
            logger.warning("wandb is not installed; WandbLogger logs nothing "
                           "(use logger=tensorboard, or install wandb)")
            return
        try:
            self._run = wandb.init(dir=str(save_dir), entity=entity, project=project,
                                   group=group)
        except Exception as e:  # network or authentication failures
            logger.warning("wandb.init failed (%s); scalars not logged", e)

    def log_scalars(self, scalars: dict[str, float], step: int) -> None:
        if self._run is not None:
            self._run.log(scalars, step=step)

    def log_hparams(self, hparams: dict[str, Any]) -> None:
        if self._run is not None:
            self._run.config.update(
                {k: v for k, v in hparams.items()
                 if isinstance(v, (int, float, str, bool, type(None)))},
                allow_val_change=True,
            )

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()
