"""CLI-mode datamodule (port of ``cryovit_tpu/data/datamodules.py:FileDataModule``).

The experiment-mode datamodules (splits CSV, pandas) are not ported yet.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable

from cryovit_tpu_torch.data.pipeline import BucketSpec, collate
from cryovit_tpu_torch.types import FileData

logger = logging.getLogger(__name__)

__all__ = ["FileDataModule"]


class FileDataModule:
    """Zips data paths and label paths into :class:`FileData` (reference
    ``file_datamodule.py``): skips missing files with a warning; validation
    falls back to the training files."""

    def __init__(
        self,
        data_paths: list,
        dataset_fn: Callable,
        dataloader_fn: Callable,
        val_paths: list | None = None,
        data_labels: list | None = None,
        val_labels: list | None = None,
        labels: list[str] | None = None,
        input_key: str | None = None,
    ) -> None:
        self.data_files = self._combine(data_paths, data_labels, labels)
        self.val_files = self._combine(val_paths, val_labels, labels) if val_paths else []
        self.dataset_fn = dataset_fn
        self.dataloader_fn = dataloader_fn
        bucket = BucketSpec.for_input(input_key or "data")
        self.collate_fn = lambda items: collate(items, bucket)

    @staticmethod
    def _combine(files, labels, label_keys) -> list[FileData]:
        files = [Path(f) for f in files]
        file_labels = [None] * len(files) if labels is None else [Path(p) for p in labels]
        if len(files) != len(file_labels):
            raise ValueError("Number of data files must match number of label files.")
        out = []
        for fp, lp in zip(files, file_labels, strict=True):
            if not fp.exists() or (lp is not None and not lp.exists()):
                logger.warning("File %s or label %s does not exist, skipping.", fp, lp)
                continue
            out.append(FileData(tomo_path=fp, label_path=lp, sample=fp.parent.name, labels=label_keys))
        return out

    def _loader(self, files, train: bool, phase: str):
        if not files:
            raise ValueError(f"No {phase} data provided.")
        dataset = self.dataset_fn(files, train=train)
        return self.dataloader_fn(dataset, shuffle=train, collate_fn=self.collate_fn)

    def train_loader(self):
        return self._loader(self.data_files, True, "training")

    def val_loader(self):
        files = self.val_files
        if not files:
            logger.warning("No validation data provided, using training data.")
            files = self.data_files
        return self._loader(files, False, "validation")
