"""Split-policy datamodules over a splits CSV, and the CLI-mode
``FileDataModule`` (port of ``cryovit_tpu/data/datamodules.py``).

The JAX package filters a pandas DataFrame of ``splits.csv`` and rebuilds
the fractional folds with sklearn's ``KFold(11, shuffle=True,
random_state=42)``. The port runs without either, so here the CSV is
read with the ``csv`` module into records (one dict per row, in file order,
integer columns as ints), each ``*_df`` returns the records the JAX filter
keeps, in its order and with its columns, and the folds are rebuilt with
numpy alone (:func:`kfold_assignments`). The loaders are the JAX package's:
shuffled for training only.
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path
from typing import Any, Callable

import numpy as np

from cryovit_tpu_torch.data.pipeline import BucketSpec, collate
from cryovit_tpu_torch.types import FileData

logger = logging.getLogger(__name__)

__all__ = [
    "BaseDataModule",
    "FileDataModule",
    "FractionalDataModule",
    "FractionalSampleDataModule",
    "MultiSampleDataModule",
    "Records",
    "SingleSampleDataModule",
    "kfold_assignments",
    "read_records",
]

Records = list[dict[str, Any]]


def _as_list(value) -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def _typed_column(values: list[str]) -> list:
    """A CSV column as ``pandas.read_csv`` types it: ints, else floats,
    else the strings."""
    for cast in (int, float):
        try:
            return [cast(v) for v in values]
        except ValueError:
            continue
    return values


def read_records(path: str | Path) -> Records:
    """The rows of a splits CSV as dicts, in file order, with its columns in
    file order and each column typed as pandas types it (``split_id`` an
    int)."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        columns = list(reader.fieldnames or [])
        rows = list(reader)
    typed = {c: _typed_column([r[c] for r in rows]) for c in columns}
    return [{c: typed[c][i] for c in columns} for i in range(len(rows))]


def kfold_assignments(n: int, n_splits: int = 11, seed: int = 42) -> np.ndarray:
    """The fold of each of ``n`` rows under sklearn's ``KFold(n_splits,
    shuffle=True, random_state=seed)``: ``RandomState(seed).shuffle`` of
    ``arange(n)``, then consecutive folds of ``n // n_splits + 1`` rows for
    the first ``n % n_splits`` folds and ``n // n_splits`` for the rest."""
    if n < n_splits:
        raise ValueError(f"Cannot have number of splits n_splits={n_splits} greater than "
                         f"the number of samples: n_samples={n}.")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    folds = np.full(n, -1, dtype=int)
    start = 0
    for f, size in enumerate(sizes):
        folds[order[start : start + size]] = f
        start += size
    return folds


def _select(records: Records, keep, columns: list[str] | None = None) -> Records:
    """The records for which ``keep(record)`` holds, in order; only
    ``columns`` of each when given (a DataFrame filter and column pick)."""
    out = [r for r in records if keep(r)]
    return [{c: r[c] for c in columns} for r in out] if columns is not None else out


_KEYS = ["sample", "tomo_name"]


class BaseDataModule:
    """Common loader plumbing (reference ``base_datamodule.py:14-128``):
    reads ``splits.csv``, exposes abstract ``{train,val,test,predict}_df``,
    builds loaders with shuffle only for train."""

    def __init__(
        self,
        split_file: str | Path,
        dataset_fn: Callable,
        dataloader_fn: Callable,
        input_key: str | None = None,
        **_: object,
    ) -> None:
        self.split_file = Path(split_file)
        self.record_df: Records = read_records(self.split_file)
        self.dataset_fn = dataset_fn
        self.dataloader_fn = dataloader_fn
        bucket = BucketSpec.for_input(input_key or "data")
        self.collate_fn = lambda items: collate(items, bucket)

    # -- split policies (abstract) --------------------------------------
    def train_df(self) -> Records:
        raise NotImplementedError

    def val_df(self) -> Records:
        raise NotImplementedError

    def test_df(self) -> Records:
        raise NotImplementedError

    def predict_df(self) -> Records:
        raise NotImplementedError

    # -- loaders ---------------------------------------------------------
    def _loader(self, records: Records, train: bool, phase: str):
        if not records:
            raise ValueError(f"No {phase} data found in the provided split file.")
        dataset = self.dataset_fn(records, train=train)
        return self.dataloader_fn(dataset, shuffle=train, collate_fn=self.collate_fn)

    def train_loader(self):
        return self._loader(self.train_df(), train=True, phase="training")

    def val_loader(self):
        return self._loader(self.val_df(), train=False, phase="validation")

    def test_loader(self):
        return self._loader(self.test_df(), train=False, phase="testing")

    def predict_loader(self):
        return self._loader(self.predict_df(), train=False, phase="prediction")


class SingleSampleDataModule(BaseDataModule):
    """Train on one sample excluding ``split_id`` rows; val = that split;
    test = ``test_sample`` (whole other sample) or val — 10-fold CV
    (reference ``single_sample_datamodule.py:44-105``)."""

    def __init__(
        self,
        sample,
        split_id: int | None = None,
        split_key: str = "split_id",
        test_sample=None,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)
        sample = _as_list(sample)
        test_sample = _as_list(test_sample) or None
        if len(sample) != 1:
            raise ValueError(f"single-sample 'sample' must be one name, got {sample}")
        if test_sample is not None and len(test_sample) != 1:
            raise ValueError(f"single-sample 'test_sample' must be one name, got {test_sample}")
        self.sample = sample[0]
        self.split_id = split_id
        self.split_key = split_key
        self.test_sample = test_sample[0] if test_sample else None

    def train_df(self) -> Records:
        if self.split_id is not None:
            return _select(self.record_df, lambda r: r[self.split_key] != self.split_id
                           and r["sample"] == self.sample)
        return _select(self.record_df, lambda r: r["sample"] == self.sample, _KEYS)

    def val_df(self) -> Records:
        if self.split_id is None:
            return self.train_df()
        return _select(self.record_df, lambda r: r[self.split_key] == self.split_id
                       and r["sample"] == self.sample)

    def test_df(self) -> Records:
        if self.test_sample is None:
            return self.val_df()
        return _select(self.record_df, lambda r: r["sample"] == self.test_sample, _KEYS)

    def predict_df(self) -> Records:
        return _select(self.record_df, lambda r: r["sample"] == self.sample, _KEYS)


class MultiSampleDataModule(BaseDataModule):
    """Same policy with sample lists (``isin``) — used for domain-shift
    experiments (reference ``multi_sample_datamodule.py:42-103``)."""

    def __init__(
        self,
        sample,
        split_id: int | None = None,
        split_key: str = "split_id",
        test_sample=None,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)
        self.sample = _as_list(sample)
        self.split_id = split_id
        self.split_key = split_key
        self.test_sample = _as_list(test_sample) or None

    def train_df(self) -> Records:
        if self.split_id is not None:
            return _select(self.record_df, lambda r: r[self.split_key] != self.split_id
                           and r["sample"] in self.sample)
        return _select(self.record_df, lambda r: r["sample"] in self.sample, _KEYS)

    def val_df(self) -> Records:
        if self.split_id is None:
            return self.train_df()
        return _select(self.record_df, lambda r: r[self.split_key] == self.split_id
                       and r["sample"] in self.sample)

    def test_df(self) -> Records:
        if self.test_sample is None:
            return self.val_df()
        return _select(self.record_df, lambda r: r["sample"] in self.test_sample, _KEYS)

    def predict_df(self) -> Records:
        return _select(self.record_df, lambda r: r["sample"] in self.sample, _KEYS)


class FractionalDataModule(BaseDataModule):
    """Data-fraction sweep: regenerate 11 folds in memory as
    ``KFold(11, shuffle=True, random_state=42)`` does
    (:func:`kfold_assignments`), hold out fold ``test_sample`` (int), train
    on the first ``split_id`` of the remaining 10 folds (reference
    ``fractional_datamodule.py``)."""

    def __init__(
        self,
        sample,
        split_id: int | None = None,
        split_key: str = "split_id",
        test_sample: int | None = None,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)
        if test_sample is None:
            raise ValueError("fractional 'test_sample' cannot be None")
        if not isinstance(test_sample, (int, np.integer)):
            raise ValueError(
                f"fractional 'test_sample' must be an integer fold id, got {test_sample!r}"
            )
        folds = kfold_assignments(len(self.record_df))
        for record, fold in zip(self.record_df, folds):
            record[split_key] = int(fold)

        self.sample = _as_list(sample)
        self.split_id = split_id
        self.split_key = split_key
        self.test_id = int(test_sample)

    def train_df(self) -> Records:
        all_splits = sorted({r[self.split_key] for r in self.record_df} - {self.test_id})
        if len(all_splits) != 10:
            raise ValueError(f"expected 10 training folds, got {len(all_splits)}")
        splits = all_splits[: self.split_id] if self.split_id is not None else all_splits
        return _select(self.record_df, lambda r: r[self.split_key] in splits
                       and r["sample"] in self.sample, _KEYS)

    def val_df(self) -> Records:
        return _select(self.record_df, lambda r: r[self.split_key] == self.test_id
                       and r["sample"] in self.sample)

    def test_df(self) -> Records:
        keys = _KEYS + ([self.split_key] if self.split_id is not None else [])
        out = _select(self.val_df(), lambda r: True, keys)
        if self.split_key in keys:
            # report the data-fraction index as split_id (reference behavior)
            for r in out:
                r["split_id"] = self.split_id
        return out

    def predict_df(self) -> Records:
        return _select(self.record_df, lambda r: r["sample"] in self.sample, _KEYS)


class FractionalSampleDataModule(BaseDataModule):
    """Fractional leave-one-*sample*-out: train on splits ``< split_id`` of
    all samples except ``test_sample``; val/test = the held-out sample
    (reference ``fractional_sample_datamodule.py:42-91``)."""

    def __init__(
        self,
        sample,
        split_id: int | None = None,
        split_key: str = "split_id",
        test_sample=None,
        **kwargs,
    ) -> None:
        super().__init__(**kwargs)
        test_sample = _as_list(test_sample)
        if len(test_sample) != 1:
            raise ValueError("fractional-sample 'test_sample' must be one name")
        self.sample = _as_list(sample)
        self.split_id = split_id
        self.split_key = split_key
        self.test_sample = test_sample

    def train_df(self) -> Records:
        if self.split_id is not None:
            splits = list(range(self.split_id))
        else:
            splits = list(range(int(max(r[self.split_key] for r in self.record_df))))
        return _select(self.record_df, lambda r: r[self.split_key] in splits
                       and r["sample"] in self.sample and r["sample"] not in self.test_sample,
                       _KEYS)

    def val_df(self) -> Records:
        return _select(self.record_df, lambda r: r["sample"] in self.test_sample)

    def test_df(self) -> Records:
        keys = _KEYS + ([self.split_key] if self.split_id is not None else [])
        out = _select(self.val_df(), lambda r: True, keys)
        if self.split_key in keys:
            for r in out:
                r["split_id"] = self.split_id
        return out

    def predict_df(self) -> Records:
        return _select(self.record_df, lambda r: r["sample"] in self.sample, _KEYS)


class FileDataModule:
    """Zips data paths and label paths into :class:`FileData` (reference
    ``file_datamodule.py``): skips missing files with a warning; validation
    falls back to the training files; testing and prediction run over the
    data files in order, unshuffled."""

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

    def test_loader(self):
        return self._loader(self.data_files, False, "testing")

    def predict_loader(self):
        return self._loader(self.data_files, False, "prediction")
