"""Host-side datasets: one item = one whole tomogram (numpy).

Port of ``cryovit_tpu/data/datasets.py`` (:func:`random_crop` and the
CLI-mode :class:`FileDataset`, reference ``datasets/file_dataset.py``).
Arrays are returned channels-last ``(D, H, W, C)``; the HDF5 files stay
channels-first for compatibility with the reference. The experiment-mode
``TomoDataset`` and the feature-extraction ``VITDataset`` (pandas) are not
ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np

from cryovit_tpu_torch.io import load_data, load_labels
from cryovit_tpu_torch.types import FileData, TomogramData

__all__ = ["FileDataset", "random_crop"]

MAX_CROP_DEPTH = 128
FEATURE_CROP_SIDE = 32
VOXEL_CROP_SIDE = 512
FEATURE_STRIDE = 16  # one DINO patch covers 16 voxels


def random_crop(
    data: np.ndarray,
    label: np.ndarray,
    *,
    feature_space: bool,
    rng: np.random.Generator | None = None,
    max_depth: int = MAX_CROP_DEPTH,
) -> tuple[np.ndarray, np.ndarray]:
    """Random train-time crop (reference ``tomo_dataset.py:148-178``).

    ``data`` is channels-last ``(D, H, W, C)``; ``label`` is ``(D, LH, LW)``
    at voxel resolution. In feature space the crop side is 32 patches and
    label coordinates scale by 16. The draws are the JAX package's, in its
    order, so the same generator state gives the same crop.
    """
    rng = rng or np.random.default_rng()
    side = FEATURE_CROP_SIDE if feature_space else VOXEL_CROP_SIDE
    d, h, w = data.shape[:3]
    x, y, z = min(d, max_depth), side, side
    if (d, h, w) == (x, y, z):
        return data, label

    di = rng.integers(d - x + 1) if d > x else 0
    hi = rng.integers(h - y + 1) if h > y else 0
    wi = rng.integers(w - z + 1) if w > z else 0

    data = data[di : di + x, hi : hi + y, wi : wi + z]
    if feature_space:
        hi, wi, y, z = (v * FEATURE_STRIDE for v in (hi, wi, y, z))
    label = label[di : di + x, hi : hi + y, wi : wi + z]
    return data, label


def _to_channels_last(arr: np.ndarray, key: str) -> np.ndarray:
    """File layout → channels-last. Features ``(C, D, h, w)`` →
    ``(D, h, w, C)``; volumes ``(D, H, W)`` → ``(D, H, W, 1)``."""
    if arr.ndim == 4:  # channels-first feature volume
        return np.ascontiguousarray(np.moveaxis(arr, 0, -1))
    if arr.ndim == 3:
        return arr[..., np.newaxis]
    raise ValueError(f"unexpected rank for {key}: {arr.shape}")


class FileDataset:
    """CLI-mode loader from explicit file paths (reference ``file_dataset.py``).

    :meth:`_load` reads the input (``input_key``, e.g. ``dino_features``)
    and the ``label_key`` label of one file, :meth:`_load_raw` its raw
    volume; :meth:`__getitem__` turns them into a channels-last record,
    randomly cropped when ``train``.
    """

    def __init__(
        self,
        files: list[FileData],
        input_key: str | None,
        label_key: str | None,
        train: bool = False,
        seed: int | None = None,
        max_crop_depth: int = MAX_CROP_DEPTH,
    ) -> None:
        self.files = files
        self.input_key = input_key
        self.label_key = label_key
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.max_crop_depth = int(max_crop_depth)
        self._key_cache: dict[Path, str] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, fd: FileData) -> tuple[np.ndarray, np.ndarray]:
        """``(data (C, D, H, W) f32, label (D, H, W))`` of one file."""
        if fd.tomo_path in self._key_cache:
            data, _ = load_data(fd.tomo_path, key=self._key_cache[fd.tomo_path])
        else:
            data, key = load_data(fd.tomo_path, key=self.input_key)
            self._key_cache[fd.tomo_path] = key
        data = np.asarray(data, dtype=np.float32)

        if fd.label_path is not None and fd.labels is not None:
            labels = load_labels(fd.label_path, label_keys=fd.labels, key=self.label_key)
            label = labels[self.label_key]
        else:
            label = np.zeros(data.shape[-3:], dtype=np.int8)
        return data, label

    def _load_raw(self, fd: FileData) -> np.ndarray:
        """The raw ``(D, H, W)`` volume (the file's ``data``)."""
        return load_data(fd.tomo_path, key="data")[0][0]

    def __getitem__(self, idx: int) -> TomogramData:
        if idx >= len(self):
            raise IndexError(idx)
        fd = self.files[idx]
        data, label = self._load(fd)

        aux: dict[str, Any] = {}
        data_cl = _to_channels_last(
            data[0] if data.ndim == 4 and data.shape[0] == 1 else data,
            self.input_key or "data",
        )
        if self.train:
            data_cl, label = random_crop(
                data_cl,
                label,
                feature_space=self.input_key == "dino_features",
                max_depth=self.max_crop_depth,
                rng=self.rng,
            )
        else:
            # the raw volume rides along for writers and visualisation
            aux["data"] = data[0] if self.input_key == "data" else self._load_raw(fd)

        return TomogramData(
            sample=fd.sample or "",
            tomo_name=fd.tomo_path.name,
            split_id=None,
            data=data_cl,
            label=label,
            aux_data=aux or None,
        )
