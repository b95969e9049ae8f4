"""High-level data/label loading across HDF5/MRC/TIFF.

Parity target: reference ``utils.py:186-329`` (``load_data``,
``load_labels``/``_match_label_keys_to_data``, ``load_files_from_path``).
Semantics preserved exactly:

- integer volumes (u)int8/16 are normalized to float32 / 255,
- a leading channel axis is added to 3D volumes (kept channels-FIRST here at
  the file boundary; the data pipeline converts to channels-last),
- label instance values map to named binary masks in ascending-value order,
  with −1 preserved as "unlabeled" and optional implicit background-0.

Port of ``cryovit_tpu/io/loaders.py`` (pure numpy, unchanged).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from cryovit_tpu_torch.io.hdf import FileMetadata, read_hdf
from cryovit_tpu_torch.io.mrc import read_mrc
from cryovit_tpu_torch.io.tiff import read_tiff

logger = logging.getLogger(__name__)

RECOGNIZED_FILE_EXTS = [".h5", ".hdf", ".hdf5", ".mrc", ".mrcs", ".tiff", ".tif"]
# The subset used for directory globbing (reference config.py:15).
TOMOGRAM_EXTS = [".hdf", ".mrc"]

_HDF_EXTS = (".h5", ".hdf", ".hdf5")
_MRC_EXTS = (".mrc", ".mrcs")
_TIFF_EXTS = (".tiff", ".tif")


def _metadata_of(data: np.ndarray) -> FileMetadata:
    return FileMetadata(
        drange=(float(np.min(data)), float(np.max(data))),
        dshape=tuple(data.shape),
        dtype=data.dtype,
        nunique=int(len(np.unique(data))),
    )


def load_data(
    file_path: str | Path, key: str | None = None
) -> tuple[np.ndarray, str]:
    """Load a volume from .h5/.hdf/.hdf5/.mrc/.mrcs/.tiff/.tif.

    Returns ``(data, key_used)`` where integer input is rescaled to
    float32 in [0, 1] and 3D volumes gain a leading channel axis
    (reference ``utils.py:186-225``).
    """
    file_path = Path(file_path)
    if not file_path.exists():
        raise FileNotFoundError(f"File {file_path} does not exist.")
    found_key = ""
    suffix = file_path.suffix.lower()
    if suffix in _HDF_EXTS:
        found_key, data, meta = read_hdf(file_path, key=key)
    elif suffix in _MRC_EXTS:
        data = read_mrc(file_path)
        meta = _metadata_of(data)
    elif suffix in _TIFF_EXTS:
        data = read_tiff(file_path)
        meta = _metadata_of(data)
    else:
        raise ValueError(
            f"Unsupported file format {file_path}; supported: {RECOGNIZED_FILE_EXTS}"
        )

    if meta.dtype in (np.uint8, np.int8, np.uint16, np.int16):
        data = data.astype(np.float32) / 255.0
    if data.ndim == 3:
        data = data[np.newaxis, ...]
    return data, found_key


def match_label_keys_to_data(
    data: np.ndarray, label_keys: list[str], metadata: FileMetadata
) -> dict[str, np.ndarray]:
    """Map instance-mask values to named binary labels (ascending order).

    −1 voxels stay −1 (ignore); non-matching values become 0; matching
    values become 1. Handles an implicit background 0 not listed in
    ``label_keys`` (reference ``utils.py:228-254``).
    """
    labels: dict[str, np.ndarray] = {}
    unique_vals = np.unique(data).tolist()
    nunique = metadata.nunique if metadata.drange[0] >= 0 else metadata.nunique - 1
    if nunique == len(label_keys):
        label_values = sorted(v for v in unique_vals if v != -1) if metadata.drange[0] < 0 else sorted(unique_vals)
    elif nunique == len(label_keys) + 1 and 0 in unique_vals:
        logger.debug("Assuming 0 is an implicit background class in label data.")
        label_values = sorted(v for v in unique_vals if v > 0)
    else:
        raise ValueError(
            f"Number of unique label values ({nunique}, ignoring -1) does "
            f"not match number of provided label keys ({len(label_keys)})."
        )
    for value, key in zip(label_values, label_keys, strict=True):
        out = np.where((data != value) & (data != -1), 0, data)
        labels[key] = np.where(out == value, 1, out).astype(np.int8)
    return labels


def load_labels(
    file_path: str | Path, label_keys: list[str], key: str | None
) -> dict[str, np.ndarray]:
    """Load named binary label volumes (reference ``utils.py:257-301``)."""
    assert key is None or key in label_keys, (
        f"Label key {key} must be one of {label_keys} or None."
    )
    file_path = Path(file_path)
    if not file_path.exists():
        raise FileNotFoundError(f"File {file_path} does not exist.")
    suffix = file_path.suffix.lower()
    labels: dict[str, np.ndarray] = {}
    if suffix in _HDF_EXTS:
        _, data, _ = read_hdf(file_path, key=key)
        if len(label_keys) > 1:
            # recompute exact metadata: read_hdf samples nunique for large
            # datasets (fine for key ranking, wrong for label matching)
            labels.update(
                match_label_keys_to_data(data, label_keys, _metadata_of(data))
            )
        else:
            labels[key if key is not None else label_keys[0]] = data.astype(np.int8)
    elif suffix in _MRC_EXTS:
        data = read_mrc(file_path)
        labels.update(match_label_keys_to_data(data, label_keys, _metadata_of(data)))
    elif suffix in _TIFF_EXTS:
        data = read_tiff(file_path)
        labels.update(match_label_keys_to_data(data, label_keys, _metadata_of(data)))
    else:
        raise ValueError(
            f"Unsupported file format {file_path}; supported: {RECOGNIZED_FILE_EXTS}"
        )
    return labels


def load_files_from_path(path: str | Path) -> list[Path]:
    """List tomogram files from a directory (recursive, by extension) or a
    .txt manifest (reference ``utils.py:304-329``)."""
    path = Path(path)
    if path.is_dir():
        file_paths = sorted(f for f in path.rglob("*") if f.suffix in TOMOGRAM_EXTS)
    elif path.is_file() and path.suffix == ".txt":
        with open(path) as f:
            file_paths = [Path(line.strip()) for line in f if line.strip()]
    else:
        raise ValueError(
            "Data path must be a directory or a .txt file listing data files."
        )
    assert len(file_paths) > 0, f"No valid tomogram files found in {path}."
    return file_paths
