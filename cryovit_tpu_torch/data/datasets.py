"""Host-side datasets: one item = one whole tomogram (numpy).

Port of ``cryovit_tpu/data/datasets.py``: :func:`random_crop`, the
experiment-mode :class:`TomoDataset` (reference ``datasets/tomo_dataset.py``)
over the records of a split datamodule, the CLI-mode :class:`FileDataset`
(reference ``datasets/file_dataset.py``) and the feature-extraction
:class:`VITDataset` (reference ``datasets/vit_dataset.py``). Arrays are
returned channels-last ``(D, H, W, C)``; the HDF5 files stay channels-first
for compatibility with the reference. Raw voxels (``input_key: data``,
UNet3D and SAM2) are read as they are, with no padding to a multiple; with
``aux_keys=("sam_features",)`` an HDF5 file's cached SAM2 pyramids ride
along in ``aux_data``. Each dataset reads its files in one method
(``TomoDataset._read``, ``FileDataset._load``), the only place that opens
HDF5.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from cryovit_tpu_torch.data.transforms import pad_slices_to_multiple
from cryovit_tpu_torch.io import load_data, load_labels
from cryovit_tpu_torch.types import FileData, TomogramData

logger = logging.getLogger(__name__)

__all__ = ["FileDataset", "TomoDataset", "VITDataset", "random_crop"]

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


_HDF_SUFFIXES = (".h5", ".hdf", ".hdf5")


def _read_sam_features(path: Path) -> dict[str, list[np.ndarray]] | None:
    """The ``sam_features/{backbone_fpn,vision_pos_enc}/<level>`` pyramids
    of an HDF5 file (per level ``(D, C, h, w)``, reference
    ``tomo_dataset.py:128-144``), or None when the file has none."""
    if Path(path).suffix.lower() not in _HDF_SUFFIXES:
        return None
    import h5py

    with h5py.File(path, "r") as f:
        if "sam_features" not in f:
            return None
        grp = f["sam_features"]
        return {name: [np.asarray(grp[name][str(i)][()]) for i in range(len(grp[name]))]
                for name in grp}


def _to_channels_last(arr: np.ndarray, key: str) -> np.ndarray:
    """File layout → channels-last. Features ``(C, D, h, w)`` →
    ``(D, h, w, C)``; volumes ``(D, H, W)`` → ``(D, H, W, 1)``."""
    if arr.ndim == 4:  # channels-first feature volume
        return np.ascontiguousarray(np.moveaxis(arr, 0, -1))
    if arr.ndim == 3:
        return arr[..., np.newaxis]
    raise ValueError(f"unexpected rank for {key}: {arr.shape}")


class TomoDataset:
    """Experiment-mode loader over ``data_root/<sample>/<tomo_name>`` HDF5
    (reference ``tomo_dataset.py``): one record of a split datamodule → the
    file's ``input_key`` (uint8 scaled to f32 / 255), its
    ``labels/<label_key>`` as int8 and its ``aux_keys`` (cached SAM2
    pyramids under ``sam_features``), channels-last, randomly cropped when
    ``train`` (from the dataset's own ``default_rng(seed)``), with the
    record's ``split_key`` as ``split_id``."""

    def __init__(
        self,
        records: list[dict[str, Any]],
        input_key: str,
        label_key: str,
        data_root: str | Path,
        train: bool = False,
        aux_keys: Sequence[str] = (),
        split_key: str | None = None,
        seed: int | None = None,
        max_crop_depth: int = MAX_CROP_DEPTH,
    ) -> None:
        self.records = list(records)
        self.input_key = input_key
        self.label_key = label_key
        self.data_root = Path(data_root)
        self.train = train
        self.aux_keys = list(aux_keys or [])
        self.split_key = split_key
        self.rng = np.random.default_rng(seed)
        self.max_crop_depth = int(max_crop_depth)

    def __len__(self) -> int:
        return len(self.records)

    def _read(self, tomo_path: Path) -> tuple[np.ndarray, np.ndarray, dict[str, Any]]:
        """``(input, int8 label, aux)`` of one training-ready HDF5 file: the
        HDF5 layer of the dataset."""
        import h5py

        from cryovit_tpu_torch.io.hdf import read_dataset

        with h5py.File(tomo_path, "r") as f:
            if self.input_key not in f:
                raise KeyError(f"{tomo_path}: missing input key {self.input_key!r}")
            label_path = f"labels/{self.label_key}"
            if label_path not in f:
                raise KeyError(f"{tomo_path}: missing label key {label_path!r}")
            data = np.asarray(read_dataset(f[self.input_key]))
            label = np.asarray(read_dataset(f[label_path])).astype(np.int8)
            aux: dict[str, Any] = {}
            for key in self.aux_keys:
                if key == "sam_features" and key in f:
                    # cached SAM pyramids: {backbone_fpn, vision_pos_enc} →
                    # per-level (D, C, h, w) arrays (reference
                    # tomo_dataset.py:128-144)
                    grp = f[key]
                    aux[key] = {
                        name: [np.asarray(grp[name][str(i)][()]) for i in range(len(grp[name]))]
                        for name in grp
                    }
                elif key in f:
                    aux[key] = np.asarray(f[key][()])
                else:
                    logger.warning("%s: aux key %s missing", tomo_path, key)
        return data, label, aux

    def __getitem__(self, idx: int) -> TomogramData:
        if idx >= len(self):
            raise IndexError(idx)
        row = self.records[idx]
        tomo_path = self.data_root / str(row["sample"]) / str(row["tomo_name"])
        data, label, aux = self._read(tomo_path)

        if data.dtype == np.uint8:
            data = data.astype(np.float32) / 255.0
        data = _to_channels_last(np.asarray(data, dtype=np.float32), self.input_key)

        if self.train:
            data, label = random_crop(
                data,
                label,
                feature_space=self.input_key == "dino_features",
                rng=self.rng,
                max_depth=self.max_crop_depth,
            )

        split_id = (
            int(row[self.split_key]) if self.split_key and self.split_key in row else None
        )
        return TomogramData(
            sample=str(row["sample"]),
            tomo_name=str(row["tomo_name"]),
            split_id=split_id,
            data=data,
            label=label,
            aux_data=aux or None,
        )


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
        aux_keys: tuple[str, ...] = (),
    ) -> None:
        self.files = files
        self.aux_keys = tuple(aux_keys)
        self.input_key = input_key
        self.label_key = label_key
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.max_crop_depth = int(max_crop_depth)
        self._key_cache: dict[Path, str] = {}

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, fd: FileData) -> tuple[np.ndarray, np.ndarray | None]:
        """``(data (C, D, H, W) f32, label (D, H, W))`` of one file; the
        label is None when the file has no label file."""
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
            label = None
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
        if "sam_features" in self.aux_keys:
            cached = _read_sam_features(fd.tomo_path)
            if cached is not None:
                aux["sam_features"] = cached
        data_cl = _to_channels_last(
            data[0] if data.ndim == 4 and data.shape[0] == 1 else data,
            self.input_key or "data",
        )
        if self.train:
            if label is None:
                label = np.zeros(data.shape[-3:], dtype=np.int8)
            full = data_cl.shape
            data_cl, label = random_crop(
                data_cl,
                label,
                feature_space=self.input_key == "dino_features",
                max_depth=self.max_crop_depth,
                rng=self.rng,
            )
            if data_cl.shape != full:  # cached pyramids describe the whole volume
                aux.pop("sam_features", None)
        else:
            # the raw volume rides along for writers and visualisation
            aux["data"] = data[0] if self.input_key == "data" else self._load_raw(fd)
            if label is None:
                # no labels: zeros on the raw volume's voxel grid, to which
                # the predictions are cropped. The JAX package takes the
                # input's grid, which for features is the patch grid and
                # crops the masks to it (ROADMAP.md C4).
                label = np.zeros(aux["data"].shape, dtype=np.int8)

        return TomogramData(
            sample=fd.sample or "",
            tomo_name=fd.tomo_path.name,
            split_id=None,
            data=data_cl,
            label=label,
            aux_data=aux or None,
        )


class VITDataset:
    """Feature-extraction loader (experiment mode): reads only the raw
    ``data`` volume of ``data_root/<sample>/<tomo_name>`` (reference
    ``vit_dataset.py``), edge-padded to a multiple of 16 unless ``use_sam``;
    normalisation and the 14/16 resize run on the device, as in the JAX
    package, which always normalises (the reference builds an ImageNet
    ``Normalize`` here but never applies it)."""

    def __init__(
        self,
        records: list[dict[str, Any]],
        data_root: str | Path,
        use_sam: bool = False,
        **_: Any,
    ) -> None:
        self.records = list(records)
        self.data_root = Path(data_root)
        self.use_sam = use_sam

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> TomogramData:
        if idx >= len(self):
            raise IndexError(idx)
        row = self.records[idx]
        tomo_path = self.data_root / str(row["sample"]) / str(row["tomo_name"])
        data, _ = load_data(tomo_path, key="data")
        raw = data[0]  # (D, H, W) f32
        stack = raw if self.use_sam else pad_slices_to_multiple(raw)
        return TomogramData(
            sample=str(row["sample"]),
            tomo_name=str(row["tomo_name"]),
            split_id=None,
            data=stack[..., np.newaxis].astype(np.float32),
            label=np.zeros(stack.shape, dtype=np.int8),
            aux_data={"data": raw},
        )
