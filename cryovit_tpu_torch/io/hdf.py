"""HDF5 reading/writing with auto key detection.

Parity target: reference ``utils.py:62-143`` (recursive key walk +
"most unique values" heuristic) and ``run/dino_features.py:109-153``
(output layout: gzip ``data`` + ``labels/<k>``, fp16 ``dino_features``).

Differences from the reference: metadata scanning avoids materializing every
dataset — the unique-value count is estimated from a bounded sample for large
datasets (exact for small ones), which keeps auto-detection O(MB) instead of
O(file).

Port of ``cryovit_tpu/io/hdf.py``: the same code, with ``h5py`` imported
inside the functions that open files, so the package imports without it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import zlib
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

# Threads for parallel gzip-chunk decode (h5py holds a global lock around
# every libhdf5 call, so its built-in decompression SERIALIZES across
# threads — the pool below decompresses raw chunks with zlib, which
# releases the GIL, restoring the parallelism the reference gets from 8
# DataLoader worker processes).
_DECODE_THREADS = max(1, int(os.environ.get("CRYOVIT_DECODE_THREADS", "8")))
_decode_pool = None


def _get_decode_pool():
    global _decode_pool
    if _decode_pool is None:
        from concurrent.futures import ThreadPoolExecutor

        _decode_pool = ThreadPoolExecutor(
            max_workers=_DECODE_THREADS, thread_name_prefix="hdf-gzip"
        )
    return _decode_pool


def _unshuffle(buf: bytes, itemsize: int) -> bytes:
    """Invert the HDF5 shuffle filter (byte-transpose)."""
    arr = np.frombuffer(buf, np.uint8)
    return arr.reshape(itemsize, -1).T.tobytes()


def read_dataset(ds: h5py.Dataset) -> np.ndarray:
    """Materialize a dataset; gzip-chunked data decompresses in parallel.

    Raw compressed chunks are fetched under h5py's lock (cheap IO), then
    zlib-inflated concurrently outside it and scattered into the output
    array. Non-gzip/non-chunked datasets fall back to a plain read.
    """
    if (
        ds.compression != "gzip"
        or ds.chunks is None
        or _DECODE_THREADS <= 1
        or ds.size * ds.dtype.itemsize < (1 << 20)
    ):
        return np.asarray(ds[()])
    try:
        dsid = ds.id
        n_chunks = dsid.get_num_chunks()
        raw = []
        for i in range(n_chunks):
            info = dsid.get_chunk_info(i)
            raw.append(
                (info.chunk_offset, dsid.read_direct_chunk(info.chunk_offset)[1])
            )
    except Exception:  # pragma: no cover - esoteric layouts
        return np.asarray(ds[()])

    shape, dtype, chunk = ds.shape, ds.dtype, ds.chunks
    shuffled = bool(ds.shuffle)
    out = np.empty(shape, dtype)

    def decode(entry):
        offset, payload = entry
        buf = zlib.decompress(payload)
        if shuffled:
            buf = _unshuffle(buf, dtype.itemsize)
        block = np.frombuffer(buf, dtype).reshape(chunk)
        sel = tuple(
            slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, shape)
        )
        src = tuple(slice(0, sl.stop - sl.start) for sl in sel)
        out[sel] = block[src]

    list(_get_decode_pool().map(decode, raw))
    return out

# Datasets larger than this (elements) get their nunique estimated from a
# sample instead of a full read during key scanning.
_EXACT_NUNIQUE_LIMIT = 1 << 22


@dataclasses.dataclass
class FileMetadata:
    """Metadata for one dataset: dynamic range, shape, dtype, #unique values."""

    drange: tuple[float, float]
    dshape: tuple[int, ...]
    dtype: np.dtype
    nunique: int = 0


def _dataset_metadata(ds: h5py.Dataset) -> FileMetadata:
    if ds.size <= _EXACT_NUNIQUE_LIMIT:
        arr = ds[()]
        flat = np.asarray(arr).ravel()
    else:
        # Sample the first chunk-aligned slab; good enough to rank keys.
        head = ds[tuple(slice(0, min(s, 64)) for s in ds.shape)]
        flat = np.asarray(head).ravel()
    if flat.size == 0:
        return FileMetadata((0.0, 0.0), tuple(ds.shape), ds.dtype, 0)
    return FileMetadata(
        drange=(float(np.min(flat)), float(np.max(flat))),
        dshape=tuple(ds.shape),
        dtype=ds.dtype,
        nunique=int(len(np.unique(flat))),
    )


def _walk_datasets(group: h5py.Group, prefix: str = "") -> dict[str, h5py.Dataset]:
    import h5py

    out: dict[str, h5py.Dataset] = {}
    for key in group:
        item = group[key]
        path = f"{prefix}{key}"
        if isinstance(item, h5py.Group):
            out.update(_walk_datasets(item, prefix=f"{path}/"))
        elif isinstance(item, h5py.Dataset):
            out[path] = item
        else:
            raise ValueError(f"unknown HDF5 object at {path}: {type(item)}")
    return out


def read_hdf(
    hdf_file: str | Path, key: str | None = None
) -> tuple[str, np.ndarray, FileMetadata]:
    """Read one dataset from an HDF5 file.

    If ``key`` is None (or missing), picks the dataset with the most unique
    values — the same heuristic the reference uses to find "the data" among
    labels/masks (``utils.py:115-143``).

    Returns:
        (resolved key, data array, metadata).
    """
    import h5py

    with h5py.File(hdf_file, "r") as f:
        if key is not None:
            try:
                ds = f[key]
                if not isinstance(ds, h5py.Dataset):
                    raise KeyError(key)
                data = read_dataset(ds)
                meta = _dataset_metadata(ds)
                return key, np.asarray(data), meta
            except KeyError:
                logger.warning(
                    "Key %s not found in %s; scanning all keys instead.",
                    key,
                    hdf_file,
                )
        datasets = _walk_datasets(f)
        if not datasets:
            raise ValueError(f"{hdf_file}: no datasets found")
        metas = {k: _dataset_metadata(ds) for k, ds in datasets.items()}
        data_key = max(metas.items(), key=lambda kv: kv[1].nunique)[0]
        logger.info(
            "No key specified for %s; using '%s' (most unique values: %d).",
            hdf_file,
            data_key,
            metas[data_key].nunique,
        )
        data = read_dataset(datasets[data_key])
        return data_key, np.asarray(data), metas[data_key]


def write_hdf(
    path: str | Path,
    datasets: dict[str, np.ndarray],
    *,
    compressed_keys: tuple[str, ...] | None = None,
) -> None:
    """Write datasets to an HDF5 file.

    By default everything is gzip-compressed except float16/float32 feature
    arrays (reference writes ``dino_features`` fp16 uncompressed for read
    speed, ``run/dino_features.py:109-153``). ``compressed_keys`` overrides
    the choice explicitly.
    """
    import h5py

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        for key, arr in datasets.items():
            arr = np.asarray(arr)
            if compressed_keys is not None:
                compress = key in compressed_keys
            else:
                compress = arr.dtype not in (np.float16, np.float32)
            if compress:
                f.create_dataset(key, data=arr, compression="gzip")
            else:
                f.create_dataset(key, data=arr)
