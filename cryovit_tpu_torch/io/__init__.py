"""File I/O: HDF5 / MRC / TIFF readers and writers (pure numpy; h5py is imported only to open HDF5 files).

Replaces the reference's mrcfile/tifffile dependencies with small built-in
parsers so the framework has zero optional native deps beyond h5py.
"""

from cryovit_tpu_torch.io.hdf import FileMetadata, read_hdf, write_hdf
from cryovit_tpu_torch.io.loaders import (
    RECOGNIZED_FILE_EXTS,
    load_data,
    load_files_from_path,
    load_labels,
    match_label_keys_to_data,
)
from cryovit_tpu_torch.io.mrc import read_mrc, write_mrc
from cryovit_tpu_torch.io.tiff import read_tiff, write_tiff

__all__ = [
    "FileMetadata",
    "read_hdf",
    "write_hdf",
    "read_mrc",
    "write_mrc",
    "read_tiff",
    "write_tiff",
    "load_data",
    "load_labels",
    "load_files_from_path",
    "match_label_keys_to_data",
    "RECOGNIZED_FILE_EXTS",
]
