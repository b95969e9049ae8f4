"""Pure-numpy MRC2014 reader/writer.

Replaces the reference's ``mrcfile`` dependency (``utils.py:146-163``) with a
self-contained parser: 1024-byte header, optional extended header, and the
section-major ``(nz, ny, nx)`` data block.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# MRC mode → numpy dtype (MRC2014 standard modes).
_MODE_TO_DTYPE = {
    0: np.dtype(np.int8),
    1: np.dtype(np.int16),
    2: np.dtype(np.float32),
    4: np.dtype(np.complex64),
    6: np.dtype(np.uint16),
    12: np.dtype(np.float16),
    101: None,  # 4-bit, unsupported
}
_DTYPE_TO_MODE = {
    np.dtype(np.int8): 0,
    np.dtype(np.int16): 1,
    np.dtype(np.float32): 2,
    np.dtype(np.uint16): 6,
    np.dtype(np.float16): 12,
    # widths we down/up-convert on write
    np.dtype(np.uint8): 6,
    np.dtype(np.float64): 2,
}

_HEADER_SIZE = 1024


def _detect_byteorder(header: bytes) -> str:
    """Return '<' or '>' from the machine stamp (bytes 212-215), with a
    sanity fallback on nx."""
    stamp = header[212:216]
    if stamp[:2] == b"\x44\x44" or stamp[:2] == b"\x44\x41":
        return "<"
    if stamp[:2] == b"\x11\x11":
        return ">"
    # Fallback: pick the byte order under which nx looks sane.
    nx_le = struct.unpack("<i", header[0:4])[0]
    nx_be = struct.unpack(">i", header[0:4])[0]
    if 0 < nx_le < 100_000_000:
        return "<"
    if 0 < nx_be < 100_000_000:
        return ">"
    return "<"


def read_mrc(path: str | Path) -> np.ndarray:
    """Read an MRC/MRCS file → ``(nz, ny, nx)`` numpy array (native order)."""
    path = Path(path)
    with open(path, "rb") as f:
        header = f.read(_HEADER_SIZE)
        if len(header) < _HEADER_SIZE:
            raise ValueError(f"{path}: truncated MRC header")
        bo = _detect_byteorder(header)
        nx, ny, nz, mode = struct.unpack(bo + "4i", header[0:16])
        nsymbt = struct.unpack(bo + "i", header[92:96])[0]
        if mode not in _MODE_TO_DTYPE or _MODE_TO_DTYPE[mode] is None:
            raise ValueError(f"{path}: unsupported MRC mode {mode}")
        dtype = _MODE_TO_DTYPE[mode].newbyteorder(bo)
        if nsymbt < 0 or nsymbt > 1 << 30:
            raise ValueError(f"{path}: bad extended header size {nsymbt}")
        f.seek(_HEADER_SIZE + nsymbt)
        count = nx * ny * nz
        data = np.fromfile(f, dtype=dtype, count=count)
        if data.size != count:
            raise ValueError(f"{path}: truncated MRC data block")
    data = data.reshape(nz, ny, nx)
    return np.ascontiguousarray(data.astype(data.dtype.newbyteorder("=")))


def write_mrc(path: str | Path, data: np.ndarray) -> None:
    """Write ``(nz, ny, nx)`` array as a minimal little-endian MRC2014 file."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError(f"MRC writer expects 2D/3D data, got {data.shape}")
    dt = np.dtype(data.dtype)
    if dt not in _DTYPE_TO_MODE:
        raise ValueError(f"unsupported dtype for MRC write: {dt}")
    mode = _DTYPE_TO_MODE[dt]
    out = data.astype(_MODE_TO_DTYPE[mode])
    nz, ny, nx = out.shape

    header = bytearray(_HEADER_SIZE)
    struct.pack_into("<4i", header, 0, nx, ny, nz, mode)
    struct.pack_into("<3i", header, 28, nx, ny, nz)  # mx, my, mz
    struct.pack_into("<3f", header, 40, float(nx), float(ny), float(nz))
    struct.pack_into("<3f", header, 52, 90.0, 90.0, 90.0)  # cell angles
    struct.pack_into("<3i", header, 64, 1, 2, 3)  # axis order
    dmin, dmax = float(out.min()), float(out.max())
    struct.pack_into("<3f", header, 76, dmin, dmax, float(out.mean()))
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"  # little-endian machine stamp
    struct.pack_into("<f", header, 216, float(out.std()))

    with open(path, "wb") as f:
        f.write(bytes(header))
        out.astype("<" + _MODE_TO_DTYPE[mode].str[1:]).tofile(f)
