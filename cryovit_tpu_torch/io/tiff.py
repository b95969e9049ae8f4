"""Minimal pure-numpy TIFF reader/writer (grayscale, uncompressed).

Replaces the reference's ``tifffile`` dependency (``utils.py:166-183``) for
the formats that matter to tomogram/label stacks: single- or multi-page
baseline TIFF, one sample per pixel, strip-based, compression=1 (none),
uint8/16/32, int8/16/32, float32/64, both byte orders.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_TAG_WIDTH = 256
_TAG_LENGTH = 257
_TAG_BITS = 258
_TAG_COMPRESSION = 259
_TAG_STRIP_OFFSETS = 273
_TAG_SAMPLES_PER_PIXEL = 277
_TAG_ROWS_PER_STRIP = 278
_TAG_STRIP_COUNTS = 279
_TAG_SAMPLE_FORMAT = 339

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 6: 1, 8: 2, 9: 4, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d"}


def _read_ifd_entries(buf: bytes, offset: int, bo: str):
    (count,) = struct.unpack_from(bo + "H", buf, offset)
    entries = {}
    pos = offset + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(bo + "HHI", buf, pos)
        if typ in _TYPE_FMT:
            size = _TYPE_SIZE[typ] * n
            if size <= 4:
                raw = buf[pos + 8 : pos + 8 + size]
            else:
                (ptr,) = struct.unpack_from(bo + "I", buf, pos + 8)
                raw = buf[ptr : ptr + size]
            vals = struct.unpack(bo + str(n) + _TYPE_FMT[typ], raw)
            entries[tag] = vals
        pos += 12
    (next_ifd,) = struct.unpack_from(bo + "I", buf, pos)
    return entries, next_ifd


def _page_dtype(bits: int, sample_format: int, bo: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}.get(sample_format, "u")
    return np.dtype(f"{bo}{kind}{bits // 8}")


def read_tiff(path: str | Path) -> np.ndarray:
    """Read a grayscale TIFF → 2D ``(H, W)`` or 3D ``(pages, H, W)`` array."""
    buf = Path(path).read_bytes()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError(f"{path}: not a TIFF file")
    (magic,) = struct.unpack_from(bo + "H", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: unsupported TIFF magic {magic} (bigtiff?)")
    (ifd_offset,) = struct.unpack_from(bo + "I", buf, 4)

    pages = []
    while ifd_offset:
        tags, ifd_offset = _read_ifd_entries(buf, ifd_offset, bo)
        width = tags[_TAG_WIDTH][0]
        length = tags[_TAG_LENGTH][0]
        bits = tags.get(_TAG_BITS, (8,))[0]
        compression = tags.get(_TAG_COMPRESSION, (1,))[0]
        spp = tags.get(_TAG_SAMPLES_PER_PIXEL, (1,))[0]
        sample_format = tags.get(_TAG_SAMPLE_FORMAT, (1,))[0]
        if compression != 1:
            raise ValueError(f"{path}: compressed TIFF not supported (compression={compression})")
        if spp != 1:
            raise ValueError(f"{path}: only 1 sample/pixel supported, got {spp}")
        offsets = tags[_TAG_STRIP_OFFSETS]
        counts = tags.get(_TAG_STRIP_COUNTS)
        if counts is None:
            counts = (width * length * (bits // 8),)
        raw = b"".join(buf[o : o + c] for o, c in zip(offsets, counts))
        dtype = _page_dtype(bits, sample_format, bo)
        page = np.frombuffer(raw, dtype=dtype, count=width * length)
        pages.append(page.reshape(length, width).astype(dtype.newbyteorder("=")))

    if not pages:
        raise ValueError(f"{path}: TIFF contains no pages")
    if len(pages) == 1:
        return pages[0]
    return np.stack(pages)


def write_tiff(path: str | Path, data: np.ndarray) -> None:
    """Write a 2D or 3D grayscale array as an uncompressed multi-page TIFF."""
    data = np.asarray(data)
    if data.ndim == 2:
        data = data[None]
    if data.ndim != 3:
        raise ValueError(f"TIFF writer expects 2D/3D data, got {data.shape}")
    dt = np.dtype(data.dtype)
    sample_format = {"u": 1, "i": 2, "f": 3}[dt.kind]
    bits = dt.itemsize * 8

    npages, length, width = data.shape
    out = bytearray()
    out += b"II*\x00"
    out += struct.pack("<I", 8)  # first IFD right after header

    ntags = 8
    ifd_size = 2 + ntags * 12 + 4
    pos = 8
    page_bytes = length * width * dt.itemsize
    for p in range(npages):
        data_offset = pos + ifd_size
        next_ifd = data_offset + page_bytes if p + 1 < npages else 0
        ifd = struct.pack("<H", ntags)
        for tag, typ, n, val in [
            (_TAG_WIDTH, 4, 1, width),
            (_TAG_LENGTH, 4, 1, length),
            (_TAG_BITS, 3, 1, bits),
            (_TAG_COMPRESSION, 3, 1, 1),
            (_TAG_STRIP_OFFSETS, 4, 1, data_offset),
            (_TAG_ROWS_PER_STRIP, 4, 1, length),
            (_TAG_STRIP_COUNTS, 4, 1, page_bytes),
            (_TAG_SAMPLE_FORMAT, 3, 1, sample_format),
        ]:
            ifd += struct.pack("<HHI", tag, typ, n) + struct.pack("<I", val)
        ifd += struct.pack("<I", next_ifd)
        out += ifd
        out += data[p].astype(dt.newbyteorder("<")).tobytes()
        pos = next_ifd if next_ifd else pos

    Path(path).write_bytes(bytes(out))
