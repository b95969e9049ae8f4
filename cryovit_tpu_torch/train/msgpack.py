"""A reader for the flax msgpack the JAX package writes: its
``weights.msgpack`` and the weights inside its own ``.model``.

Standard library and numpy only: ``msgpack``, ``flax`` and ``ml_dtypes``
are not dependencies of the port. :func:`msgpack_restore` returns what
``flax.serialization.msgpack_restore`` returns for the subset that
``flax.serialization.msgpack_serialize`` writes:

- maps, arrays (as lists), str, bin, int, float, bool and nil;
- ext 1, an ndarray whose payload is the msgpack ``[shape, dtype name,
  C-order bytes]``; ext 3, a numpy scalar in the same form;
- chunked arrays (``__msgpack_chunked_array__`` dicts, written for arrays
  over 2^30 bytes), joined back as flax joins them.

Arrays come back as numpy arrays of their dtype, except bfloat16, which
numpy lacks: its uint16 bits are viewed as a ``torch.bfloat16`` tensor (a
0-d one for a scalar). Any other ext code, and a dtype that is neither
numpy's own nor bfloat16 (ml_dtypes' float8, say), is refused.

:func:`msgpack_read` reads a file through ``mmap``: a converted ViT-g is
~4.5 GB, and the file's pages then stay the page cache's, not a second copy
in the process. Every array is copied out of the encoded bytes once (a
chunked array once, by the join of its chunks' views), so the tree owns its
memory and is writable.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["msgpack_read", "msgpack_restore"]

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
# one-byte headers followed by a big-endian length or value
_LENGTHS = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",  # bin
            0xc7: ">B", 0xc8: ">H", 0xc9: ">I",  # ext
            0xd9: ">B", 0xda: ">H", 0xdb: ">I",  # str
            0xdc: ">H", 0xdd: ">I",  # array
            0xde: ">H", 0xdf: ">I"}  # map
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
# numpy's own dtypes (extension dtypes such as ml_dtypes' float8 are
# refused: numpy knows them only where ml_dtypes is installed)
_NUMPY_DTYPES = frozenset(
    ["bool", "float16", "float32", "float64", "complex64", "complex128"]
    + [f"{sign}int{bits}" for sign in ("", "u") for bits in (8, 16, 32, 64)]
)


class _Reader:
    def __init__(self, data: bytes | bytearray | memoryview, raw: bool):
        self.buf = memoryview(data).cast("B")
        self.pos = 0
        self.raw = raw  # str as bytes (flax reads an ndarray's payload so)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b <= 0x8f:
            return self._map(b & 0x0f)
        if b <= 0x9f:
            return [self.read() for _ in range(b & 0x0f)]
        if b <= 0xbf:
            return self._str(b & 0x1f)
        if b in (0xc0, 0xc2, 0xc3):
            return {0xc0: None, 0xc2: False, 0xc3: True}[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, self.take(_FIXEXT[b]))
        if b not in _LENGTHS:
            raise ValueError(f"invalid msgpack byte 0x{b:02x}")
        n = self.unpack(_LENGTHS[b])
        if b <= 0xc6:  # an ndarray's buffer (raw) stays a view until numpy copies it
            return self.take(n) if self.raw else bytes(self.take(n))
        if b <= 0xc9:
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if b <= 0xdb:
            return self._str(n)
        if b <= 0xdd:
            return [self.read() for _ in range(n)]
        return self._map(n)

    def _str(self, n: int) -> str | bytes:
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _unpackb(data, raw: bool = False) -> Any:
    reader = _Reader(data, raw)
    out = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError("extra data after the msgpack object")
    return out


def _ndarray(payload: memoryview) -> np.ndarray | torch.Tensor:
    """The array of an ext-1 payload: numpy's a read-only view of the
    encoded bytes (:func:`_own` copies it out), bfloat16 a copy."""
    shape, name, buffer = _unpackb(payload, raw=True)
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    if name not in _NUMPY_DTYPES:
        raise ValueError(f"flax msgpack array of dtype {name!r}, which numpy does not know")
    return np.frombuffer(buffer, np.dtype(name)).reshape(shape)


def _ext(code: int, payload: memoryview) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload)
    if code == _EXT_NPSCALAR:
        array = _ndarray(payload)
        return array.reshape(()) if isinstance(array, torch.Tensor) else array[()]
    raise ValueError(f"unsupported msgpack ext type {code} (flax writes 1 and 3)")


def _unchunk(data: dict) -> np.ndarray | torch.Tensor:
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _own(tree: Any) -> Any:
    """The parsed tree with its arrays copied out of the encoded bytes, in
    place: flax's ``_unchunk_array_leaves_in_place`` (chunked arrays in
    nested dicts, not in lists, joined back) and a copy of every other
    numpy array, wherever it lies."""
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        for key, value in tree.items():
            if isinstance(value, dict) and _CHUNKED in value:
                tree[key] = _unchunk(value)
            else:
                tree[key] = _own(value) if isinstance(value, (dict, list)) else _copy(value)
    elif isinstance(tree, list):
        tree[:] = [_own(v) if isinstance(v, (dict, list)) else _copy(v) for v in tree]
    return _copy(tree)


def _copy(leaf: Any) -> Any:
    return leaf.copy() if isinstance(leaf, np.ndarray) else leaf


def msgpack_restore(encoded: bytes | bytearray | memoryview) -> Any:
    """The tree ``flax.serialization.msgpack_restore(encoded)`` returns
    (arrays as numpy, bfloat16 as torch; see the module docstring)."""
    return _own(_unpackb(encoded))


def msgpack_read(path: str | Path) -> Any:
    """:func:`msgpack_restore` of the file at ``path``, read through
    ``mmap``. An empty file raises, as an empty ``encoded`` does."""
    with open(path, "rb") as f:
        if not f.seek(0, 2):
            raise ValueError(f"{path}: truncated msgpack data (empty file)")
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    # unmapped when the last view of it goes: on return, every array is a copy
    return msgpack_restore(mapped)
