"""Image helpers of the PCA maps that need no plotting or imaging package.

- :func:`rgb_to_hsv` / :func:`hsv_to_rgb`: numpy copies of
  ``matplotlib.colors``' conversions, operation for operation (the input is
  promoted to at least f32, as there). Where the three channels are equal
  the hue is undefined; the copy gives 0 there, as matplotlib does, and
  where two channels tie for the largest the later one (blue over green
  over red) sets the hue, as matplotlib's assignment order does.
- :func:`resize_bicubic_uint8`: Pillow's ``Image.resize`` with its default
  bicubic filter on an 8-bit image, bit for bit: the same coefficients
  (a = −0.5, support 2 scaled on a downscale), rounded to 22-bit fixed point,
  a horizontal pass then a vertical pass, each rounding to uint8.
- :func:`write_png` / :func:`read_png`: 8-bit RGB PNGs with the standard
  library's ``zlib`` and ``struct`` (every row written with filter 0; the
  reader takes only that filter, what :func:`write_png` writes).
"""

from __future__ import annotations

import math
import struct
import zlib
from pathlib import Path

import numpy as np

__all__ = ["hsv_to_rgb", "read_png", "resize_bicubic_uint8", "rgb_to_hsv", "write_png"]


def rgb_to_hsv(arr: np.ndarray) -> np.ndarray:
    """``(..., 3)`` RGB in [0, 1] → HSV in [0, 1] (``matplotlib.colors.rgb_to_hsv``)."""
    arr = np.asarray(arr)
    if arr.shape[-1] != 3:
        raise ValueError(f"Last dimension of input array must be 3; shape {arr.shape} was found.")
    in_shape = arr.shape
    arr = np.array(arr, dtype=np.promote_types(arr.dtype, np.float32), ndmin=2)
    out = np.zeros_like(arr)
    arr_max = arr.max(-1)
    if np.any(arr_max > 1) or arr.min() < 0:
        raise ValueError("Input array must be in the range [0, 1].")
    ipos = arr_max > 0
    delta = np.ptp(arr, -1)
    s = np.zeros_like(delta)
    s[ipos] = delta[ipos] / arr_max[ipos]
    ipos = delta > 0
    idx = (arr[..., 0] == arr_max) & ipos  # red is max
    out[idx, 0] = (arr[idx, 1] - arr[idx, 2]) / delta[idx]
    idx = (arr[..., 1] == arr_max) & ipos  # green is max
    out[idx, 0] = 2.0 + (arr[idx, 2] - arr[idx, 0]) / delta[idx]
    idx = (arr[..., 2] == arr_max) & ipos  # blue is max
    out[idx, 0] = 4.0 + (arr[idx, 0] - arr[idx, 1]) / delta[idx]
    out[..., 0] = (out[..., 0] / 6.0) % 1.0
    out[..., 1] = s
    out[..., 2] = arr_max
    return out.reshape(in_shape)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``(..., 3)`` HSV in [0, 1] → RGB in [0, 1] (``matplotlib.colors.hsv_to_rgb``)."""
    hsv = np.asarray(hsv)
    if hsv.shape[-1] != 3:
        raise ValueError(f"Last dimension of input array must be 3; shape {hsv.shape} was found.")
    in_shape = hsv.shape
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32), ndmin=2)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    for sector, (rr, gg, bb) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                           (p, q, v), (t, p, v), (v, p, q))):
        idx = i % 6 == 0 if sector == 0 else i == sector
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    idx = s == 0
    r[idx], g[idx], b[idx] = v[idx], v[idx], v[idx]
    return np.stack([r, g, b], axis=-1).reshape(in_shape)


# ---- Pillow's bicubic resize of 8-bit images ----------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per output
    sample its first input index, tap count and 22-bit fixed-point weights."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    xmins = np.zeros(out_size, np.int64)
    counts = np.zeros(out_size, np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        w = w * (1 << _PRECISION_BITS)
        kk[xx, :xmax] = np.trunc(np.where(w < 0, w - 0.5, w + 0.5)).astype(np.int64)
        xmins[xx], counts[xx] = xmin, xmax
    return xmins, counts, kk


def _resample_rows(img: np.ndarray, out_size: int) -> np.ndarray:
    """One pass along axis 0 of a uint8 ``(n, m)`` image, rounded to uint8."""
    xmins, counts, kk = _coefficients(img.shape[0], out_size)
    src = img.astype(np.int64)
    out = np.empty((out_size, img.shape[1]), np.uint8)
    for yy in range(out_size):
        n = counts[yy]
        acc = (1 << (_PRECISION_BITS - 1)) + kk[yy, :n] @ src[xmins[yy]:xmins[yy] + n]
        out[yy] = np.clip(acc >> _PRECISION_BITS, 0, 255)
    return out


def resize_bicubic_uint8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """A uint8 ``(H, W)`` image resized to ``(height, width)`` as Pillow's
    ``Image.resize((width, height))`` with its default (bicubic) filter
    gives it: the horizontal pass first, where the width changes, then the
    vertical one."""
    img = np.asarray(img, dtype=np.uint8)
    if img.shape[1] != width:
        img = _resample_rows(img.T, width).T
    if img.shape[0] != height:
        img = _resample_rows(img, height)
    return np.ascontiguousarray(img)


# ---- PNG ----------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str | Path, rgb: np.ndarray, level: int = 6) -> Path:
    """Write a uint8 ``(H, W, 3)`` image as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    path = Path(path)
    path.write_bytes(_PNG_SIGNATURE
                     + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                     + _chunk(b"IEND", b""))
    return path


def read_png(path: str | Path) -> np.ndarray:
    """An 8-bit RGB PNG whose rows all use filter 0 (what :func:`write_png`
    writes) → uint8 ``(H, W, 3)``."""
    buf = Path(path).read_bytes()
    if buf[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: read_png takes 8-bit RGB without interlace")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: read_png takes rows with filter 0 only")
    return rows[:, 1:].reshape(h, w, 3).copy()
