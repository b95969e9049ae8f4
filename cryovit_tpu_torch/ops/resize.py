"""Separable resizes as matrix multiplies, ``out = Rh @ x @ Rwᵀ``.

Port of ``cryovit_tpu/ops/resize.py``:

- bicubic with torch ``F.interpolate`` parity (Keys cubic kernel with
  A = −0.75, half-pixel centres, clamped border taps), as in
  ``cryovit_tpu/models/fused.py:77-78``;
- linear with ``jax.image.resize(..., "linear")`` parity, the SAM2
  extractor's resize to 512² (``cryovit_tpu/run/sam_features.py:149``):
  half-pixel centres, a triangle kernel widened by the scale factor on a
  downscale (antialiasing), weights renormalised per output sample;
- linear with ``align_corners=True`` (torch ``F.interpolate``'s convention,
  the SAM2 prompt predictor's upsampling, ``cryovit_tpu/ops/resize.py``'s
  ``linear_resize_matrix(..., align_corners=True)``), under its own name:
  :func:`align_corners_resize_matrix`.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "align_corners_resize_matrix",
    "bicubic_resize_matrix",
    "linear_resize_matrix",
    "resize_bicubic_2d",
    "resize_linear_2d",
]


def _cubic_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch bicubic uses A = −0.75)."""
    at = np.abs(t)
    at2 = at * at
    at3 = at2 * at
    w = np.where(
        at <= 1.0,
        (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0,
        np.where(at < 2.0, a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a, 0.0),
    )
    return w


@lru_cache(maxsize=64)
def bicubic_resize_matrix(in_size: int, out_size: int, a: float = -0.75) -> np.ndarray:
    """Dense ``(out_size, in_size)`` resampling matrix matching torch bicubic
    (align_corners=False, half-pixel centers, clamped borders). Cached numpy;
    callers copy it to their device."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base

    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for tap in range(-1, 3):
        idx = np.clip(base + tap, 0, in_size - 1)
        w = _cubic_kernel(tap - frac, a=a)
        np.add.at(mat, (dst.astype(np.int64), idx), w)
    mat = mat.astype(np.float32)
    mat.flags.writeable = False  # shared by every caller through the cache
    return mat


_DEVICE_MATRICES: dict[tuple, torch.Tensor] = {}


def _on_device(matrix, in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """``matrix(in_size, out_size)`` as an f32 tensor on ``device``, copied
    there once (a copy from pageable host memory can stall the host until
    the device's queue drains, which a per-slice loop must not pay)."""
    key = (matrix, in_size, out_size, device)
    if key not in _DEVICE_MATRICES:
        # a normal tensor even under inference_mode, so a later train step
        # may save it for its backward
        with torch.inference_mode(False):
            _DEVICE_MATRICES[key] = torch.from_numpy(matrix(in_size, out_size).copy()).to(device)
    return _DEVICE_MATRICES[key]


def _resize_2d(x: torch.Tensor, out_h: int, out_w: int, matrix) -> torch.Tensor:
    """``Rh @ x @ Rwᵀ`` over the last two axes of ``x`` (…, H, W) in f32,
    with ``matrix(in_size, out_size)`` building each side's weights."""
    h, w = x.shape[-2], x.shape[-1]
    rh = _on_device(matrix, h, out_h, x.device)
    rw = _on_device(matrix, w, out_w, x.device)
    return torch.matmul(torch.matmul(rh, x.float()), rw.t())


def resize_bicubic_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of ``x`` (…, H, W) in f32 with torch-parity
    bicubic weights."""
    return _resize_2d(x, out_h, out_w, bicubic_resize_matrix)


@lru_cache(maxsize=64)
def linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense ``(out_size, in_size)`` f32 matrix of ``jax.image.resize``'s
    antialiased linear method: the triangle kernel ``max(0, 1 − |x|)``
    stretched by ``in/out`` when downscaling, each output's weights summed
    to 1, outputs whose sample falls outside the input zeroed. Cached
    numpy; callers copy it to their device."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)  # (in, out)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    mat = np.ascontiguousarray(np.where(inside[None, :], w, 0.0).T).astype(np.float32)
    mat.flags.writeable = False
    return mat


def resize_linear_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of ``x`` (…, H, W) in f32 with the
    antialiased linear weights of :func:`linear_resize_matrix`."""
    return _resize_2d(x, out_h, out_w, linear_resize_matrix)


@lru_cache(maxsize=64)
def align_corners_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense ``(out_size, in_size)`` f32 matrix of linear interpolation with
    aligned corners (output sample j at input ``j·(in−1)/(out−1)``; the
    identity when the sizes agree). Cached numpy; callers copy it."""
    if in_size == out_size:
        mat = np.eye(out_size, dtype=np.float32)
    else:
        dst = np.arange(out_size, dtype=np.float64)
        if out_size > 1:
            src = dst * (in_size - 1) / (out_size - 1)
        else:
            src = np.clip((dst + 0.5) * in_size / out_size - 0.5, 0, in_size - 1)
        i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        w = np.clip(src - i0, 0.0, 1.0)
        mat = np.zeros((out_size, in_size), dtype=np.float64)
        np.add.at(mat, (np.arange(out_size), i0), 1.0 - w)
        np.add.at(mat, (np.arange(out_size), i1), w)
        mat = mat.astype(np.float32)
    mat.flags.writeable = False
    return mat
