"""Bicubic resize with torch ``F.interpolate`` parity, as matrix multiplies.

Port of ``cryovit_tpu/ops/resize.py``. The numpy matrix builders carry over
unchanged (Keys cubic kernel with A = −0.75, half-pixel centres, clamped
border taps); the resize itself is two ``torch.matmul``s,
``out = Rh @ x @ Rwᵀ``, as in ``cryovit_tpu/models/fused.py:77-78``.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["bicubic_resize_matrix", "resize_bicubic_2d"]


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


def resize_bicubic_2d(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize the last two axes of ``x`` (…, H, W) in f32 with torch-parity
    bicubic weights."""
    h, w = x.shape[-2], x.shape[-1]
    rh = torch.from_numpy(bicubic_resize_matrix(h, out_h).copy()).to(x.device)
    rw = torch.from_numpy(bicubic_resize_matrix(w, out_w).copy()).to(x.device)
    return torch.matmul(torch.matmul(rh, x.float()), rw.t())
