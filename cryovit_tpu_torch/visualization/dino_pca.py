"""PCA colour maps of DINOv2 features (port of ``cryovit_tpu/visualization/dino_pca.py``).

Every 10th slice (or one ``frame_id``) is written as a PNG: the raw slice on
the left, the features' top three principal components on the right,
coloured with a fixed saturation and value and upscaled to voxels.

The JAX package fits ``PCA(min(1024, N, C))`` with sklearn and then, umap
being absent, ``PCA(3)`` on the reduced data. The second fit's directions
are the unit vectors of the reduced space (its components are uncorrelated
and ordered), which sklearn's sign rule makes positive, so the embedding is
the projection onto the first fit's top three directions:
``(y − mean(x)) · V[:3]ᵀ``, to rounding. Here that is computed directly on
the features' device, in float64: the ``C×C`` covariance of the centred
fit tokens, its ``torch.linalg.eigh``, each direction signed so that its
largest-magnitude entry is positive (sklearn's ``svd_flip`` with
``u_based_decision=False``). At ViT-g's width and a 64-slice tomogram
sklearn takes its randomized solver, whose result is approximate and not
repeatable; this one is exact.

Colours use the package's numpy copy of matplotlib's HSV conversions and
the PNGs its own writer (``_image.py``), so nothing here needs
matplotlib, Pillow or sklearn.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch

from cryovit_tpu_torch.config import tomogram_exts
from cryovit_tpu_torch.ops.resize import resize_bicubic_2d
from cryovit_tpu_torch.visualization._image import (
    hsv_to_rgb,
    resize_bicubic_uint8,
    rgb_to_hsv,
    write_png,
)

logger = logging.getLogger(__name__)

__all__ = ["export_pca", "fit_pca", "process_samples"]


def fit_pca(x: torch.Tensor, k: int = 3) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x (N, C)`` → ``(mean (C,), components (k, C), variances (C,))`` in
    float64 on ``x``'s device: the top ``k`` principal directions with
    sklearn's sign rule, and every explained variance, largest first."""
    x = x.double()
    mean = x.mean(dim=0)
    xc = x - mean
    evals, evecs = torch.linalg.eigh(xc.T @ xc)  # ascending
    comps = evecs[:, -k:].flip(-1).T.contiguous()
    pick = comps.abs().argmax(dim=1, keepdim=True)
    comps = comps * torch.sign(comps.gather(1, pick))
    return mean, comps, evals.flip(0) / max(x.shape[0] - 1, 1)


def _tokens(f: torch.Tensor) -> torch.Tensor:
    """``(C, D, h, w)`` → ``(D·h·w, C)``."""
    return f.permute(1, 2, 3, 0).reshape(-1, f.shape[0])


def _calculate_pca(features: torch.Tensor | np.ndarray) -> torch.Tensor:
    """``(C, D, gh, gw)`` features → ``(D, 2·gh, 2·gw, 3)`` f32 embedding on
    the features' device: fitted on the slices' tokens, applied to the
    features upsampled 2× (bicubic, f32), as the JAX package does."""
    f32 = torch.as_tensor(features).float()
    c, d, gh, gw = f32.shape
    mean, comps, _ = fit_pca(_tokens(f32))
    up = resize_bicubic_2d(f32, 2 * gh, 2 * gw)
    emb = (_tokens(up).double() - mean) @ comps.T
    return emb.float().reshape(d, 2 * gh, 2 * gw, 3)


def _color_features(features: np.ndarray, alpha: float = 0.0) -> np.ndarray:
    """Each component scaled to [0, 1], read as RGB and given saturation 0.9
    and value 0.75 in HSV, then 8×-upscaled → uint8 ``(D, 8·h, 8·w, 3)``
    (the JAX package's, with the numpy copy of matplotlib's conversions)."""
    f = features - features.min(axis=(0, 1, 2))
    f = f / np.maximum(f.max(axis=(0, 1, 2)), 1e-8)
    hsv = rgb_to_hsv(f)
    hsv[..., 1] = 0.9
    hsv[..., 2] = 0.75
    hsv[..., 0] = (alpha + hsv[..., 0]) % 1.0
    rgb = (255 * hsv_to_rgb(hsv)).astype(np.uint8)
    rgb = np.repeat(rgb, 8, axis=1)
    return np.repeat(rgb, 8, axis=2)


def export_pca(
    data: np.ndarray,
    features: torch.Tensor | np.ndarray,
    tomo_name: str,
    result_dir: Path,
    frame_id: int | None = None,
) -> list[Path]:
    """Write ``result_dir/tomo_name/<z>.png`` for every 10th slice z (or
    ``frame_id``): the raw slice of ``data (D, H, W)``, scaled to 8 bits
    over the whole volume, beside the PCA map of ``features (C, D, gh, gw)``
    (a tensor is used on its device), both flipped vertically. A raw slice
    of another size than the map's ``(16·gh, 16·gw)`` (H or W not a multiple
    of 16, which the extractor edge-pads) is resized to it as Pillow's
    default bicubic filter does. Returns the paths written."""
    image_dir = Path(result_dir) / tomo_name
    image_dir.mkdir(parents=True, exist_ok=True)
    idxs = list(range(0, data.shape[0], 10)) if frame_id is None else [frame_id]

    features = torch.as_tensor(features)
    sel = torch.as_tensor(idxs, device=features.device)
    emb = _calculate_pca(features.index_select(1, sel)).cpu().numpy()
    rgb = _color_features(emb)

    # data - data.min() scaled by its max, on the chosen slices only (the
    # max of the difference is the difference of the max: rounding is monotone)
    lo = data.min()
    span = data.max() - lo
    norm = (data[idxs] - lo) / max(span, 1e-8)
    int_data = (norm * 255.0).astype(np.uint8)

    written = []
    for i, idx in enumerate(idxs):
        f_img = rgb[i][::-1]
        d_img = int_data[i][::-1]
        if d_img.shape != f_img.shape[:2]:
            d_img = resize_bicubic_uint8(d_img, *f_img.shape[:2])
        img = np.concatenate([np.repeat(d_img[..., None], 3, axis=-1), f_img], axis=1)
        written.append(write_png(image_dir / f"{idx}.png", img))
    logger.info("saved %d PCA maps to %s", len(idxs), image_dir)
    return written


def process_samples(exp_dir: Path, result_dir: Path, sample: str | None = None,
                    device: torch.device | str | None = None) -> None:
    """PCA maps of every training-ready file (``data`` and ``dino_features``)
    of each sample directory under ``exp_dir`` → ``result_dir/<sample>/<stem>``;
    the PCA runs on ``device`` (the GPU unless the CPU is named)."""
    from cryovit_tpu_torch import resolve_device
    from cryovit_tpu_torch.io.hdf import read_hdf

    device = resolve_device(device)
    exp_dir, result_dir = Path(exp_dir), Path(result_dir)
    result_dir.mkdir(parents=True, exist_ok=True)
    sample_list = (
        [s.name for s in exp_dir.iterdir() if s.is_dir()] if sample is None else [sample]
    )
    for s in sample_list:
        for f in sorted((exp_dir / s).glob("*")):
            if f.suffix not in tomogram_exts:
                continue
            _, data, _ = read_hdf(f, key="data")
            if data.dtype == np.uint8:
                data = data.astype(np.float32) / 255.0
            _, features, _ = read_hdf(f, key="dino_features")
            export_pca(data, torch.from_numpy(features).to(device), f.stem, result_dir / s)
