"""Plain fused segmentation of one tomogram file for the benchmark's check:
the MRC file read with numpy, integer voxels scaled by 1/255, slices
edge-padded to multiples of 16 and resized by 14/16 (bicubic,
``F.interpolate``), DINOv2 patch features, then the CryoVIT decoder:
float32, TF32 off, the slices in chunks.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from reference.train import float32_exact

_MODES = {0: np.int8, 1: np.int16, 2: np.float32, 6: np.uint16}


def read_mrc(path: Path) -> np.ndarray:
    """``(nz, ny, nx)`` of a little-endian MRC2014 file of mode 0, 1, 2 or 6."""
    with open(path, "rb") as f:
        header = f.read(1024)
        nx, ny, nz, mode = struct.unpack("<4i", header[:16])
        (ext,) = struct.unpack("<i", header[92:96])
        f.seek(1024 + ext)
        data = np.fromfile(f, dtype=_MODES[mode], count=nx * ny * nz)
    return data.reshape(nz, ny, nx)


def normalized(volume: np.ndarray) -> np.ndarray:
    """Integer voxels scaled by 1/255 (the reference's ``load_data``)."""
    if volume.dtype.kind in "iu":
        return volume.astype(np.float32) / 255.0
    return volume.astype(np.float32)


@torch.no_grad()
def segment(path: Path, backbone, decoder, device, chunk: int = 8) -> np.ndarray:
    """``(D, H, W)`` probabilities of the tomogram in ``path``."""
    vol = normalized(read_mrc(path))
    d, h, w = vol.shape
    ph, pw = -h % 16, -w % 16
    vol = np.pad(vol, ((0, 0), (0, ph), (0, pw)), mode="edge")
    gh, gw = vol.shape[1] // 16, vol.shape[2] // 16
    p = backbone.cfg["patch_size"]
    feats = []
    with float32_exact():
        for s in range(0, d, chunk):
            x = torch.from_numpy(vol[s:s + chunk]).to(device)
            x = F.interpolate(x[:, None], size=(gh * p, gw * p), mode="bicubic",
                              align_corners=False)[:, 0]
            feats.append(backbone(x))
        f = torch.cat(feats).reshape(d, gh, gw, -1).permute(3, 0, 1, 2)[None]
        del feats
        probs = decoder(f)[0]
    return probs[:, :h, :w].cpu().numpy()
