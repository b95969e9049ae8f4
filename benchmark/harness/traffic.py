"""The general traffic generator: seeded tomograms with blob labels, drawn on
the device, and MRC files of them. A traffic mix is a JSON file of
parameters under ``traffic/``; this module reads any of them.

``blob_volume`` follows ``chip_smoke.py:2486`` (``blob_tomogram``): bright
ellipsoid blobs (+``blob_gain``) on noise (``noise`` mean ± std), clipped
to 0..255, the blob mask as int8 labels with the first ``unlabeled`` slices
unlabeled (−1). Here it runs on the device from a ``torch.Generator``.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np
import torch


def sub_seed(seed: int, tag: int) -> int:
    """A generator seed for one purpose (``tag``) of a run's ``--seed``,
    which may be any whole number up to a little over 2**31 or more."""
    return (int(seed) * 1_000_003 + tag * 7_919 + 17) % (2**63 - 1)


def generator(seed: int, tag: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def order(seed: int, tag: int, items: list) -> list:
    """``items`` in a seeded order: every seed gets the same set of sizes."""
    rng = np.random.default_rng(sub_seed(seed, tag))
    return [items[i] for i in rng.permutation(len(items))]


def blob_volume(gen: torch.Generator, depth: int, side: int, mix: dict):
    """(uint8 volume, int8 labels) of ``depth`` × ``side``² on the
    generator's device."""
    dev = gen.device
    mean, std = mix["noise"]
    vol = torch.empty((depth, side, side), device=dev).normal_(mean, std, generator=gen)
    mask = torch.zeros((depth, side, side), dtype=torch.bool, device=dev)
    size = torch.tensor([depth, side, side], dtype=torch.float32, device=dev)
    lo_r = torch.tensor(mix["radii_lo"], dtype=torch.float32, device=dev)
    hi_r = torch.tensor(mix["radii_hi"], dtype=torch.float32, device=dev)
    n = mix["blobs"]
    centres = (torch.rand((n, 3), generator=gen, device=dev) * size).cpu().numpy()
    radii = (lo_r + torch.rand((n, 3), generator=gen, device=dev) * (hi_r - lo_r)).cpu().numpy()
    dims = (depth, side, side)
    for c, r in zip(centres, radii):
        lo = np.maximum(np.floor(c - r), 0).astype(int)
        hi = np.minimum(np.ceil(c + r) + 1, dims).astype(int)
        if np.any(hi <= lo):
            continue
        axes = [((torch.arange(lo[i], hi[i], device=dev) - float(c[i])) / float(r[i])) ** 2
                for i in range(3)]
        inside = (axes[0][:, None, None] + axes[1][None, :, None] + axes[2][None, None, :]) <= 1.0
        mask[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] |= inside
    vol = vol + mask * float(mix["blob_gain"])
    label = mask.to(torch.int8)
    label[: mix["unlabeled"]] = -1
    return vol.clamp_(0, 255).to(torch.uint8), label


def write_mrc_int8(path: Path, volume: torch.Tensor) -> None:
    """An MRC2014 file of mode 0 (signed bytes) holding ``volume`` (uint8
    0..255) shifted by −128: a 1024-byte header, no extended header, the
    data section-major (nz, ny, nx)."""
    data = (volume.to(torch.int16) - 128).to(torch.int8).cpu().numpy()
    nz, ny, nx = data.shape
    header = bytearray(1024)
    struct.pack_into("<4i", header, 0, nx, ny, nz, 0)
    struct.pack_into("<3i", header, 16, 0, 0, 0)  # nxstart, nystart, nzstart
    struct.pack_into("<3i", header, 28, nx, ny, nz)  # mx, my, mz
    struct.pack_into("<3f", header, 40, float(nx), float(ny), float(nz))  # cell
    struct.pack_into("<3i", header, 64, 1, 2, 3)  # mapc, mapr, maps
    struct.pack_into("<3f", header, 76, float(data.min()), float(data.max()), float(data.mean()))
    struct.pack_into("<i", header, 152, 20140)  # nversion
    header[208:212] = b"MAP "
    header[212:216] = b"\x44\x44\x00\x00"  # little-endian machine stamp
    with open(path, "wb") as f:
        f.write(bytes(header))
        data.tofile(f)
