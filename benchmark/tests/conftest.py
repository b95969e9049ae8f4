"""Tests of the benchmark itself: ``python -m pytest benchmark/tests``.

They run on the CPU at tiny sizes, except those marked ``cuda``, which
need the card and skip without one (decided in the ``cuda_device``
fixture, never at import)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda", 0)


def tiny_cell(name: str, precision: str = "f32") -> dict:
    """``name``'s cell at a size the CPU runs in seconds: a 2-block ViT of
    width 64 (the decoder keeps its widths), tomograms of 16 and 24 slices
    of 64², crops of 16 slices of 64²."""
    from harness import files

    cell = files.cell(name)
    cfg, mix = cell["config_spec"], cell["traffic_spec"]
    cfg["precision"] = precision
    cfg.update(embed_dim=64, depth=2, num_heads=4, ffn_hidden=56, img_size=70)
    small = dict(blobs=3, radii_lo=[2, 4, 4], radii_hi=[4, 8, 8], unlabeled=2)
    if cell["entry"] == "fused_infer":
        mix.update(depths=[16, 24], copies=1, side=64, slice_batch=16, **small)
    else:
        mix.update(crops=4, depth=16, side=64, **small)
    cell["trace_units"] = 2
    return cell
