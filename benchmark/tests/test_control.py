"""The control comes out not correct on the card, at the cell's own size:
the reference with float8 operands (and float8 gradients in training) in
the program's place fails at least one of the cell's limits, on three
seeds."""

from __future__ import annotations

import json

import pytest
from conftest import BENCH

from harness import files

CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name, cuda_device):
    import run

    cell = files.cell(name)
    for seed in (2**31 + 501, 2**31 + 502, 2**31 + 503):
        out = run.run_cell(cell, seed, 0.0, False, cuda_device, control=True)
        assert not out["correct"], (seed, out["checks"])
