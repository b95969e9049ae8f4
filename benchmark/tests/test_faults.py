"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the program's path of a tiny CPU run
(the harness's look for a card skipped), against the cell's own limits;
and the same run unbroken comes out correct. Single-chip cells have no
exchange between chips to leave out."""

from __future__ import annotations

import json

import pytest
import torch
from conftest import BENCH, tiny_cell

import run
from harness import files

# the faults each entry can have: one slice's answer altered where it is
# produced; a step that returns its state unchanged; half of the crop left
# out of the loss
ENTRY_FAULTS = {"fused_infer": ("altered_answer",),
                "train_step": ("unchanged_state", "half_batch")}
CELLS = [w["name"] for w in json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
FAULTS = [(c, f) for c in CELLS for f in ENTRY_FAULTS[files.cell(c)["entry"]]]


def _run(cell: str, fault: str | None) -> dict:
    return run.run_cell(tiny_cell(cell), 2**31 + 7, 0.0, False, torch.device("cpu"), fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = _run(cell, None)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    out = _run(cell, fault)
    assert not out["correct"], out["checks"]
    assert all(c["limit"] is not None for c in out["checks"].values())
