"""The harness finds a cell, a configuration, a traffic mix and a per-layer
metric added as files alone: a copy of the benchmark gains them, with no
code edit, and a traced run of the new cell (on the CPU, at a tiny size)
reports the new metric. Also: the contract file and the readers agree."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from conftest import BENCH, tiny_cell

from harness import files

RUN_SCRIPT = """
import json, sys
sys.path[:0] = [{bench!r}, {checkout!r}]
import run
run._paths()
import torch
from harness import files
cell = files.cell("tiny_vit.infer")
out = run.run_cell(cell, 2**31 + 99, 0.0, True, torch.device("cpu"))
print(json.dumps({{"metrics": out["metrics"], "checks": out["checks"]}}))
"""


def test_new_files_need_no_code(tmp_path):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cell = tiny_cell("cryovit_vitg14.infer")
    cfg = dict(cell["config_spec"])
    cfg.pop("name")
    (copy / "configs" / "tiny_vit.json").write_text(json.dumps(cfg))
    (copy / "flops" / "tiny_vit.py").write_text(
        (BENCH / "flops" / "cryovit_vitg14.py").read_text())
    (copy / "traffic" / "tiny_tomograms.json").write_text(json.dumps(cell["traffic_spec"]))
    (copy / "workloads" / "tiny_vit.infer.json").write_text(json.dumps({
        "config": "tiny_vit", "traffic": "tiny_tomograms", "entry": "fused_infer", "chips": 1,
        "why": "a test", "trace_units": 2, "checks": {"prob_gap": 1e-3}}))
    (copy / "metrics" / "slices_traced.infer.py").write_text(
        'UNIT, LAYER, MOVES = "slices", "test", "slices_per_s"\n\n\n'
        'def read(t):\n    return t.work.get("slices")\n')
    out = subprocess.run(
        [sys.executable, "-c", RUN_SCRIPT.format(bench=str(copy), checkout=str(BENCH.parent))],
        capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    # two tomograms (16 and 24 slices) traced, the new reader read them
    assert result["metrics"]["slices_traced.infer"] == {"value": 40, "unit": "slices"}
    assert result["checks"]["prob_gap"]["value"] < 1e-3


def test_benchmark_json_matches_the_files():
    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    readers = files.metric_readers()
    cells = {w["name"]: files.cell(w["name"]) for w in spec["workloads"]}
    for w in spec["workloads"]:
        assert (cells[w["name"]]["config"], cells[w["name"]]["traffic"]) == (w["config"], w["traffic"])
        assert cells[w["name"]]["chips"] == w["chips"] and cells[w["name"]]["why"] == w["why"]
    for m in spec["per_layer"]:
        r = readers[m["name"]]
        assert (r.UNIT, r.LAYER, r.MOVES) == (m["unit"], m["layer"], m["moves"])
    assert set(readers) == {m["name"] for m in spec["per_layer"]}
    for c in spec["configs"]:
        assert files.load_json("configs", c["name"])["reduced"] == c["reduced"]


def test_benchmark_json_keeps_the_contracts_forms():
    import re

    spec = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for item in spec["configs"] + spec["workloads"] + spec["end_to_end"] + spec["per_layer"]:
        assert name.match(item["name"]), item["name"]
        for key in ("why", "layer", "source"):
            assert 1 <= len(item.get(key, "x")) <= 200 and "\n" not in item.get(key, "")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", m["workloads"]))
    assert 1 <= spec["run_seconds"] <= 51
    assert all((BENCH.parent / c["file"]).is_file() for c in spec["configs"])
