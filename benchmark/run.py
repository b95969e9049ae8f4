"""The benchmark of ``cryovit_tpu_torch`` on NVIDIA GPUs.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run is one process: it builds the cell's weights and traffic from the
seed, warms up the cell's shapes (the set-up, ``setup_s``), runs the window
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: whole units
under the profiler, the per-layer metrics that ``metrics/`` reads), checks
what the window produced against the plain reference, and prints one JSON
line last on its standard output. It runs on the card only: without one
(or with fewer than the cell asks for) it prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cryovit_tpu"}  # whole top-level module names


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def card_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card (after
    ``chip_smoke.py:431``), or why there is none."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"not read ({e})"


def _paths() -> None:
    for p in (str(CHECKOUT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # every build and kernel cache stays at a fixed place inside the checkout
    build = CHECKOUT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, control: bool = False,
             fault: str | None = None) -> dict:
    """One run of ``cell`` (``harness.files.cell``); returns the result
    line's fields (``checks`` holds each compared number and its limit)."""
    import torch

    from harness import clock, files
    from harness.trace import traced

    entry = files.load_module("entries", cell["entry"])
    job = entry.Job(cell, seed, device, control=control, fault=fault)
    try:
        on_card = device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = clock.process_age_s()
        clock.mark("window starts")
        breakdown = None
        if trace:
            job.spans()
            window, reading = traced(lambda: job.window(units=cell["trace_units"]),
                                     cell["entry"], job.work)
            metrics = {}
            for name, reader in files.metric_readers().items():
                value = reader.read(reading)
                if value is not None:
                    metrics[name] = {"value": value, "unit": reader.UNIT}
            breakdown = reading.breakdown
            extra = {"busy_s": reading.busy_s, "window_s": reading.window_s}
            print(f"trace parsed in {reading.parse_s:.1f} s", file=sys.stderr)
        else:
            window = job.window(seconds=seconds)
            metrics = {k: {"value": v, "unit": entry.UNITS[k]} for k, v in window["metrics"].items()}
            extra = {}
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        if not trace:
            metrics["peak_mem_gib"] = {"value": peak / 2**30, "unit": "GiB"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        job.finish_units()
        job.release()
        values = job.check()
    finally:
        job.close()
    # a number the cell's file gives no limit is not compared (PERF.md says why)
    limits = {k: v for k, v in cell.get("checks", {}).items() if v is not None}
    checks = {k: {"value": values[k], "limit": lim} for k, lim in limits.items()}
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    return {"correct": correct, "attempted": window["units"], "failed": 0 if correct else 1,
            "metrics": metrics, "peak": peak, "extra": extra, "breakdown": breakdown,
            "checks": checks, "values": values, "worst_leaves": getattr(job, "worst_leaves", None)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from harness import files

    from harness import clock

    cell = files.cell(args.workload)
    import torch

    import cryovit_tpu_torch

    clock.mark("torch and the program imported")

    if CHECKOUT not in Path(cryovit_tpu_torch.__file__).resolve().parents:
        print(f"benchmark: the program under test is not in this checkout ({CHECKOUT}); "
              f"found {cryovit_tpu_torch.__file__}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros((), device=device)
    clock.mark("CUDA context made")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    print(f"card: {card_and_power_limit()}", file=sys.stderr)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell["chips"],
           "memory_peak_bytes": out["peak"], **out["extra"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": out["metrics"], "device": dev}
    if out["breakdown"] is not None:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
