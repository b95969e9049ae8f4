"""Everything that belongs to one cell, configuration, traffic mix, entry or
per-layer metric sits in a file of its own, found here by its name:

- ``workloads/<cell>.json``: its ``config``, ``traffic``, ``entry``,
  ``chips``, ``why``, ``trace_units`` and the limits of its ``checks``;
- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the parameters the generator reads;
- ``entries/<entry>.py``: the set-up, window and check of a kind of run;
- ``metrics/<metric>.py``: a reader of the device trace;
- ``flops/<config>.py``: the configuration's operations and launches.

No list of them is kept in code: a later cell, configuration or metric is
a new file.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r} ({path} is missing)")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module named {name!r} ({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"_bench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_readers(root: Path = ROOT) -> dict:
    """Every reader under ``metrics/``, by metric name."""
    return {p.name[:-3]: load_module("metrics", p.name[:-3], root)
            for p in sorted((root / "metrics").glob("*.py")) if not p.name.startswith("_")}


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell with its configuration and traffic mix read in."""
    spec = load_json("workloads", name, root)
    spec["name"] = name
    spec["config_spec"] = dict(load_json("configs", spec["config"], root), name=spec["config"])
    spec["traffic_spec"] = load_json("traffic", spec["traffic"], root)
    return spec
