"""Experiment entry points (port of ``cryovit_tpu/training/``; reference
``src/cryovit/training/``).

Run as ``python -m cryovit_tpu_torch.training.<name> [overrides...]`` with
hydra-style overrides (``model=cryovit``, ``datamodule.sample=AD``,
``+experiments=single_hd_mito``). The sweeps defined in experiment YAMLs
expand automatically; ``--sweep-index N`` runs a single grid point (the
cluster fan-out, ``scripts/torch/sweep.sh``) and ``--list-sweep`` prints the
grid. Every run is on the GPU unless ``--device cpu`` asks for the CPU;
without a GPU the default raises.
"""

from __future__ import annotations

import argparse
import logging
import sys
import traceback
from typing import Callable

from cryovit_tpu_torch import resolve_device
from cryovit_tpu_torch._logging_config import setup_logging
from cryovit_tpu_torch.composer import ConfigError, expand_sweep_file
from cryovit_tpu_torch.config import compose

logger = logging.getLogger(__name__)

__all__ = ["run_module_main", "sweep_main"]


def sweep_main(
    config_name: str,
    run_fn: Callable,
    validate_fn: Callable,
    argv: list[str] | None = None,
) -> int:
    """Shared entry logic for experiment mains (reference
    ``training/train_model.py:20-55``): compose → validate → ``run_fn(cfg,
    device=...)`` for each grid point of the sweep. A ConfigError stops the
    sweep with exit code 1 at once; a grid point that fails otherwise is
    logged, the sweep goes on, and the exit code is 1."""
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("overrides", nargs="*", help="hydra-style key=value overrides")
    parser.add_argument("--sweep-index", type=int, default=None,
                        help="run only the Nth sweep grid point")
    parser.add_argument("--list-sweep", action="store_true",
                        help="print the sweep grid and exit")
    parser.add_argument("--device", default=None,
                        help="torch device to run on (default: the GPU; 'cpu' for the CPU)")
    args = parser.parse_args(argv)
    setup_logging("INFO")

    overrides = list(args.overrides)
    experiment = next(
        (ov.split("=", 1)[1] for ov in overrides if ov.lstrip("+").startswith("experiments=")),
        None,
    )
    grids: list[list[str]] = [[]]
    if experiment is not None:
        grids = expand_sweep_file(experiment)
    if args.list_sweep:
        for i, g in enumerate(grids):
            print(i, g)
        return 0
    if args.sweep_index is not None:
        grids = [grids[args.sweep_index]]
    device = resolve_device(args.device)

    exit_code = 0
    for i, grid in enumerate(grids):
        try:
            cfg = compose(config_name, overrides + grid)
            validate_fn(cfg)
            if len(grids) > 1:
                logger.info("sweep %d/%d: %s", i + 1, len(grids), grid)
            run_fn(cfg, device=device)
        except ConfigError as e:
            logger.error("config error: %s", e)
            return 1
        except Exception:
            logger.error("run failed for %s:\n%s", grid, traceback.format_exc())
            exit_code = 1
    return exit_code


def run_module_main(config_name: str, run_fn: Callable, validate_fn: Callable) -> None:
    sys.exit(sweep_main(config_name, run_fn, validate_fn))
