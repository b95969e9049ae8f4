"""Shared wiring between config nodes and runtime objects (port of
``cryovit_tpu/run/common.py``): the experiment mode's model, datamodule,
trainer and experiment directory from a composed config, and the
read → compute → write pipeline of the extraction sweeps."""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any

import torch

from cryovit_tpu_torch.composer import DotDict, _import_target, instantiate
from cryovit_tpu_torch.config import PRECISION_DTYPES
from cryovit_tpu_torch.models.base import BaseModel
from cryovit_tpu_torch.train.loop import Trainer

logger = logging.getLogger(__name__)

__all__ = [
    "build_datamodule",
    "build_model",
    "build_trainer",
    "pipeline_io",
    "setup_exp_dir",
]


def build_model(cfg: DotDict, precision: str | None = None) -> BaseModel:
    """Instantiate the model family from ``cfg.model`` computing in the
    trainer's precision (``bf16`` | ``f32``). SAM2 draws its cond slices
    from the run's ``random_seed``, as the CLI's recipe does."""
    node = dict(cfg.model)
    if "SAM2" in str(node.get("_target_", "")):
        node["custom_kwargs"] = {"cond_seed": int(cfg.get("random_seed", 42)),
                                 **(node.get("custom_kwargs") or {})}
    model: BaseModel = instantiate(node)
    dtype = PRECISION_DTYPES.get(precision or "")
    if dtype is not None:
        model.dtype = dtype
    return model


def build_datamodule(cfg: DotDict):
    """Experiment-mode datamodule from ``cfg.datamodule`` + the splits CSV
    ``paths.data_dir/<csv_name>/<split_name>`` (reference
    ``run/train_model.py:224-232``)."""
    dm_cfg = dict(cfg.datamodule)
    dataset_fn = instantiate(dm_cfg.pop("dataset"))
    dataloader_fn = instantiate(dm_cfg.pop("dataloader"))
    cls = _import_target(dm_cfg.pop("_target_"))
    dm_cfg.pop("_partial_", None)
    split_file = Path(cfg.paths.data_dir) / cfg.paths.csv_name / cfg.paths.split_name
    return cls(
        split_file=split_file,
        dataset_fn=dataset_fn,
        dataloader_fn=dataloader_fn,
        input_key=cfg.model.input_key,
        **dm_cfg,
    )


def build_trainer(
    cfg: DotDict, device: torch.device | str | None = None, extra_callbacks: list | None = None
) -> Trainer:
    """Trainer + callbacks + loggers from config, on ``device`` (the GPU
    unless the CPU is named).

    The trainer schema's ``mesh_shape`` (e.g. ``{data: -1}``) goes to the
    :class:`Trainer`, which makes the mesh over the process group
    (``torchrun`` sets it up; without one, a mesh of one process).
    ``donate_state`` (XLA buffer donation) has no torch counterpart and is
    dropped."""
    trainer_cfg: dict[str, Any] = dict(cfg.get("trainer") or {})
    trainer_cfg.pop("donate_state", None)
    callbacks = [instantiate(node) for node in (cfg.get("callbacks") or {}).values()]
    loggers = [instantiate(node) for node in (cfg.get("logger") or {}).values()]
    callbacks.extend(extra_callbacks or [])
    return Trainer(
        callbacks=callbacks,
        loggers=loggers,
        seed=int(cfg.get("random_seed", 42)),
        device=device,
        **trainer_cfg,
    )


def setup_exp_dir(cfg: DotDict) -> Path:
    """Experiment directory layout ``exp_dir/<name>/<sample>[/split_k][/test_X]``
    (reference ``run/train_model.py:159-203``)."""
    exp_dir = Path(cfg.paths.exp_dir) / str(cfg.name)
    dm = cfg.get("datamodule", {})
    sample = dm.get("sample")
    if isinstance(sample, (list, tuple)):
        sample = "_".join(sorted(map(str, sample)))
    if sample is not None:
        exp_dir = exp_dir / str(sample)
    if dm.get("split_id") is not None:
        exp_dir = exp_dir / f"split_{dm.split_id}"
    test_sample = dm.get("test_sample")
    if isinstance(test_sample, (list, tuple)):
        test_sample = "_".join(sorted(map(str, test_sample)))
    # the test_<X> level only exists for fractional sweeps (reference
    # run/train_model.py:184-186)
    if "Fractional" in str(dm.get("_target_", "")) and test_sample is not None:
        exp_dir = exp_dir / f"test_{test_sample}"
    exp_dir.mkdir(parents=True, exist_ok=True)
    return exp_dir


def pipeline_io(
    n: int,
    read_fn,
    compute_fn,
    write_fn,
    read_ahead: int = 2,
    writers: int = 2,
) -> list:
    """Read → compute → write pipeline for extraction sweeps.

    Reads prefetch in a small thread pool (``read_ahead`` items deep),
    writes retire in a writer pool with bounded backpressure, and compute
    (the device work) stays on the caller thread — so host HDF5 decode and
    gzip encode overlap device time instead of serializing with it (the
    reference gets the read half of this from its 8 DataLoader workers; the
    write half it does serially).

    ``read_fn(i)`` → item; ``compute_fn(i, item)`` → result;
    ``write_fn(i, result)`` → value collected into the returned list
    (in order).
    """
    import concurrent.futures as cf
    import time
    from collections import deque

    if n <= 0:
        return []
    with cf.ThreadPoolExecutor(
        max_workers=max(1, read_ahead), thread_name_prefix="cryovit-read"
    ) as rpool, cf.ThreadPoolExecutor(
        max_workers=max(1, writers), thread_name_prefix="cryovit-write"
    ) as wpool:
        pending = deque(rpool.submit(read_fn, i) for i in range(min(read_ahead, n)))
        write_futures = []
        for i in range(n):
            item = pending.popleft().result()
            if i + read_ahead < n:
                pending.append(rpool.submit(read_fn, i + read_ahead))
            result = compute_fn(i, item)
            write_futures.append(wpool.submit(write_fn, i, result))
            while sum(not f.done() for f in write_futures) > 2 * writers:
                time.sleep(0.005)
        return [f.result() for f in write_futures]
