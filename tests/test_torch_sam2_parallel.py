"""SAM2 under a mesh (``Trainer`` with ``mesh_shape``) against the JAX
package's mesh steps and the port's single process, f32, on the CPU.

``SAM2Config.tiny_test()`` at 64², with the weights of
``tests/test_torch_sam2_train.py`` (the port's seeded init moved by
N(0, 0.05²), the object-score bias at 3 so every slice tracks an object),
taken into JAX's tree by ``convert_sam2_state_dict``. The port's ranks are
spawned once, at 2 and at 4, joined by a gloo group with ``file://`` init;
JAX's steps run on the virtual CPU devices of ``tests/conftest.py``, one
spawned process each, beside them; the port's single process runs in the
parent meanwhile.

- the encoder-split step: batch 1, 8 slices (4 and 2 a rank). Every rank
  holds the whole tomogram, encodes only its slab of the slices (the slices
  its encoder saw are recorded) and gathers the pyramids; its loss, both
  metrics, the gathered predictions and every trained gradient match JAX's
  GSPMD step on a ``world``-device mesh (``place_batch`` shards the depth)
  and the port's single process;
- the data-parallel step at batch ``world`` (4 slices each) for both input
  forms: the plain tensor (``num_init_cond_slices`` (1, 1), JAX's
  ``shard_map`` step) and the dict with a cond-slice draw
  (``num_init_cond_slices`` (3, 1); each rank's generator seeded apart, so
  only rank 0's draw, broadcast, makes them agree; JAX's GSPMD step on the
  same draw);
- the parameters after each step equal on every rank;
- ``Trainer.fit`` (one epoch, SWA, a validation epoch), ``test`` and
  ``predict`` on a training-ready file of 8 slices (the loader pads the
  depth to 32) over 2 ranks: every forward takes the encoder-split step,
  each encoder call sees 16 slices, and the logs, weights, test results and
  predictions are the single process's;
- planted faults at 2 ranks that the checks must catch: rank 0 encoding
  rank 1's slab, and the encoder-split step's gradients summed over the
  ranks where each rank's are already the whole batch's (2×);
- placement on a mesh without a group: the batch axis, the encoder split,
  a depth that does not divide (and 256 slices, which the forward cuts to
  255) replicated with one warning, cached pyramids replicated without one;
  the family's ``split_inputs`` of the dict input, and ``Sharding.local``
  refusing a dict.

Tolerances: against JAX those of ``tests/test_torch_sam2_train.py``
(probabilities and losses 2e-3, gradients 5e-4 absolute; the two
thresholded metrics 1e-3); against the port's single process f32 rounding
(logs 1e-4 relative, probabilities 1e-5, gradients 5e-4 of the largest).
The encoder-split step reads 0 at 2 ranks and 6e-7 of the largest gradient
at 4; the data-parallel step runs each tomogram's prompt-predictor convs at
batch 1, whose weight gradients (sums over 64²·4 voxels) add in another
order than the batch's: 1.3e-4 of the largest and 4e-5 of the gradient
norm at most. fit's trained weights are held by their updates (the L2
difference over the update's norm, 1e-3; it reads 0). The planted faults
read 0.3 (wrong slab) and 1.0 (2×).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cryovit_tpu_torch.config import MODELS, TrainConfig, TrainerConfig
from cryovit_tpu_torch.models import SAM2
from cryovit_tpu_torch.models.losses import DiceLoss
from cryovit_tpu_torch.models.metrics import DiceMetric, F1Metric
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.encoder import ImageEncoder
from cryovit_tpu_torch.models.sam2.model import SAM2Model, random_sam2_state_dict
from cryovit_tpu_torch.parallel import Mesh, Sharding, spatial
from cryovit_tpu_torch.run.train_model import build_file_datamodule
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.train.swa import StochasticWeightAveraging
from cryovit_tpu_torch.types import TomogramBatch, TomogramData

LR = 1e-3
SIDE = 64
B1_DEPTH, DP_DEPTH = 8, 4
FIT_DEPTH, FIT_PADDED = 8, 32  # the training file's slices, and the loader's padded depth
COND_SEED = 104  # draws num_cond 3 with the cond slices [0, 2, 3] of 4
KW = {
    "b1": {"test_config": True, "prompt_lr": 2e-3},
    "dp": {"test_config": True, "prompt_lr": 2e-3},
    "dp_dict": {"test_config": True, "prompt_lr": 2e-3, "num_init_cond_slices": (3, 1),
                "rand_init_cond_slices": (True, False)},
}
# against JAX: tests/test_torch_sam2_train.py's bounds
JAX_PROB_TOL, JAX_LOSS_TOL, JAX_GRAD_TOL, METRIC_TOL = 2e-3, 2e-3, 5e-4, 1e-3
# against the port's single process: f32 rounding
SINGLE_LOG_TOL, SINGLE_PROB_TOL, SINGLE_GRAD_TOL = 1e-4, 1e-5, 5e-4
# fit's trained weights against the single process's: the L2 difference of
# each tensor's update over the update's L2 norm (reads 0)
FIT_UPDATE_TOL = 1e-3


def _family(case: str, rank: int = 0) -> SAM2:
    kw = dict(KW[case])
    if case == "dp_dict":  # each rank's generator apart: rank 0's draw must win
        kw["cond_seed"] = COND_SEED + 1000 * rank
    fam = SAM2(name="SAM2", input_key="data", lr=LR, weight_decay=1e-3,
               losses={"dice_loss": DiceLoss()},
               metrics={"dice_metric": DiceMetric(0.5), "f1_metric": F1Metric(0.5)},
               custom_kwargs=kw)
    fam.train_mode = True
    return fam


def _batch(inputs: dict, case: str) -> TomogramBatch:
    data = inputs[f"{case}_data"]
    return TomogramBatch(data.numpy(), inputs[f"{case}_label"].numpy(),
                         np.full((data.shape[0],), data.shape[1]))


def _run(inputs: dict, case: str, mesh_shape=None, rank: int = 0) -> dict:
    """One batch as ``fit`` places it: the starting weights' predictions
    (gathered where the batch split), then one train step; its logs, trained
    gradients, the parameters after it, how the batch lay, the cond-slice
    draw it used and every slice this rank's encoder saw."""
    fam = _family(case, rank)
    trainer = Trainer(precision="f32", device="cpu", mesh_shape=mesh_shape,
                      enable_model_summary=False)
    module = fam.build_module(inputs["sd"], torch.device("cpu"))
    trainer.model, trainer.module, trainer.optimizer = fam, module, fam.make_optimizer(module)
    encoded: list[torch.Tensor] = []
    forward = ImageEncoder.forward

    def recorded(self, x):
        encoded.append(x[..., 0].clone())
        return forward(self, x)

    ImageEncoder.forward = recorded
    try:
        data, label, sharding = trainer.place(fam, _batch(inputs, case), None)
        with torch.no_grad():  # predict_step's, outside inference mode (caches kept for the step)
            preds = trainer._gather(trainer._forward(fam, module.eval(), data, sharding)[0],
                                    sharding)
        seen = len(encoded)
        logs = {k: float(v) for k, v in trainer.train_step(data, label, sharding).items()}
    finally:
        ImageEncoder.forward = forward
    draw = (data["order"], data["num_cond"]) if isinstance(data, dict) else None
    return {"logs": logs, "preds": preds,
            "grads": {k: p.grad.clone() for k, p in module.named_parameters()
                      if p.grad is not None},
            "params": {k: p.detach().clone() for k, p in module.named_parameters()},
            "dim": None if sharding is None else sharding.dim,
            "encoder": sharding is not None and sharding.encoder,
            "draw": draw, "encoded": torch.cat(encoded[:seen]),
            "encoded_step": torch.cat(encoded[seen:])}


def _job_wrong_slab(inputs: dict, mesh_shape, rank: int) -> dict:
    """Planted fault: rank 0 encodes rank 1's slab in its place."""
    encode = SAM2Model.encode_images

    def wrong(self, slices, mesh=None):
        if mesh is not None and mesh.rank == 0:
            k = slices.shape[0] // mesh.size
            slices = torch.cat([slices[k : 2 * k], slices[k:]])
        return encode(self, slices, mesh)

    SAM2Model.encode_images = wrong
    try:
        return _run(inputs, "b1", mesh_shape, rank)
    finally:
        SAM2Model.encode_images = encode


def _job_summed(inputs: dict, mesh_shape, rank: int) -> dict:
    """Planted fault: the encoder-split step's gradients summed over the
    ranks, as a split batch's are."""
    reduce = Trainer._reduce_gradients

    def summed(self, sharding):
        return reduce(self, Sharding(sharding.mesh, 0) if sharding.encoder else sharding)

    Trainer._reduce_gradients = summed
    try:
        return _run(inputs, "b1", mesh_shape, rank)
    finally:
        Trainer._reduce_gradients = reduce


def _fit(inputs: dict, mesh_shape=None, rank: int = 0) -> dict:
    """``Trainer.fit`` (one epoch, SWA, a validation epoch on the training
    file) on the training-ready file, then ``test`` and ``predict`` on it:
    the logged epochs, the trained weights, the test losses, metrics and
    predictions, the predictions, how each forward's batch lay and the
    slices each encoder call saw."""
    model_cfg = dataclasses.replace(MODELS["sam2"], custom_kwargs=(("use_cache_features", False),))
    cfg = TrainConfig(label_key="mito", model=model_cfg,
                      trainer=TrainerConfig(precision="f32", max_epochs=1))
    cfg = dataclasses.replace(cfg, dataloader=dataclasses.replace(cfg.dataloader, num_workers=0))
    root = Path(inputs["fit_dir"])
    dm = build_file_datamodule(cfg, [root / "train.hdf"], [root / "labels.hdf"], labels=["mito"])
    history = []

    class Recorder:
        def log_scalars(self, scalars, step):
            history.append(dict(scalars))

    trainer = Trainer(precision="f32", max_epochs=1, device="cpu", mesh_shape=mesh_shape,
                      callbacks=[StochasticWeightAveraging(swa_lrs=LR, swa_epoch_start=0.6)],
                      loggers=[Recorder()], enable_model_summary=False)
    model = _family("b1", rank)
    layouts, encoded = [], []
    place, forward = trainer.place, ImageEncoder.forward

    def placed(*args, **kwargs):
        data, label, sharding = place(*args, **kwargs)
        layouts.append(None if sharding is None else (sharding.dim, sharding.encoder))
        return data, label, sharding

    def recorded(self, x):
        encoded.append(x.shape[0])
        return forward(self, x)

    trainer.place, ImageEncoder.forward = placed, recorded
    try:
        module = trainer.fit(model, dm, variables=inputs["sd"])
        tested = trainer.test(model, dm)
        predicted = trainer.predict(dm)
    finally:
        ImageEncoder.forward = forward
    return {"history": history,
            "params": {k: p.detach().clone() for k, p in module.named_parameters()},
            "test": [(r.losses, r.metrics, r.preds) for r in tested],
            "predict": [r.preds for r in predicted], "layouts": layouts, "encoded": encoded}


JOBS = {
    "b1": lambda inputs, shape, rank: _run(inputs, "b1", shape, rank),
    "dp": lambda inputs, shape, rank: _run(inputs, "dp", shape, rank),
    "dp_dict": lambda inputs, shape, rank: _run(inputs, "dp_dict", shape, rank),
    "wrong_slab": _job_wrong_slab,
    "summed": _job_summed,
    "fit": _fit,
}


def _rank_main(rank: int, world: int, tmp: str, inputs_path: str, jobs: list[str]) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        inputs = {**inputs, "b1_data": inputs["b1_data"], "dp_data": inputs[f"dp{world}_data"],
                  "dp_label": inputs[f"dp{world}_label"], "dp_dict_data": inputs[f"dp{world}_data"],
                  "dp_dict_label": inputs[f"dp{world}_label"]}
        torch.save({job: JOBS[job](inputs, {"data": -1}, rank) for job in jobs},
                   f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# ---- JAX's steps, spawned processes -----------------------------------------------

# one process each: every case compiles a program of its own, and the
# processes compile side by side
JAX_CASES = ((("b1", 2),), (("b1", 4),), (("dp", 2),), (("dp", 4),), (("dp_dict", 2),),
             (("dp_dict", 4),))


def _jax_steps(inputs: dict, case: str, worlds: tuple[int, ...]) -> dict:
    """JAX's step of the SAM2 family on an ``n``-device mesh for each ``n``
    of ``worlds``, the batch placed by the JAX ``Trainer``
    (``place_batch``): the ``shard_map`` program of ``_train_step_dp_fn``
    for the plain tensor it takes, the GSPMD program of ``_train_step_fn``
    (under its kernel guard) otherwise; each returning the losses, metrics,
    predictions and the gradient of the loss (psum-ed over the shards in
    the ``shard_map`` one), under the port's names."""
    from functools import partial

    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cryovit_tpu.models.base import prediction_mask
    from cryovit_tpu.models.losses import DiceLoss as JaxDiceLoss
    from cryovit_tpu.models.metrics import DiceMetric as JaxDiceMetric
    from cryovit_tpu.models.metrics import F1Metric as JaxF1Metric
    from cryovit_tpu.models.sam2.convert import convert_sam2_state_dict
    from cryovit_tpu.models.sam2.family import SAM2 as JaxSAM2
    from cryovit_tpu.parallel import replicate
    from cryovit_tpu.train.loop import Trainer as JaxTrainer
    from cryovit_tpu.types import TomogramBatch as JaxTomogramBatch
    from cryovit_tpu_torch.convert import sam2_from_jax

    kw = {k: v for k, v in KW[case].items() if k != "rand_init_cond_slices"}
    fam = JaxSAM2(name="SAM2", input_key="data", lr=LR, weight_decay=1e-3,
                  losses={"dice_loss": JaxDiceLoss()},
                  metrics={"dice_metric": JaxDiceMetric(0.5), "f1_metric": JaxF1Metric(0.5)},
                  custom_kwargs=kw)
    fam.build_module()
    variables = jax.tree_util.tree_map(
        jnp.asarray, convert_sam2_state_dict({k: v.numpy() for k, v in inputs["sd"].items()},
                                             fam.sam_cfg))

    def loss_fn(v, x, y, axis=None):
        p, aux = fam.apply_with_aux(v, x)
        mask = prediction_mask(y)
        losses = fam.compute_losses(p, y, mask, aux=aux, axis_name=axis)
        return losses["total"], (losses, fam.compute_metrics(p, y, mask, axis_name=axis), p)

    gspmd = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    out = {}
    for n in worlds:
        trainer = JaxTrainer(precision="f32", mesh_shape={"data": n})
        key = "b1" if case == "b1" else f"dp{n}"
        data, label = inputs[f"{key}_data"].numpy(), inputs[f"{key}_label"].numpy()
        batch = trainer._place(JaxTomogramBatch(
            data=data, label=label, num_slices=np.full((data.shape[0],), data.shape[1])))
        split = 1 if case == "b1" else 0
        assert batch.data.addressable_shards[0].data.shape[split] == data.shape[split] // n
        x, y = batch.data, jnp.asarray(batch.label)
        if case == "dp_dict":
            order, num_cond = inputs["draw"]
            x = {"slices": x, "order": jnp.asarray(order, jnp.int32),
                 "num_cond": jnp.asarray(num_cond, jnp.int32)}
        params = replicate(variables, trainer.mesh)
        if case == "dp":
            assert trainer._dp_eligible(x, y)

            def step(v, x, y):
                (_, res), grads = jax.value_and_grad(partial(loss_fn, axis="data"),
                                                     has_aux=True)(v, x, y)
                return res, jax.lax.psum(grads, "data")

            fn = jax.jit(jax.shard_map(step, mesh=trainer.mesh,
                                       in_specs=(P(), P("data"), P("data")),
                                       out_specs=((P(), P(), P("data")), P()), check_vma=False))
            (losses, metrics, preds), grads = fn(params, x, y)
        else:
            assert not trainer._dp_eligible(x, y)
            with trainer._gspmd_kernel_guard():
                (_, (losses, metrics, preds)), grads = gspmd(params, x, y)
        out[case, n] = {
            "logs": {f"train_{k}": float(v) for k, v in {**losses, **metrics}.items()},
            "preds": torch.from_numpy(np.array(preds)),
            "grads": {k: torch.from_numpy(np.array(v)) for k, v in sam2_from_jax(grads).items()}}
    return out


def _jax_main(index: int, tmp: str, inputs_path: str, cache_dir: str | None) -> None:
    """JAX_CASES[index] on the virtual CPU devices (the parent's environment
    gives the device count), with the parent's compilation cache; XLA's
    optimizations off, which halves the compile (the same math, rounded
    otherwise: well within the tolerances against the port)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_disable_most_optimizations", True)
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    inputs = torch.load(inputs_path, weights_only=False)
    cases = JAX_CASES[index]
    torch.save(_jax_steps(inputs, cases[0][0], tuple(n for _, n in cases)),
               f"{tmp}/rank{index}.pt")


# ---- the parent -------------------------------------------------------------------


def _training_file(root: Path, rng) -> None:
    """A training-ready HDF5 of FIT_DEPTH 32x32 slices of raw voxels (the
    first two unlabeled) and its label file."""
    import h5py

    root.mkdir(parents=True)
    label = (rng.random((FIT_DEPTH, 32, 32)) > 0.5).astype(np.int8)
    label[:2] = -1
    with h5py.File(root / "train.hdf", "w") as f:
        f.create_dataset("data", data=rng.random((FIT_DEPTH, 32, 32)).astype(np.float32))
        f.create_dataset("labels/mito", data=label)
    with h5py.File(root / "labels.hdf", "w") as f:
        f.create_dataset("mito", data=label)


def _start(fn, tmp: Path, nprocs: int, args: tuple):
    tmp.mkdir(parents=True)
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")


def _join(context, tmp: Path, n: int, timeout: float = 300.0) -> list[dict]:
    """Every process's results, once all have ended (a failed one raises
    here); processes still running after ``timeout`` seconds are ended and
    fail the test."""
    deadline = time.monotonic() + timeout
    while not context.join(timeout=2.0):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.terminate()
            raise AssertionError(f"processes still running after {timeout} s")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs (numpy seeds), every rank's results at 2 ranks (the three
    steps, the two faults and fit) and at 4 (the three steps), JAX's six
    steps (a process each), and the port's single process on each batch and
    fit, run in the parent while the others run."""
    import jax

    rng = np.random.default_rng(20)
    tmp = tmp_path_factory.mktemp("sam2_parallel")
    cfg = dataclasses.replace(SAM2Config.tiny_test(), max_cond_slices=3)
    sd = {k: v + 0.05 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in random_sam2_state_dict(cfg, torch.Generator().manual_seed(20)).items()}
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"][:] = 3.0
    draw = _family("dp_dict")._sample_cond_slices(DP_DEPTH, DP_DEPTH)
    _training_file(tmp / "fit", rng)
    inputs = {"sd": sd, "draw": draw, "fit_dir": str(tmp / "fit")}
    for key, shape in (("b1", (1, B1_DEPTH)), ("dp2", (2, DP_DEPTH)), ("dp4", (4, DP_DEPTH))):
        inputs[f"{key}_data"] = torch.from_numpy(
            rng.random((*shape, SIDE, SIDE, 1)).astype(np.float32))
        label = (rng.random((*shape, SIDE, SIDE)) > 0.5).astype(np.float32)
        label[..., :8, :] = -1
        inputs[f"{key}_label"] = torch.from_numpy(label)
    torch.save(inputs, tmp / "inputs.pt")
    cache = jax.config.jax_compilation_cache_dir
    jax_runs = _start(_jax_main, tmp / "jax", len(JAX_CASES),
                      (str(tmp / "jax"), str(tmp / "inputs.pt"), cache))
    two = _start(_rank_main, tmp / "w2", 2,
                 (2, str(tmp / "w2"), str(tmp / "inputs.pt"),
                  ["b1", "dp", "dp_dict", "wrong_slab", "summed", "fit"]))
    four = _start(_rank_main, tmp / "w4", 4,
                  (4, str(tmp / "w4"), str(tmp / "inputs.pt"), ["b1", "dp", "dp_dict"]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {"inputs": inputs}
    try:
        out["single"] = {"b1": _run(inputs, "b1")}
        for n in (2, 4):
            per_world = {**inputs, "dp_data": inputs[f"dp{n}_data"],
                         "dp_label": inputs[f"dp{n}_label"],
                         "dp_dict_data": inputs[f"dp{n}_data"],
                         "dp_dict_label": inputs[f"dp{n}_label"]}
            out["single"][f"dp{n}"] = _run(per_world, "dp")
            out["single"][f"dp_dict{n}"] = _run(per_world, "dp_dict")
        out["single"]["fit"] = _fit(inputs)
    finally:
        torch.set_num_threads(threads)
        out["two"] = _join(two, tmp / "w2", 2)
        out["four"] = _join(four, tmp / "w4", 4)
        out["jax"] = {k: v for run in _join(jax_runs, tmp / "jax", len(JAX_CASES))
                      for k, v in run.items()}
    return out


# ---- the checks ----------------------------------------------------------------------


def _disagreements(got: dict, want: dict, log_tol: float, prob_tol: float,
                   grad_tol: float, relative: bool) -> list[str]:
    """What of a step falls outside a reference's tolerances: each of the
    reference's logs (the thresholded metrics within METRIC_TOL at least),
    the predictions (absolute), every trained gradient (absolute, or
    relative to the largest)."""
    bad = []
    for k, v in want["logs"].items():
        tol = max(log_tol, METRIC_TOL if "metric" in k else 0.0)
        if not abs(got["logs"][k] - v) <= tol * (max(abs(v), 1.0) if relative else 1.0):
            bad.append(f"{k}: {got['logs'][k]} vs {v}")
    error = (got["preds"] - want["preds"]).abs().max().item()
    if not error <= prob_tol:
        bad.append(f"predictions: max|diff| {error}")
    assert set(got["grads"]) == set(want["grads"]) or not relative
    scale = max(w.abs().max().item() for w in want["grads"].values()) if relative else 1.0
    for name, g in got["grads"].items():
        if not (g - want["grads"][name]).abs().max().item() <= grad_tol * scale:
            bad.append(f"gradient {name}")
    return bad


def _against_jax(got: dict, want: dict) -> list[str]:
    return _disagreements(got, want, JAX_LOSS_TOL, JAX_PROB_TOL, JAX_GRAD_TOL, relative=False)


def _against_single(got: dict, want: dict) -> list[str]:
    return _disagreements(got, want, SINGLE_LOG_TOL, SINGLE_PROB_TOL, SINGLE_GRAD_TOL,
                          relative=True)


def _ranks(runs, world: int, job: str) -> list[dict]:
    return [r[job] for r in runs["two" if world == 2 else "four"]]


def _same_parameters(ranks: list[dict]) -> None:
    for r in ranks[1:]:
        assert r["logs"] == ranks[0]["logs"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(r["params"][name], p), name


@pytest.mark.parametrize("world", [2, 4])
def test_encoder_split_step_matches_gspmd_and_the_single_process(runs, world):
    """Batch 1, 8 slices: every rank takes the encoder-split step, its
    encoder sees exactly its slab (8/world slices) in the forward and in
    the step; the gathered predictions, loss, metrics and every trained
    gradient match JAX's GSPMD step on ``world`` devices and the single
    process; the parameters after the step equal on every rank."""
    single, gspmd = runs["single"]["b1"], runs["jax"]["b1", world]
    k = B1_DEPTH // world
    assert single["encoded"].shape[0] == B1_DEPTH
    for rank, r in enumerate(_ranks(runs, world, "b1")):
        assert r["dim"] is None and r["encoder"]
        for seen in (r["encoded"], r["encoded_step"]):
            assert torch.equal(seen, single["encoded"][rank * k : (rank + 1) * k])
        assert _against_single(r, single) == []
        assert _against_jax(r, gspmd) == []
    assert _against_jax(single, gspmd) == []
    _same_parameters(_ranks(runs, world, "b1"))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["dp", "dp_dict"])
def test_data_parallel_step_matches_jax_and_the_single_process(runs, case, world):
    """Batch ``world``, 4 slices each: every rank takes the batch split (one
    tomogram each, encoded whole by its own encoder); the dict's cond-slice
    draw is rank 0's on every rank (the parent's draw, which JAX takes); the
    loss, metrics, gathered predictions and every trained gradient match
    JAX's step (``shard_map`` for the tensor, GSPMD for the dict) and the
    single process; the parameters after the step equal on every rank."""
    single = runs["single"][f"{case}{world}"]
    ranks = _ranks(runs, world, case)
    for r in ranks:
        assert r["dim"] == 0 and not r["encoder"]
        assert r["encoded"].shape[0] == DP_DEPTH
        if case == "dp_dict":
            order, num_cond = runs["inputs"]["draw"]
            assert r["draw"] == (order, num_cond) == single["draw"] and num_cond == 3
        assert _against_single(r, single) == []
        assert _against_jax(r, runs["jax"][case, world]) == []
    _same_parameters(ranks)


def test_planted_faults_are_caught(runs):
    """At 2 ranks: rank 0 encoding rank 1's slab moves the predictions and
    the gradients off both references; the encoder-split step's gradients
    summed over the ranks (2×) move every gradient."""
    single, gspmd = runs["single"]["b1"], runs["jax"]["b1", 2]
    for job in ("wrong_slab", "summed"):
        got = _ranks(runs, 2, job)[0]
        for bad in (_against_single(got, single), _against_jax(got, gspmd)):
            assert any(b.startswith("gradient") for b in bad), (job, bad)
            if job == "wrong_slab":
                assert any(b.startswith("predictions") for b in bad), bad
    summed = _ranks(runs, 2, "summed")[0]
    for name, g in single["grads"].items():
        torch.testing.assert_close(summed["grads"][name], 2 * g, rtol=1e-4,
                                   atol=1e-4 * g.abs().max().item())


def test_fit_test_and_predict_take_the_encoder_split_step(runs):
    """``Trainer.fit`` (one epoch, SWA, validation), ``test`` and ``predict``
    on the training file (32 slices after the loader's padding) over 2
    ranks: every forward (train, validation, test, predict) takes the
    encoder-split step and each rank's encoder sees 16 slices at a time; the
    logged epoch within the single process's tolerances (rank 0 alone
    logging); the weights equal on both ranks, the frozen ones bit for bit
    the single process's and the trained ones' updates within
    FIT_UPDATE_TOL of its; the test losses and metrics and every rank's predictions the single
    process's."""
    want = runs["single"]["fit"]
    main, other = (r["fit"] for r in runs["two"])
    assert want["layouts"] == [None] * 4 and set(want["encoded"]) == {FIT_PADDED}
    for rank in (main, other):
        assert rank["layouts"] == [(None, True)] * 4
        assert rank["encoded"] == [FIT_PADDED // 2] * len(want["encoded"])
    assert other["history"] == [] and len(main["history"]) == len(want["history"]) > 0
    for g, w in zip(main["history"], want["history"]):
        assert g.keys() == w.keys()
        for key, value in w.items():
            if "time" not in key:
                tol = max(SINGLE_LOG_TOL, METRIC_TOL if "metric" in key else 0.0)
                assert abs(g[key] - value) <= tol * max(abs(value), 1.0), (key, g[key], value)
    start = runs["inputs"]["sd"]
    for name, p in main["params"].items():
        assert torch.equal(other["params"][name], p), name
        w = want["params"][name]
        if torch.equal(w, start[name]):  # frozen: bit for bit
            assert torch.equal(p, w), name
        else:
            assert (p - w).norm() <= FIT_UPDATE_TOL * (w - start[name]).norm(), name
    for rank in (main, other):
        ((losses, metrics, preds),), ((w_losses, w_metrics, w_preds),) = rank["test"], want["test"]
        for key, value in {**w_losses, **w_metrics}.items():
            tol = max(SINGLE_LOG_TOL, METRIC_TOL if "metric" in key else 0.0)
            assert abs({**losses, **metrics}[key] - value) <= tol * max(abs(value), 1.0), key
        assert preds[0].shape == w_preds[0].shape == (FIT_DEPTH, 32, 32)
        np.testing.assert_allclose(preds[0], w_preds[0], rtol=0, atol=SINGLE_PROB_TOL)
        np.testing.assert_allclose(rank["predict"][0][0], want["predict"][0][0], rtol=0,
                                   atol=SINGLE_PROB_TOL)


# ---- placement on a mesh without a group ----------------------------------------------


def _placed(monkeypatch, world: int, shape: tuple, **kw) -> tuple[Sharding, list[str]]:
    """How ``Trainer.place`` lays a SAM2 batch of ``shape`` on a ``world``
    mesh (no process group: no collective runs on these paths), and the
    warnings it logged."""
    trainer = Trainer(precision="f32", device="cpu", enable_model_summary=False)
    trainer.mesh = Mesh({"data": world}, device=torch.device("cpu"))
    fam = _family("b1")
    fam.use_cache_features = kw.pop("cached", False)
    items = kw.pop("items", None)
    batch = TomogramBatch(np.zeros((*shape, 4, 4, 1), np.float32),
                          np.zeros((*shape, 4, 4), np.float32), np.full((shape[0],), shape[1]))
    records = []
    monkeypatch.setattr(spatial, "_warned_replicate", False)
    handler = logging.Handler()
    handler.emit = records.append
    spatial.logger.addHandler(handler)
    try:
        data, _, sharding = trainer.place(fam, batch, items)
    finally:
        spatial.logger.removeHandler(handler)
    return data, sharding, [r.getMessage() for r in records]


def test_placement_follows_the_batch_then_the_encoder(monkeypatch):
    data, sharding, warned = _placed(monkeypatch, 4, (4, 8))
    assert (sharding.dim, sharding.encoder, tuple(data.shape[:2]), warned) == (0, False, (1, 8), [])
    data, sharding, warned = _placed(monkeypatch, 4, (1, 8))
    assert (sharding.dim, sharding.encoder, tuple(data.shape[:2]), warned) == (None, True, (1, 8), [])
    _, sharding, warned = _placed(monkeypatch, 4, (1, 6))
    assert (sharding.dim, sharding.encoder) == (None, False) and len(warned) == 1
    _, sharding, warned = _placed(monkeypatch, 2, (1, 256))
    assert (sharding.dim, sharding.encoder) == (None, False) and len(warned) == 1
    assert "sees 255 slices" in warned[0]
    data, sharding, warned = _placed(monkeypatch, 2, (2, 256))  # the batch axis first
    assert (sharding.dim, tuple(data.shape[:2]), warned) == (0, (1, 256), [])


def test_cached_pyramids_are_replicated_without_a_warning(monkeypatch):
    """Batch 1 with cached ``sam_features``: no encoder to split, the whole
    batch on every rank, no warning."""
    levels = [np.zeros((8, 32, 16, 16), np.float16), np.zeros((8, 32, 8, 8), np.float16),
              np.zeros((8, 32, 4, 4), np.float16)]
    item = TomogramData(sample="s", tomo_name="t", split_id=0, data=np.zeros((8, 4, 4, 1)),
                        label=np.zeros((8, 4, 4)),
                        aux_data={"sam_features": {"backbone_fpn": levels,
                                                   "vision_pos_enc": levels}})
    data, sharding, warned = _placed(monkeypatch, 4, (1, 8), cached=True, items=[item])
    assert "backbone" in data and (sharding.dim, sharding.encoder, warned) == (None, False, [])


def test_sharding_local_splits_only_the_slices_of_the_dict_input():
    """SAM2's ``split_inputs``: of the cond-slice dict only the ``slices``
    split along the batch axis (the draw stays whole, and the encoder split
    keeps it all); cached pyramids take neither split. ``Sharding.local``
    splits tensors and raises on a dict rather than return it whole."""
    mesh = Mesh({"data": 2}, rank=1, device=torch.device("cpu"))
    fam, slices = _family("b1"), torch.arange(4.0).view(4, 1)
    drawn = {"slices": slices, "order": [0, 2, 1], "num_cond": 2}
    got = fam.split_inputs(drawn, Sharding(mesh, 0))
    assert torch.equal(got["slices"], slices[2:]) and (got["order"], got["num_cond"]) == ([0, 2, 1], 2)
    assert fam.split_inputs(drawn, Sharding(mesh, None, encoder=True))["slices"] is slices
    assert torch.equal(fam.split_inputs(slices, Sharding(mesh, 0)), slices[2:])
    cached = {"slices": slices, "backbone": {}}
    assert fam.split_inputs(cached, Sharding(mesh, None)) is cached
    for sharding in (Sharding(mesh, 0), Sharding(mesh, None, encoder=True)):
        assert fam.split_inputs(cached, sharding) is None
    for sharding in (Sharding(mesh, 0), Sharding(mesh, 1)):
        with pytest.raises(ValueError, match="does not split"):
            sharding.local(drawn)
