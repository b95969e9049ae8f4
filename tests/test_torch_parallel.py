"""Parallelism (``cryovit_tpu_torch.parallel``) against the JAX package's
mesh, on the CPU with gloo process groups.

The port runs one process per rank: ``torch.multiprocessing`` spawns 2 and
4 ranks, joined by a gloo group with ``file://`` init under the test's
temporary directory. The spawned ranks import this module, so JAX is
imported only inside the test functions: the JAX side runs in the parent on
the 8 virtual CPU devices that ``tests/conftest.py`` provides. All inputs
are made from numpy seeds; weights come from JAX's init through
``cryovit_tpu_torch.convert``.

- (a) ``make_mesh``'s fill / explicit / error cases against JAX's
  ``make_mesh``, and the backend it picks from a ``torchrun`` environment;
- (b) the losses and metrics with a mesh at 4 ranks against JAX's
  ``shard_map(partial(fn, axis_name="data"))``, and each rank's gradient
  against JAX's per-shard gradient;
- (c) the data-parallel ``Trainer`` step at 4 ranks (four 4×32×32
  tomograms' f32 features) against the JAX ``Trainer``'s
  ``_train_step_dp_fn`` on a 4-device mesh: two steps' logs and the
  parameters after them, identical on every rank; and against the port's
  own single-process step (eval step and gathered predictions too);
- (d) the depth-sharded CryoVIT step at batch 1 over 2 and 4 ranks (halos
  spanning several ranks at 4) against JAX's GSPMD step (loss) and the
  port's single-process step (every gradient); UNet3D's over 2 and 4 ranks
  (1x32x16x16 voxels: 16 and 8 slices a rank, halos at every level) against
  JAX's GSPMD step and the port's single process (loss, metrics, every
  gradient, the gathered predictions), and a depth that divides 4 ranks
  but not 4 * 2^pools (16 slices) taking the replicated step with its
  warning; ``Trainer.fit``, ``test`` and ``predict`` of UNet3D on 2 ranks;
- (e) ``place_batch``'s three branches and its warning, and a model's slab
  multiple (UNet3D's 8) with its own warning;
- (f) the sharded ``DinoExtractor`` (batch 3 on 2 ranks: rounded to 4, tail
  padded) against JAX's ``DinoExtractor(mesh=make_mesh({"data": 2}))``, and
  the sharded ``SamFeatureExtractor`` against the port's single process;
- ``Trainer.fit`` on a depth-sharded mesh of 2 against the single process;
- (g) planted faults (gradients averaged instead of summed; halos zeroed;
  GroupNorm's statistics over each slab alone; UNet3D's halos zeroed at
  one level-2 conv, its InstanceNorm statistics over each slab alone)
  that the checks of (c) and (d) must catch.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from cryovit_tpu_torch.models import CryoVIT, UNet3D
from cryovit_tpu_torch.models.cryovit import make_cryovit
from cryovit_tpu_torch.models.losses import DiceLoss, dice_loss, focal_loss
from cryovit_tpu_torch.models.metrics import DiceMetric, F1Metric, dice_metric, f1_metric
from cryovit_tpu_torch.models.unet3d import make_unet3d
from cryovit_tpu_torch.parallel import Mesh, make_mesh, place_batch, shard_batch
from cryovit_tpu_torch.parallel import spatial
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.types import TomogramBatch

LR = 1e-4
DP_SHAPE = (4, 4, 2, 2, 1536)  # four 4x32x32 tomograms' features
DEPTH_FEATS, DEPTH_LABEL = (1, 16, 4, 4, 1536), (1, 16, 64, 64)
# the train-step tolerances of tests/test_torch_train.py: Dice loss 3e-4,
# metrics 1e-3, gradients 1e-4 of the largest
LOSS_TOL, METRIC_TOL, GRAD_TOL = 3e-4, 1e-3, 1e-4
# the parameters after the steps: each tensor's update (from the common
# start) within relative L2 PARAM_TOL of the reference's. Adam turns a
# rounding-level difference of a gradient near 0 into an update difference
# of up to the learning rate, so the parameters themselves are not held
# element by element
PARAM_TOL = 1e-3

# UNet3D's raw voxels: 32 slices (16 and 8 a rank at 2 and 4 ranks, so every
# level's slab stays even through the three stride-2 pools), and 16 slices,
# which divide 4 ranks but not 4 * 2^3
UNET_SHAPE, UNET_REPLICATED_SHAPE = (1, 32, 16, 16, 1), (1, 16, 16, 16, 1)
# UNet3D: each gradient's L2 difference against its norm, floored at
# UNET_GRAD_FLOOR of the largest norm (a conv bias before a norm has a
# gradient of rounding only, which the split sums move by up to 7e-8 of the
# largest norm), within tests/test_torch_unet3d.py's 1e-3 of JAX and within
# GRAD_TOL of the port's single process (f32 rounding: the sharded step
# reads 6e-6 at most); the logs relatively, the predictions absolutely
UNET_JAX_TOL, UNET_SINGLE_TOL, UNET_GRAD_FLOOR = 1e-3, GRAD_TOL, 1e-2


def _update_error(got: dict, want: dict, start: dict) -> float:
    """The largest relative L2 difference of two runs' updates of a tensor."""
    return max(float(np.linalg.norm(np.asarray(got[k]) - np.asarray(w))
                     / np.linalg.norm(np.asarray(w) - np.asarray(start[k])))
               for k, w in want.items())


# ---- the ranks ----------------------------------------------------------------


def _family() -> CryoVIT:
    return CryoVIT(
        name="CryoVIT", input_key="dino_features", lr=LR,
        losses={"dice_loss": DiceLoss()},
        metrics={"dice_metric": DiceMetric(0.5), "f1_metric": F1Metric(0.5)},
    )


def _unet_family() -> UNet3D:
    return UNet3D(
        name="UNet3D", input_key="data", lr=LR,
        losses={"dice_loss": DiceLoss()},
        metrics={"dice_metric": DiceMetric(0.5), "f1_metric": F1Metric(0.5)},
    )


def _trainer(sd: dict, mesh_shape=None, family: str = "cryovit") -> Trainer:
    """A trainer at the state ``fit`` would start from, with ``sd``'s weights."""
    trainer = Trainer(precision="f32", device="cpu", mesh_shape=mesh_shape,
                      enable_model_summary=False)
    if family == "unet3d":
        model, module = _unet_family(), make_unet3d(sd, trainable=True)
    else:
        model, module = _family(), make_cryovit(sd, trainable=True)
    trainer.model, trainer.module, trainer.optimizer = model, module, model.make_optimizer(module)
    return trainer


def _steps(trainer: Trainer, batch: TomogramBatch, n: int) -> dict:
    """``n`` train steps on the batch as ``fit`` places it: each step's logs,
    the first step's gradients, the parameters after the last."""
    data, label, sharding = trainer.place(trainer.model, batch, None)
    logs, grads = [], None
    for _ in range(n):
        logs.append({k: float(v) for k, v in trainer.train_step(data, label, sharding).items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in trainer.module.named_parameters()}
    params = {k: p.detach().clone() for k, p in trainer.module.named_parameters()}
    dim = None if sharding is None else sharding.dim
    return {"logs": logs, "grads": grads, "params": params, "dim": dim}


def _job_losses(inputs: dict) -> dict:
    mesh = make_mesh({"data": -1}, device="cpu")
    y_pred, y_true, mask = shard_batch(
        (inputs["y_pred"], inputs["y_true"], inputs["y_true"] > -1), mesh)
    out = {fn.__name__: fn(y_pred, y_true, mask, mesh=mesh).item()
           for fn in (dice_loss, focal_loss, dice_metric, f1_metric)}
    y = y_pred.clone().requires_grad_(True)
    dice_loss(y, y_true, mask, mesh=mesh).backward()
    out["grad"] = y.grad
    return out


def _dp_batch(inputs: dict) -> TomogramBatch:
    return TomogramBatch(inputs["dp_feats"].numpy(), inputs["dp_label"].numpy(),
                         np.full((DP_SHAPE[0],), DP_SHAPE[1]))


def _job_dp(inputs: dict) -> dict:
    """Two data-parallel steps; then the eval step on the updated weights
    (losses, metrics, gathered predictions)."""
    trainer = _trainer(inputs["dp_sd"], {"data": -1})
    out = _steps(trainer, _dp_batch(inputs), 2)
    data, label, sharding = trainer.place(trainer.model, _dp_batch(inputs), None)
    preds, losses, metrics = trainer.eval_step(trainer.module, trainer.model, data, label,
                                               sharding=sharding)
    out["eval"] = {k: float(v) for k, v in {**losses, **metrics}.items()}
    out["eval_preds"] = trainer._gather(preds, sharding)
    return out


def _job_dp_averaged(inputs: dict) -> dict:
    """Planted fault: the gradients averaged over the ranks (DDP's default)."""
    reduce = Trainer._reduce_gradients

    def averaged(self, sharding):
        reduce(self, sharding)
        for p in self.module.parameters():
            p.grad.div_(sharding.mesh.size)

    Trainer._reduce_gradients = averaged
    try:
        return _steps(_trainer(inputs["dp_sd"], {"data": -1}), _dp_batch(inputs), 2)
    finally:
        Trainer._reduce_gradients = reduce


def _depth_batch(inputs: dict) -> TomogramBatch:
    return TomogramBatch(inputs["depth_feats"].numpy(), inputs["depth_label"].numpy(),
                         np.array([DEPTH_FEATS[1]]))


def _job_depth(inputs: dict) -> dict:
    return _steps(_trainer(inputs["depth_sd"], {"data": -1}), _depth_batch(inputs), 1)


def _zero_halos(x, mesh, dim, d):
    shape = list(x.shape)
    shape[dim] = d
    return torch.cat([x.new_zeros(shape), x, x.new_zeros(shape)], dim)


def _job_depth_halo_zero(inputs: dict) -> dict:
    """Planted fault: every halo zero (each slab convolved as if alone)."""
    from cryovit_tpu_torch.models import cryovit

    exchange, cryovit.halo_exchange = cryovit.halo_exchange, _zero_halos
    try:
        return _job_depth(inputs)
    finally:
        cryovit.halo_exchange = exchange


def _job_depth_local_norms(inputs: dict) -> dict:
    """Planted fault: GroupNorm's statistics over each rank's own slab."""
    from cryovit_tpu_torch.models import cryovit

    group_norm = cryovit._group_norm
    cryovit._group_norm = lambda x, gn, channel_dim, mesh=None: group_norm(x, gn, channel_dim)
    try:
        return _job_depth(inputs)
    finally:
        cryovit._group_norm = group_norm


def _unet_batch(inputs: dict, key: str = "unet") -> TomogramBatch:
    data = inputs[f"{key}_data"]
    return TomogramBatch(data.numpy(), inputs[f"{key}_label"].numpy(), np.array([data.shape[1]]))


def _predict_and_step(trainer: Trainer, batch: TomogramBatch) -> dict:
    """The predictions of the starting weights as ``predict`` places and
    gathers them, then one train step (:func:`_steps`)."""
    data, _, sharding = trainer.place(trainer.model, batch, None, labels=False)
    preds = trainer._gather(trainer.predict_step(trainer.module, data, trainer.model, sharding),
                            sharding)
    return {**_steps(trainer, batch, 1), "preds": preds}


def _job_unet(inputs: dict, key: str = "unet") -> dict:
    return _predict_and_step(_trainer(inputs["unet_sd"], {"data": -1}, "unet3d"),
                             _unet_batch(inputs, key))


def _job_unet_replicated(inputs: dict) -> dict:
    """16 slices on 4 ranks: the replicated step, and the warnings logged."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    spatial._warned_slab = False
    spatial.logger.addHandler(handler)
    try:
        out = _job_unet(inputs, "unet_replicated")
    finally:
        spatial.logger.removeHandler(handler)
    return {**out, "warnings": [r.getMessage() for r in records]}


def _job_unet_halo_zero(inputs: dict) -> dict:
    """Planted fault: the halos of one level-2 conv zero (analysis level 2's
    second conv, the only one taking 64 channels at half width; UNet3D's
    k3 convs exchange through CryoVIT's)."""
    from cryovit_tpu_torch.models import cryovit

    exchange, width = cryovit.halo_exchange, UNET_SHAPE[3] // 2

    def zero_at_level2(x, mesh, dim, d):
        if dim == 2 and x.shape[1] == 64 and x.shape[-1] == width:
            return _zero_halos(x, mesh, dim, d)
        return exchange(x, mesh, dim, d)

    cryovit.halo_exchange = zero_at_level2
    try:
        return _job_unet(inputs)
    finally:
        cryovit.halo_exchange = exchange


def _job_unet_local_norms(inputs: dict) -> dict:
    """Planted fault: every InstanceNorm's statistics over the rank's own slab."""
    from cryovit_tpu_torch.models import unet3d

    inorm = unet3d._inorm
    unet3d._inorm = lambda x, norm, channel_dim=1, mesh=None: inorm(x, norm, channel_dim)
    try:
        return _job_unet(inputs)
    finally:
        unet3d._inorm = inorm


def _job_single_unet(inputs: dict) -> dict:
    """The references of _job_unet in one process (no mesh)."""
    return {key: _predict_and_step(_trainer(inputs["unet_sd"], None, "unet3d"),
                                   _unet_batch(inputs, key))
            for key in ("unet", "unet_replicated")}


def _job_single_fit_unet(inputs: dict) -> dict:
    return _fit(inputs["fit_dir"], inputs["unet_sd"], None, "unet3d")


def _job_dino(inputs: dict) -> dict:
    from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
    from cryovit_tpu_torch.run.dino_features import DinoExtractor

    model = make_dinov2(inputs["dino_sd"], DinoV2Config.tiny_test(), device="cpu",
                        dtype=torch.bfloat16)
    ext = DinoExtractor(model, batch_size=3, mesh=make_mesh(device="cpu"))
    return {"feats": torch.from_numpy(ext.extract(inputs["dino_stack"].numpy())),
            "batch_size": ext.batch_size}


def _job_sam(inputs: dict) -> dict:
    from cryovit_tpu_torch.models.sam2.config import SAM2Config
    from cryovit_tpu_torch.run.sam_features import SamFeatureExtractor, load_sam_encoder

    encoder = load_sam_encoder(random_init=True, cfg=SAM2Config.tiny_test(), device="cpu",
                               dtype=torch.float32)
    ext = SamFeatureExtractor(encoder, batch_size=3, mesh=make_mesh(device="cpu"))
    out = ext.extract(inputs["sam_stack"].numpy())
    return {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v] for k, v in out.items()}


def _job_fit(inputs: dict) -> dict:
    return _fit(inputs["fit_dir"], inputs["fit_sd"], {"data": -1})


def _job_fit_unet(inputs: dict) -> dict:
    return _fit(inputs["fit_dir"], inputs["unet_sd"], {"data": -1}, "unet3d")


def _fit(root: str, sd: dict, mesh_shape, family: str = "cryovit") -> dict:
    """``Trainer.fit`` (SWA, a validation epoch each) on one training-ready
    file, then ``test`` and ``predict`` on it: its logs and final weights,
    what rank 0's logger saw, the test losses, metrics and predictions, the
    predictions, and how each forward's batch lay (its split dim)."""
    from cryovit_tpu_torch.config import MODELS, TrainConfig, TrainerConfig
    from cryovit_tpu_torch.run.train_model import build_file_datamodule
    from cryovit_tpu_torch.train.swa import StochasticWeightAveraging

    class Recorder:
        def __init__(self):
            self.history = []

        def log_scalars(self, scalars, step):
            self.history.append(dict(scalars))

    root = Path(root)
    epochs = 3 if family == "cryovit" else 1
    cfg = TrainConfig(label_key="mito", model=MODELS[family],
                      trainer=TrainerConfig(precision="f32", max_epochs=epochs))
    cfg = dataclasses.replace(cfg, dataloader=dataclasses.replace(cfg.dataloader, num_workers=0))
    dm = build_file_datamodule(cfg, [root / "train.hdf"], [root / "labels.hdf"], labels=["mito"])
    rec = Recorder()
    trainer = Trainer(precision="f32", max_epochs=epochs, device="cpu", mesh_shape=mesh_shape,
                      callbacks=[StochasticWeightAveraging(swa_lrs=LR, swa_epoch_start=0.6)],
                      loggers=[rec], enable_model_summary=False)
    model = _family() if family == "cryovit" else _unet_family()
    dims = []
    forward = Trainer._forward

    def recorded(model, module, data, sharding):
        dims.append(None if sharding is None else sharding.dim)
        return forward(model, module, data, sharding)

    trainer._forward = recorded
    module = trainer.fit(model, dm, variables=sd)
    tested = trainer.test(model, dm)
    predicted = trainer.predict(dm)
    return {"history": rec.history, "logged": trainer.logged,
            "params": {k: p.detach().clone() for k, p in module.named_parameters()},
            "test": [(r.losses, r.metrics, r.preds) for r in tested],
            "predict": [r.preds for r in predicted], "dims": dims}


JOBS = {
    "losses": _job_losses,
    "dp": _job_dp,
    "dp_averaged": _job_dp_averaged,
    "depth": _job_depth,
    "depth_halo_zero": _job_depth_halo_zero,
    "depth_local_norms": _job_depth_local_norms,
    "unet": _job_unet,
    "unet_replicated": _job_unet_replicated,
    "unet_halo_zero": _job_unet_halo_zero,
    "unet_local_norms": _job_unet_local_norms,
    "dino": _job_dino,
    "sam": _job_sam,
    "fit": _job_fit,
    "fit_unet": _job_fit_unet,
    "single_unet": _job_single_unet,
    "single_fit_unet": _job_single_fit_unet,
}


def _rank_main(rank: int, world: int, tmp: str, inputs_path: str, jobs: list[str]) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/init", rank=rank,
                            world_size=world)
    try:
        inputs = torch.load(inputs_path, weights_only=False)
        torch.save({job: JOBS[job](inputs) for job in jobs}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# JAX's UNet3D references (_jax_unet_step), one process each: their compiles
# take most of the fixture's time, and they run beside the parent's work.
# The replicated depth also on a mesh of one: JAX's GSPMD gradients at 4
# devices are wrong there (ROADMAP Queue C, C7)
JAX_UNET_CASES = (("unet", 2), ("unet", 4), ("unet_replicated", 4), ("unet_replicated", 1))


def _jax_unet_main(index: int, tmp: str, inputs_path: str, cache_dir: str | None) -> None:
    """JAX_UNET_CASES[index] on the 8 virtual CPU devices (the parent's
    environment gives the device count), with the parent's compilation
    cache, to ``tmp/rank<index>.pt``."""
    import jax
    import jax.numpy as jnp

    from cryovit_tpu.train.torch_import import convert_unet3d_state_dict

    jax.config.update("jax_platforms", "cpu")
    if cache_dir:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    inputs = torch.load(inputs_path, weights_only=False)
    variables = jax.tree_util.tree_map(jnp.asarray, convert_unet3d_state_dict(
        {k: v.numpy() for k, v in inputs["unet_sd"].items()}))
    torch.save(_jax_unet_step(inputs, variables, *JAX_UNET_CASES[index]), f"{tmp}/rank{index}.pt")


def _start(tmp: Path, world: int, inputs_path: Path, jobs: list[str]):
    """``world`` ranks running ``jobs``, started and not waited for."""
    tmp.mkdir(parents=True)
    return mp.start_processes(_rank_main, args=(world, str(tmp), str(inputs_path), jobs),
                              nprocs=world, join=False, start_method="spawn")


def _join(context, tmp: Path, world: int, timeout: float = 300.0) -> list[dict]:
    """Every rank's results, once all have ended (a failed rank raises
    here); ranks still running after ``timeout`` seconds are ended and fail
    the test."""
    deadline = time.monotonic() + timeout
    while not context.join(timeout=5.0):
        if time.monotonic() > deadline:
            for process in context.processes:
                process.terminate()
            raise AssertionError(f"ranks still running after {timeout} s")
    assert not any(process.is_alive() for process in context.processes)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ---- the parent: inputs, the references, the runs ------------------------------


def _to_torch(sd: dict) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _training_file(root: Path, rng) -> None:
    """A training-ready HDF5 of 8 slices on a 2x2 patch grid (the first two
    unlabeled) and its label file; the loader pads the depth to 32."""
    import h5py

    d = 8
    root.mkdir(parents=True)
    label = rng.integers(0, 2, size=(d, 32, 32)).astype(np.int8)
    label[:2] = -1
    with h5py.File(root / "train.hdf", "w") as f:
        f.create_dataset("data", data=rng.random((d, 32, 32)))
        f.create_dataset("dino_features",
                         data=(rng.standard_normal((1536, d, 2, 2)) * 0.3).astype(np.float16))
        f.create_dataset("labels/mito", data=label)
    with h5py.File(root / "labels.hdf", "w") as f:
        f.create_dataset("mito", data=label)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The inputs (numpy seeds; the decoder's weights the port's seeded init
    taken into JAX and back through ``cryovit_from_jax``, UNet3D's the port's
    seeded init with its 1-D parameters moved off their initial values, the
    tiny DINOv2's JAX's init), every rank's results of the 4-rank run
    (losses, data-parallel, depth-sharded CryoVIT and UNet3D, UNet3D's
    replicated step, the five faults) and of the 2-rank run (depth-sharded
    CryoVIT and UNet3D, the extractors, fit of both), and the references,
    computed while the ranks run: JAX's mesh steps and extractor and the
    port's single process in the parent, JAX's UNet3D steps and the port's
    single UNet3D process in processes of their own."""
    import jax
    import jax.numpy as jnp

    from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
    from cryovit_tpu.models.dinov2 import make_dinov2 as jax_make_dinov2
    from cryovit_tpu.train.torch_import import convert_cryovit_state_dict
    from cryovit_tpu_torch.convert import cryovit_from_jax, dinov2_from_jax
    from cryovit_tpu_torch.models.cryovit import random_cryovit_state_dict
    from cryovit_tpu_torch.models.unet3d import random_unet3d_state_dict

    rng = np.random.default_rng(18)
    tmp = tmp_path_factory.mktemp("parallel")
    seeded = random_cryovit_state_dict(torch.Generator().manual_seed(18))
    cryo_vars = jax.tree_util.tree_map(
        jnp.asarray, convert_cryovit_state_dict({k: v.numpy() for k, v in seeded.items()}))
    unet_sd = {k: v + 0.1 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
               if v.dim() == 1 else v
               for k, v in random_unet3d_state_dict(torch.Generator().manual_seed(19)).items()}
    dino_cfg = JaxDinoV2Config.tiny_test()
    dino_vars = jax_make_dinov2(dino_cfg, use_flash_attention=False).init(
        jax.random.key(2), jnp.zeros((1, 28, 28)))
    _training_file(tmp / "fit", rng)
    sd = _to_torch(cryovit_from_jax(cryo_vars))
    inputs = {
        "y_pred": torch.from_numpy(rng.random((8, 4, 16, 16)).astype(np.float32)),
        "y_true": torch.from_numpy(rng.integers(-1, 2, size=(8, 4, 16, 16)).astype(np.float32)),
        "dp_feats": torch.from_numpy(rng.standard_normal(DP_SHAPE).astype(np.float32)),
        "dp_label": torch.from_numpy(rng.integers(-1, 2, size=(4, 4, 32, 32)).astype(np.int8)),
        "dp_sd": sd,
        "depth_feats": torch.from_numpy(rng.standard_normal(DEPTH_FEATS).astype(np.float32)),
        "depth_label": torch.from_numpy(rng.integers(-1, 2, size=DEPTH_LABEL).astype(np.float32)),
        "depth_sd": sd,
        "dino_sd": _to_torch(dinov2_from_jax(dino_vars)),
        "dino_stack": torch.from_numpy(rng.random((6, 32, 32)).astype(np.float32)),
        "sam_stack": torch.from_numpy(rng.random((5, 40, 40)).astype(np.float32)),
        "fit_dir": str(tmp / "fit"),
        "fit_sd": sd,
        "unet_sd": unet_sd,
    }
    for key, shape in (("unet", UNET_SHAPE), ("unet_replicated", UNET_REPLICATED_SHAPE)):
        inputs[f"{key}_data"] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        inputs[f"{key}_label"] = torch.from_numpy(
            rng.integers(-1, 2, size=shape[:4]).astype(np.float32))
    torch.save(inputs, tmp / "inputs.pt")
    four = _start(tmp / "w4", 4, tmp / "inputs.pt",
                  ["losses", "dp", "dp_averaged", "depth", "depth_halo_zero",
                   "depth_local_norms", "unet", "unet_replicated", "unet_halo_zero",
                   "unet_local_norms"])
    two = _start(tmp / "w2", 2, tmp / "inputs.pt",
                 ["depth", "unet", "dino", "sam", "fit", "fit_unet"])
    one = _start(tmp / "w1", 1, tmp / "inputs.pt", ["single_unet", "single_fit_unet"])
    (tmp / "jax").mkdir()
    jax_unet = mp.start_processes(
        _jax_unet_main, nprocs=len(JAX_UNET_CASES), join=False, start_method="spawn",
        args=(str(tmp / "jax"), str(tmp / "inputs.pt"), jax.config.jax_compilation_cache_dir))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = {"inputs": inputs, "cryo_vars": cryo_vars, "dino_vars": dino_vars,
               "dino_cfg": dino_cfg}
        out["jax_dp"] = _jax_dp_steps(inputs, cryo_vars)
        out["jax_depth"] = {n: _jax_depth_loss(inputs, cryo_vars, n) for n in (2, 4)}
        out["jax_dino"] = _jax_dino(inputs, dino_vars, dino_cfg)
        out["single_dp"] = _single_dp(inputs)
        out["single_depth"] = _steps(_trainer(sd), _depth_batch(inputs), 1)
        out["single_fit"] = _fit(inputs["fit_dir"], sd, None)
    finally:
        torch.set_num_threads(threads)
        out["four"] = _join(four, tmp / "w4", 4)
        out["two"] = _join(two, tmp / "w2", 2)
        (single,) = _join(one, tmp / "w1", 1)
        out.update(single)  # single_unet, single_fit_unet
        jax_runs = _join(jax_unet, tmp / "jax", len(JAX_UNET_CASES))
        out["jax_unet"] = dict(zip(JAX_UNET_CASES, jax_runs))
    return out


# ---- (a) the mesh -------------------------------------------------------------


SPECS = [None, {"data": -1}, {"data": 4, "model": 2}, {"data": -1, "model": 2},
         {"data": 2}, {"data": 8}]
BAD_SPECS = [({"data": -1, "model": 3}, "divisible"), ({"data": -1, "model": -1}, "at most one"),
             ({"data": 16}, "needs 16")]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_make_mesh_lays_out_axes_as_jax(spec):
    from cryovit_tpu.parallel import make_mesh as jax_make_mesh

    want = jax_make_mesh(spec)  # the 8 virtual devices
    got = make_mesh(spec, world=8)
    assert got.shape == dict(want.shape) and got.axis_names == tuple(want.axis_names)
    assert got.size == want.size


@pytest.mark.parametrize("spec,message", BAD_SPECS, ids=str)
def test_make_mesh_refuses_as_jax(spec, message):
    from cryovit_tpu.parallel import make_mesh as jax_make_mesh

    with pytest.raises(ValueError, match=message):
        jax_make_mesh(spec)
    with pytest.raises(ValueError, match=message):
        make_mesh(spec, world=8)


@pytest.mark.parametrize("device,backend", [("cpu", "gloo"), ("cuda", "nccl"), (None, "nccl")])
def test_make_mesh_initialises_a_torchrun_group(monkeypatch, device, backend):
    """A ``torchrun`` environment initialises the default group: NCCL with
    the rank on ``cuda:LOCAL_RANK`` for the GPU, which no device means as
    everywhere in the port; gloo only for the CPU asked for by name. (The
    group itself is not made here, nor is a GPU needed; the spawned runs
    below use real gloo groups.)"""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(("set_device", d)))
    mesh = make_mesh({"data": -1}, device=device)
    assert calls[-1] == (backend, {"init_method": "env://", "rank": 3, "world_size": 4})
    if device != "cpu":
        assert calls[0] == ("set_device", torch.device("cuda", 1))
        assert mesh.device == torch.device("cuda", 1)
    else:
        assert mesh.device == torch.device("cpu") and len(calls) == 1
    # no environment: a world of one, no group made
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key)
    calls.clear()
    assert make_mesh({"data": -1}, device="cpu").size == 1 and calls == []
    # no device and no GPU: an error, not a quiet CPU mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh({"data": -1})


def test_a_mesh_without_a_group_cannot_communicate():
    mesh = make_mesh({"data": -1}, world=4)
    with pytest.raises(RuntimeError, match="no process group"):
        mesh.all_reduce_(torch.ones(2))


# ---- (b) losses and metrics ---------------------------------------------------


def test_losses_and_metrics_with_a_mesh_match_jax_shard_map(runs):
    """At 4 ranks: each value within rtol 1e-5 of JAX's ``shard_map`` over
    the same 4-way split, equal on every rank; each rank's Dice gradient
    within 1e-6 of JAX's per-shard gradient."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from cryovit_tpu.models.losses import dice_loss as jax_dice_loss
    from cryovit_tpu.models.losses import focal_loss as jax_focal_loss
    from cryovit_tpu.models.metrics import dice_metric as jax_dice_metric
    from cryovit_tpu.models.metrics import f1_metric as jax_f1_metric
    from cryovit_tpu.parallel import make_mesh as jax_make_mesh

    mesh = jax_make_mesh({"data": 4})
    y_pred = jnp.asarray(runs["inputs"]["y_pred"].numpy())
    y_true = jnp.asarray(runs["inputs"]["y_true"].numpy())
    mask = y_true > -1
    spec = (P("data"), P("data"), P("data"))
    for fn in (jax_dice_loss, jax_focal_loss, jax_dice_metric, jax_f1_metric):
        want = float(jax.jit(jax.shard_map(partial(fn, axis_name="data"), mesh=mesh,
                                           in_specs=spec, out_specs=P(), check_vma=False))(
            y_pred, y_true, mask))
        for rank in runs["four"]:
            np.testing.assert_allclose(rank["losses"][fn.__name__], want, rtol=1e-5,
                                       err_msg=fn.__name__)

    def sharded_grad(yp, yt, m):
        return jax.grad(lambda yp: jax_dice_loss(yp, yt, m, axis_name="data"))(yp)

    g_sh = np.asarray(jax.jit(jax.shard_map(sharded_grad, mesh=mesh, in_specs=spec,
                                            out_specs=P("data"), check_vma=False))(
        y_pred, y_true, mask))
    got = np.concatenate([rank["losses"]["grad"].numpy() for rank in runs["four"]])
    np.testing.assert_allclose(got, g_sh, atol=1e-6, rtol=0)


# ---- (c) the data-parallel train step -----------------------------------------


def _jax_dp_steps(inputs: dict, variables, n_steps: int = 2) -> tuple[list, dict]:
    """JAX ``Trainer._train_step_dp_fn`` on a 4-device mesh: each step's logs,
    the parameters after the last (port names)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from cryovit_tpu.models import CryoVIT as JaxCryoVIT
    from cryovit_tpu.models.losses import DiceLoss as JaxDiceLoss
    from cryovit_tpu.models.metrics import DiceMetric as JaxDiceMetric
    from cryovit_tpu.models.metrics import F1Metric as JaxF1Metric
    from cryovit_tpu.parallel import replicate
    from cryovit_tpu.train.loop import Trainer as JaxTrainer
    from cryovit_tpu.train.loop import TrainState
    from cryovit_tpu_torch.convert import cryovit_from_jax

    model = JaxCryoVIT(
        name="CryoVIT", input_key="dino_features", lr=LR,
        losses={"dice_loss": JaxDiceLoss()},
        metrics={"dice_metric": JaxDiceMetric(0.5), "f1_metric": JaxF1Metric(0.5)},
        dtype=jnp.float32,
    )
    opt = model.make_optimizer()
    trainer = JaxTrainer(precision="f32", mesh_shape={"data": 4}, donate_state=False)
    dsh = NamedSharding(trainer.mesh, P("data"))
    feats = jax.device_put(jnp.asarray(inputs["dp_feats"].numpy()), dsh)
    label = jax.device_put(jnp.asarray(inputs["dp_label"].numpy().astype(np.float32)), dsh)
    step = trainer._train_step_dp_fn(model, opt)
    state = replicate(TrainState.create(variables, opt), trainer.mesh)
    logs = []
    for _ in range(n_steps):
        state, step_logs = step(state, feats, label)
        logs.append({k: float(v) for k, v in step_logs.items()})
    return logs, cryovit_from_jax(state.params)


def _single_dp(inputs: dict) -> dict:
    """The port's single-process steps on the whole batch, then its eval step."""
    single = _trainer(inputs["dp_sd"])
    batch = _dp_batch(inputs)
    out = _steps(single, batch, 2)
    data, label, _ = single.place(single.model, batch, None)
    preds, losses, metrics = single.eval_step(single.module, single.model, data, label)
    out["eval"] = {k: float(v) for k, v in {**losses, **metrics}.items()}
    out["eval_preds"] = preds
    return out


def _jax_dino(inputs: dict, variables, cfg) -> tuple[int, np.ndarray]:
    """JAX's ``DinoExtractor(mesh=make_mesh({"data": 2}))`` at batch 3: its
    batch size and features."""
    from cryovit_tpu.parallel import make_mesh as jax_make_mesh
    from cryovit_tpu.run.dino_features import DinoExtractor as JaxDinoExtractor

    ext = JaxDinoExtractor(variables, cfg=cfg, batch_size=3, mesh=jax_make_mesh({"data": 2}),
                           use_flash_attention=False)
    return ext.batch_size, ext.extract(inputs["dino_stack"].numpy())


def _dp_disagreements(got: dict, want_logs: list, want_params: dict, start: dict) -> list[str]:
    """What of a data-parallel run falls outside the tolerances against the
    JAX step: every log of both steps (gradient norms within GRAD_TOL of
    their size), the parameters' updates after them (PARAM_TOL)."""
    bad = []
    for step, (g, w) in enumerate(zip(got["logs"], want_logs, strict=True)):
        assert g.keys() == w.keys()
        for key, value in w.items():
            tol = METRIC_TOL if "metric" in key else LOSS_TOL
            if "grad_norm" in key:
                tol = GRAD_TOL * value
            if not abs(g[key] - value) <= tol:
                bad.append(f"step {step + 1} {key}: {g[key]} vs {value}")
    error = _update_error(got["params"], want_params, start)
    if not error <= PARAM_TOL:
        bad.append(f"parameter updates: relative L2 {error}")
    return bad


def test_data_parallel_step_matches_jax_shard_map_step(runs):
    """Four ranks, one tomogram each, two steps: the logs (losses, metrics,
    both gradient norms) within the train-step tolerances of JAX's
    ``_train_step_dp_fn`` on 4 devices, the parameters after the two steps
    within PARAM_TOL of JAX's (updates) and bit for bit equal on every rank. Against
    the port's single-process step on the whole batch: the logs and the
    summed gradients within f32 rounding, and so the sharded eval step's
    losses, metrics and gathered predictions."""
    ranks = [r["dp"] for r in runs["four"]]
    assert {r["dim"] for r in ranks} == {0}
    assert _dp_disagreements(ranks[0], *runs["jax_dp"], runs["inputs"]["dp_sd"]) == []
    for r in ranks[1:]:
        assert r["logs"] == ranks[0]["logs"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(r["params"][name], p), name

    one = runs["single_dp"]
    assert one["dim"] is None
    for g, w in zip(ranks[0]["logs"], one["logs"], strict=True):
        for key, value in w.items():
            np.testing.assert_allclose(g[key], value, rtol=1e-5, atol=1e-6, err_msg=key)
    for name, w in one["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][name], w, rtol=0,
                                   atol=1e-5 * w.abs().max().item(), err_msg=name)
    for key, value in one["eval"].items():
        np.testing.assert_allclose(ranks[0]["eval"][key], value, rtol=1e-5, atol=1e-6)
    for r in ranks:
        np.testing.assert_allclose(r["eval_preds"], one["eval_preds"], rtol=0, atol=1e-5)


def test_averaged_gradients_are_caught(runs):
    """Planted fault: averaging the gradients over the 4 ranks (DDP's
    default) instead of summing them: the gradient norms read 4x too small,
    and the updates move off (Adam rescales most of it away)."""
    bad = _dp_disagreements(runs["four"][0]["dp_averaged"], *runs["jax_dp"],
                            runs["inputs"]["dp_sd"])
    assert any("grad_norm" in b for b in bad) and any("updates" in b for b in bad), bad


# ---- (d) the depth-sharded step ----------------------------------------------


def _jax_depth_loss(inputs: dict, variables, n: int) -> float:
    """The loss of the JAX package's GSPMD program of ``tests/test_parallel.py``
    (CryoVITModule in f32, Dice) with the batch placed depth-sharded over
    ``n`` devices by JAX's ``place_batch``."""
    import jax
    import jax.numpy as jnp

    from cryovit_tpu.models.cryovit import CryoVITModule
    from cryovit_tpu.models.losses import dice_loss as jax_dice_loss
    from cryovit_tpu.parallel import make_mesh as jax_make_mesh
    from cryovit_tpu.parallel import place_batch as jax_place_batch
    from cryovit_tpu.parallel import replicate
    from cryovit_tpu.types import TomogramBatch as JaxTomogramBatch

    mesh = jax_make_mesh({"data": n})
    batch = jax_place_batch(JaxTomogramBatch(
        data=jnp.asarray(inputs["depth_feats"].numpy()),
        label=jnp.asarray(inputs["depth_label"].numpy()),
        num_slices=jnp.asarray([DEPTH_FEATS[1]])), mesh)
    assert batch.data.addressable_shards[0].data.shape[1] == DEPTH_FEATS[1] // n
    module = CryoVITModule(dtype=jnp.float32)

    @jax.jit
    def loss(v, f, lab):
        return jax_dice_loss(module.apply(v, f), lab, lab > -1)

    return float(loss(replicate(variables, mesh), batch.data, batch.label))


def _jax_unet_step(inputs: dict, variables, key: str, n: int) -> dict:
    """JAX's GSPMD step of UNet3DModule (f32, Dice loss, the family's two
    metrics) with the batch placed depth-sharded over ``n`` devices by JAX's
    ``place_batch``: the loss and metrics under the port's log names, the
    gradients under the port's parameter names, the predictions."""
    import jax
    import jax.numpy as jnp

    from cryovit_tpu.models.losses import dice_loss as jax_dice_loss
    from cryovit_tpu.models.metrics import DiceMetric as JaxDiceMetric
    from cryovit_tpu.models.metrics import F1Metric as JaxF1Metric
    from cryovit_tpu.models.unet3d import UNet3DModule
    from cryovit_tpu.parallel import make_mesh as jax_make_mesh
    from cryovit_tpu.parallel import place_batch as jax_place_batch
    from cryovit_tpu.parallel import replicate
    from cryovit_tpu.types import TomogramBatch as JaxTomogramBatch
    from cryovit_tpu_torch.convert import unet3d_from_jax

    data = inputs[f"{key}_data"].numpy()
    mesh = jax_make_mesh({"data": n})
    batch = jax_place_batch(JaxTomogramBatch(
        data=jnp.asarray(data), label=jnp.asarray(inputs[f"{key}_label"].numpy()),
        num_slices=jnp.asarray([data.shape[1]])), mesh)
    assert batch.data.addressable_shards[0].data.shape[1] == data.shape[1] // n
    module = UNet3DModule(dtype=jnp.float32)
    metrics = {"dice_metric": JaxDiceMetric(0.5), "f1_metric": JaxF1Metric(0.5)}

    @jax.jit
    def step(v, x, y):
        def loss(v):
            p = module.apply(v, x)
            return jax_dice_loss(p, y, y > -1), p

        (value, p), grads = jax.value_and_grad(loss, has_aux=True)(v)
        return value, p, grads, {k: m(p, y, y > -1) for k, m in metrics.items()}

    value, preds, grads, logged = step(replicate(variables, mesh), batch.data, batch.label)
    return {"logs": {"train_dice_loss": float(value),
                     **{f"train_{k}": float(v) for k, v in logged.items()}},
            "grads": {k: torch.from_numpy(np.array(v)) for k, v in unet3d_from_jax(grads).items()},
            "preds": torch.from_numpy(np.array(preds))}


def _unet_disagreements(got: dict, want: dict, tol: float) -> list[str]:
    """What of a UNet3D step falls outside ``tol`` of a reference's (JAX's
    step, or the port's single process with its ``logs`` list): each of the
    reference's logs (relative, at least absolute ``tol``), every gradient
    (the L2 of the difference against its norm, floored at UNET_GRAD_FLOOR
    of the largest norm), the predictions (absolute)."""
    def first(logs):
        return logs[0] if isinstance(logs, list) else logs

    logs, got_logs = first(want["logs"]), first(got["logs"])
    bad = [f"{k}: {got_logs[k]} vs {v}" for k, v in logs.items()
           if not abs(got_logs[k] - v) <= tol * max(abs(v), 1.0)]
    largest = max(w.norm().item() for w in want["grads"].values())
    for name, w in want["grads"].items():
        scale = max(w.norm().item(), UNET_GRAD_FLOOR * largest)
        if not (got["grads"][name] - w).norm().item() <= tol * scale:
            bad.append(f"gradient {name}")
    error = (got["preds"] - want["preds"]).abs().max().item()
    if not error <= tol:
        bad.append(f"predictions: max|diff| {error}")
    return bad


def _depth_disagreements(got: dict, want: dict) -> list[str]:
    """What of a depth-sharded step falls outside f32 rounding of the
    single-process step: the logs, every gradient (1e-5 of its largest)."""
    bad = [f"{k}: {got['logs'][0][k]} vs {v}" for k, v in want["logs"][0].items()
           if not abs(got["logs"][0][k] - v) <= 1e-5 * max(abs(v), 1.0)]
    for name, w in want["grads"].items():
        if not (got["grads"][name] - w).abs().max().item() <= 1e-5 * w.abs().max().item():
            bad.append(f"gradient {name}")
    return bad


@pytest.mark.parametrize("model,world", [
    pytest.param("cryovit", 2, id="2"),
    pytest.param("cryovit", 4, id="4"),
    pytest.param("unet", 2, id="unet3d-2"),
    pytest.param("unet", 4, id="unet3d-4"),
    pytest.param("unet_replicated", 4, id="unet3d-replicated-4"),
])
def test_depth_sharded_step_matches_gspmd_and_the_single_process(runs, model, world):
    """CryoVIT: batch 1, features (1, 16, 4, 4, 1536), labels (1, 16, 64,
    64): each rank holds 16/world slices (4 at 4 ranks, so the halos of
    dilations 16 and 32 span every other rank). The loss within rtol 1e-5 of
    JAX's GSPMD program on a ``world``-device mesh; the logs and every
    gradient within f32 rounding (1e-5 of the largest) of the port's
    single-process step.

    UNet3D: batch 1, voxels (1, 32, 16, 16): each rank holds 32/world slices
    (8 at 4 ranks: 4, 2 and 1 at the pooled levels, so the bottom's halos
    are whole slabs). The loss, both metrics, every gradient and the
    gathered predictions within UNET_JAX_TOL of JAX's GSPMD step on a
    ``world``-device mesh and within UNET_SINGLE_TOL of the port's single
    process. At 16 slices on 4 ranks (4 a rank, which the three stride-2
    pools would split) the step is the replicated one, with its warning
    naming the pools: its loss, metrics and predictions those of JAX's
    GSPMD step (which shards the depth), its gradients those of JAX's step
    on a mesh of one, and JAX's GSPMD gradients off them (C7).

    Either way the parameters after the step equal on every rank."""
    ranks = [r["depth" if model == "cryovit" else model] for r in
             runs["four" if world == 4 else "two"]]
    if model == "cryovit":
        assert {r["dim"] for r in ranks} == {1}
        np.testing.assert_allclose(ranks[0]["logs"][0]["train_dice_loss"],
                                   runs["jax_depth"][world], rtol=1e-5)
        assert _depth_disagreements(ranks[0], runs["single_depth"]) == []
    else:
        replicated = model == "unet_replicated"
        assert {r["dim"] for r in ranks} == {None if replicated else 1}
        if replicated:
            for r in ranks:
                assert len(r["warnings"]) == 1 and "stride-2 depth pools" in r["warnings"][0]
        gspmd = runs["jax_unet"][model, world]
        for r in ranks:
            assert _unet_disagreements(r, runs["single_unet"][model], UNET_SINGLE_TOL) == []
            bad = _unet_disagreements(r, gspmd, UNET_JAX_TOL)
            if not replicated:
                assert bad == []
                continue
            assert bad and all(b.startswith("gradient") for b in bad), bad
            assert _unet_disagreements(r, runs["jax_unet"][model, 1], UNET_JAX_TOL) == []
        if replicated:  # C7: JAX's GSPMD gradients against its own on a mesh of one
            assert _unet_disagreements(gspmd, runs["jax_unet"][model, 1], UNET_JAX_TOL)
    for r in ranks[1:]:
        assert r["logs"] == ranks[0]["logs"]
        for name, p in ranks[0]["params"].items():
            assert torch.equal(r["params"][name], p), name


def test_zeroed_halos_are_caught(runs):
    """Planted fault: every halo zero at 4 ranks (each slab convolved as a
    tomogram of its own): the gradient check fails."""
    bad = _depth_disagreements(runs["four"][0]["depth_halo_zero"], runs["single_depth"])
    assert any(b.startswith("gradient") for b in bad), bad


def test_local_group_norm_statistics_are_caught(runs):
    """Planted fault: GroupNorm's statistics over each rank's own slab at 4
    ranks instead of the whole depth: the gradient check fails."""
    bad = _depth_disagreements(runs["four"][0]["depth_local_norms"], runs["single_depth"])
    assert any(b.startswith("gradient") for b in bad), bad


@pytest.mark.parametrize("fault", ["unet_halo_zero", "unet_local_norms"])
def test_unet3d_planted_faults_are_caught(runs, fault):
    """Planted faults at 4 ranks: the halos of one level-2 conv zero, and
    every InstanceNorm's statistics over each rank's own slab instead of the
    whole depth. Each fails the gradient check against the single process,
    and against JAX's GSPMD step."""
    got = runs["four"][0][fault]
    assert got["dim"] == 1
    for want, tol in ((runs["single_unet"]["unet"], UNET_SINGLE_TOL),
                      (runs["jax_unet"]["unet", 4], UNET_JAX_TOL)):
        bad = _unet_disagreements(got, want, tol)
        assert any(b.startswith("gradient") for b in bad), bad


def test_halo_exchange_gives_each_slab_its_neighbours():
    """Three slabs of 4 slices, the all-reduce emulated by hand: each slab
    gets ``d`` slices of its neighbours (zeros past the edges), at a
    dilation within a slab and ones spanning one and two slabs."""
    x = torch.arange(12.0).view(1, 12, 1)
    for d in (1, 3, 7, 9):
        slabs = [x[:, 4 * r : 4 * r + 4] for r in range(3)]
        padded = torch.nn.functional.pad(x, (0, 0, d, d))
        for r in range(3):
            want = padded[:, 4 * r : 4 * r + 4 + 2 * d]
            np.testing.assert_array_equal(_emulated_halo(slabs, r, d), want)


def _emulated_halo(slabs, rank, d):
    """halo_exchange's forward on rank ``rank`` of a 3-rank mesh, its
    all-reduce the sum of what each rank writes into the window buffer."""
    n, local = len(slabs), slabs[0].shape[1]
    windows = spatial._windows(n, local, d)
    total = None
    for r, slab in enumerate(slabs):
        buf = spatial._window_buffer(slab, windows, 1)
        for (_, lo, hi), off in zip(windows, spatial._offsets(windows)):
            a, b = max(lo, r * local), min(hi, (r + 1) * local)
            if a < b:
                buf.narrow(1, off + a - lo, b - a).copy_(slab.narrow(1, a - r * local, b - a))
        total = buf if total is None else total + buf
    mesh = Mesh({"data": n}, rank=rank)
    object.__setattr__(mesh, "all_reduce_", lambda t: t.copy_(total))
    return spatial.halo_exchange(slabs[rank], mesh, 1, d)


# ---- (e) placement ------------------------------------------------------------


def test_place_batch_branches_and_warning(caplog, monkeypatch):
    """Batch axis if it divides the mesh, else the depth axis (a model with
    a depth-sharded forward), else the whole batch with one warning."""
    monkeypatch.setattr(spatial, "_warned_replicate", False)
    mesh = Mesh({"data": 4}, rank=2)
    batch = TomogramBatch(np.arange(8 * 4 * 2).reshape(8, 4, 2), np.zeros((8, 4, 2)),
                          np.full((8,), 4))
    placed, sharding = place_batch(batch, mesh)
    assert sharding.dim == 0 and np.array_equal(placed.data, batch.data[4:6])
    assert np.array_equal(placed.num_slices, batch.num_slices[4:6])
    one = TomogramBatch(np.arange(16 * 3).reshape(1, 16, 3), np.zeros((1, 16, 2)),
                        np.array([16]))
    placed, sharding = place_batch(one, mesh)
    assert sharding.dim == 1 and np.array_equal(placed.data, one.data[:, 8:12])
    assert placed.label.shape == (1, 4, 2) and placed.num_slices.tolist() == [16]
    with caplog.at_level(logging.WARNING, logger=spatial.__name__):
        placed, sharding = place_batch(one, mesh, depth=False)
        assert sharding.dim is None and placed is one
        odd = TomogramBatch(np.zeros((1, 5, 3)), np.zeros((1, 5, 2)), np.array([5]))
        placed, sharding = place_batch(odd, mesh)
        assert sharding.dim is None and placed is odd
    assert len([r for r in caplog.records if "replicating" in r.message]) == 1
    # a mesh whose data axis is not the whole mesh replicates (no model parallelism)
    placed, sharding = place_batch(batch, Mesh({"data": 2, "model": 2}))
    assert sharding.dim is None


def test_place_batch_needs_slabs_of_the_models_multiple(caplog, monkeypatch):
    """A model whose slabs must be a multiple of ``multiple`` slices (UNet3D:
    8) gets the depth axis only when the depth divides ``n · multiple``;
    a depth that divides the mesh but not that is replicated, with one
    warning naming the pools, however often it comes."""
    monkeypatch.setattr(spatial, "_warned_slab", False)
    mesh = Mesh({"data": 4}, rank=1)
    one = TomogramBatch(np.arange(32 * 3).reshape(1, 32, 3), np.zeros((1, 32, 2)),
                        np.array([32]))
    placed, sharding = place_batch(one, mesh, multiple=8)
    assert sharding.dim == 1 and np.array_equal(placed.data, one.data[:, 8:16])
    half = TomogramBatch(one.data[:, :16], one.label[:, :16], np.array([16]))
    with caplog.at_level(logging.WARNING, logger=spatial.__name__):
        for _ in range(2):
            placed, sharding = place_batch(half, mesh, multiple=8)
            assert sharding.dim is None and placed is half
        assert place_batch(half, mesh, multiple=4)[1].dim == 1
    warned = [r.message for r in caplog.records if "replicating" in r.message]
    assert len(warned) == 1 and "a slab of 4 slices is not a multiple of the 8" in warned[0]


# ---- (f) the extractors -------------------------------------------------------


def test_sharded_dino_extractor_matches_jax_mesh_extractor(runs):
    """Batch 3 on 2 ranks (rounded to 4, the tail of 6 slices padded) in
    bf16, as JAX's extractor computes: every rank's gathered features within
    5e-2 of JAX's ``DinoExtractor(mesh=make_mesh({"data": 2}))`` (the
    tolerance of tests/test_torch_slice.py's extractor check) and equal on
    both ranks."""
    batch_size, want = runs["jax_dino"]
    ranks = [r["dino"] for r in runs["two"]]
    assert batch_size == 4 and {r["batch_size"] for r in ranks} == {4}
    got = ranks[0]["feats"].numpy()
    assert got.dtype == want.dtype == np.float16 and got.shape == want.shape == (64, 6, 2, 2)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=5e-2, rtol=0)
    assert torch.equal(ranks[1]["feats"], ranks[0]["feats"])


def test_sharded_sam_extractor_matches_the_single_process(runs):
    """``SamFeatureExtractor`` (tiny_test, f32) with batch 3 on 2 ranks
    (rounded to 4, tail padded) against the same extractor in one process:
    every FPN level and position encoding within fp16 rounding."""
    from cryovit_tpu_torch.models.sam2.config import SAM2Config
    from cryovit_tpu_torch.run.sam_features import SamFeatureExtractor, load_sam_encoder

    encoder = load_sam_encoder(random_init=True, cfg=SAM2Config.tiny_test(), device="cpu",
                               dtype=torch.float32)
    want = SamFeatureExtractor(encoder, batch_size=4).extract(runs["inputs"]["sam_stack"].numpy())
    for rank in runs["two"]:
        got = rank["sam"]
        assert got.keys() == want.keys()
        for key in want:
            for g, w in zip(got[key], want[key], strict=True):
                assert g.shape == w.shape and g.shape[0] == 5
                np.testing.assert_allclose(g.float().numpy(), w.astype(np.float32),
                                           atol=2e-3, rtol=2e-3, err_msg=key)


# ---- fit on a mesh ------------------------------------------------------------


def test_unet3d_fit_test_and_predict_take_the_depth_sharded_step(runs):
    """UNet3D's ``Trainer.fit`` (1 epoch, SWA, validation), ``test`` and
    ``predict`` on the 8-slice file (raw voxels padded to 32x64x64: 16
    slices a rank) over 2 ranks: every forward of each (train, validation,
    test, predict) takes the depth-sharded step; the logged epoch within
    f32 rounding of the single process (the thresholded metrics within
    METRIC_TOL: after an update a voxel near 0.5 may flip); the weights
    equal on both ranks; the test losses and metrics and every rank's
    gathered predictions, all of the trained weights, the single process's.
    (The updates are not held to PARAM_TOL as CryoVIT's are: AdamW's first
    step moves an element by about ±lr whatever its gradient's size, and
    UNet3D's conv biases before a norm, and a few elements of its weights,
    have gradients of rounding only, so their updates flip at random.)"""
    want = runs["single_fit_unet"]
    main, other = (r["fit_unet"] for r in runs["two"])
    assert set(want["dims"]) == {None}
    assert len(main["dims"]) == len(want["dims"]) == 4 and set(main["dims"]) == {1}
    assert other["history"] == [] and len(main["history"]) == len(want["history"])
    for g, w in zip(main["history"], want["history"]):
        for key, value in w.items():
            if "time" not in key:
                rtol = METRIC_TOL if "metric" in key else 1e-5
                np.testing.assert_allclose(g[key], value, rtol=rtol, atol=1e-6, err_msg=key)
    for name, p in main["params"].items():
        assert torch.equal(other["params"][name], p), name
    for rank in (main, other):
        ((losses, metrics, preds),), ((w_losses, w_metrics, w_preds),) = rank["test"], want["test"]
        for key, value in {**w_losses, **w_metrics}.items():
            rtol = METRIC_TOL if "metric" in key else 1e-4
            np.testing.assert_allclose({**losses, **metrics}[key], value, rtol=rtol, atol=1e-5,
                                       err_msg=key)
        assert preds[0].shape == w_preds[0].shape == (8, 32, 32)
        np.testing.assert_allclose(preds[0], w_preds[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(rank["predict"][0][0], want["predict"][0][0], rtol=0, atol=1e-4)


def test_fit_on_a_depth_sharded_mesh_matches_the_single_process(runs):
    """``Trainer.fit`` (3 epochs, SWA, validation) on one 8-slice file
    (depth padded to 32: batch 1, 16 slices a rank) over 2 ranks: the
    logged epochs within f32 rounding of the single process and the SWA
    weights' updates within PARAM_TOL of its; rank 0 alone logging, every
    rank holding the same logs and the same weights. Then ``test`` and
    ``predict`` on the mesh: every rank's losses, metrics and gathered
    predictions those of the single process."""
    want = runs["single_fit"]
    main, other = (r["fit"] for r in runs["two"])
    assert other["history"] == []
    assert {k: v for k, v in other["logged"].items() if "time" not in k} == {
        k: v for k, v in main["logged"].items() if "time" not in k}
    assert len(main["history"]) == len(want["history"])
    for g, w in zip(main["history"], want["history"]):
        assert g.keys() == w.keys()
        for key, value in w.items():
            if "time" not in key:
                np.testing.assert_allclose(g[key], value, rtol=1e-5, atol=1e-6, err_msg=key)
    assert _update_error(main["params"], want["params"], runs["inputs"]["fit_sd"]) <= PARAM_TOL
    for name, p in main["params"].items():
        assert torch.equal(other["params"][name], p), name
    for rank in (main, other):  # test and predict: global values, gathered predictions
        assert len(rank["test"]) == len(want["test"]) == 1
        for (losses, metrics, preds), (w_losses, w_metrics, w_preds) in zip(rank["test"],
                                                                             want["test"]):
            for key, value in {**w_losses, **w_metrics}.items():
                np.testing.assert_allclose({**losses, **metrics}[key], value, rtol=1e-4,
                                           atol=1e-5, err_msg=key)
            for g, w in zip(preds, w_preds, strict=True):
                assert g.shape == w.shape == (8, 32, 32)
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        for g, w in zip(rank["predict"], want["predict"], strict=True):
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-4)
