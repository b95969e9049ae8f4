"""Training the decoder: the port against the JAX package end to end.

- gradients of a masked Dice loss through the port's autograd Functions
  (plain versions of the backward kernels on the CPU) against ``jax.grad``
  of ``CryoVITModule``;
- the port's ``Trainer.fit`` (AdamW, SWA, validation) against the JAX
  ``Trainer.fit`` on one training-ready HDF5 file, from the same weights;
- ``cryovit-torch train --device cpu`` writing a ``.model`` that the JAX
  package opens and serves.

The decoder is full width; the inputs are a few slices of a small patch
grid. Everything runs on the CPU in f32.
"""

import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import torch

from cryovit_tpu.config import compose
from cryovit_tpu.models import CryoVIT as JaxCryoVIT
from cryovit_tpu.models.losses import DiceLoss as JaxDiceLoss
from cryovit_tpu.models.losses import dice_loss as jax_dice_loss
from cryovit_tpu.models.metrics import DiceMetric as JaxDiceMetric
from cryovit_tpu.models.metrics import F1Metric as JaxF1Metric
from cryovit_tpu.run.common import build_file_datamodule as jax_build_file_datamodule
from cryovit_tpu.train.checkpoint import load_model as jax_load_model
from cryovit_tpu.train.loop import Trainer as JaxTrainer
from cryovit_tpu.train.swa import StochasticWeightAveraging as JaxSWA
from cryovit_tpu.train.torch_import import convert_cryovit_state_dict
from cryovit_tpu_torch.cli.main import main
from cryovit_tpu_torch.config import TrainConfig, TrainerConfig
from cryovit_tpu_torch.convert import cryovit_from_jax
from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
from cryovit_tpu_torch.models.losses import dice_loss
from cryovit_tpu_torch.run.train_model import build_file_datamodule, build_model, build_trainer
from cryovit_tpu_torch.train.checkpoint import load_model

from test_torch_models import _decoder_variables, to_torch


def test_decoder_gradients_match_jax_grad(rng):
    """Masked Dice loss (one unlabeled slice) on 3 slices of a 2x3 patch
    grid: every parameter's gradient within 1e-4·max|ref| of
    ``jax.grad`` through ``CryoVITModule`` in f32, the loss within 1e-6."""
    feats = rng.standard_normal((1, 3, 2, 3, 1536)).astype(np.float32)
    module, variables = _decoder_variables(rng, feats)
    label = rng.integers(0, 2, size=(1, 3, 32, 48)).astype(np.float32)
    label[:, 0] = -1

    def loss_fn(v):
        y = jnp.asarray(label)
        return jax_dice_loss(module.apply(v, jnp.asarray(feats)), y, y > -1)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    want = cryovit_from_jax(want_grads)

    model = make_cryovit(to_torch(cryovit_from_jax(variables)), trainable=True)
    y = torch.from_numpy(label)
    loss = dice_loss(model(torch.from_numpy(feats)), y, y > -1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-6, rtol=0)
    got = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


class _Recorder:
    def __init__(self):
        self.history = []

    def log_scalars(self, scalars, step):
        self.history.append(dict(scalars, step=step))

    def series(self, key):
        return [h[key] for h in self.history if key in h]


def _training_file(tmp_path, rng):
    """A training-ready HDF5 (reference layout: ``data``, fp16
    ``dino_features (1536, D, h, w)``, ``labels/mito``) and its label file;
    4 slices on a 2x2 patch grid, the first slice unlabeled."""
    d, gh, gw = 4, 2, 2
    feats = (rng.standard_normal((1536, d, gh, gw)) * 0.3).astype(np.float16)
    label = rng.integers(0, 2, size=(d, 16 * gh, 16 * gw)).astype(np.int8)
    label[0] = -1
    (tmp_path / "tomos").mkdir()
    (tmp_path / "labels").mkdir()
    train_hdf, labels_hdf = tmp_path / "tomos" / "train.hdf", tmp_path / "labels" / "labels.hdf"
    with h5py.File(train_hdf, "w") as f:
        f.create_dataset("data", data=rng.random((d, 16 * gh, 16 * gw)))
        f.create_dataset("dino_features", data=feats)
        f.create_dataset("labels/mito", data=label)
    with h5py.File(labels_hdf, "w") as f:
        f.create_dataset("mito", data=label)
    return train_hdf, labels_hdf


def test_trainer_fit_matches_jax_trainer(tmp_path, rng):
    """6 epochs in f32 with SWA from 80 % and a validation epoch each, from
    the same initial weights (the port's seeded init, taken into JAX by
    ``convert_cryovit_state_dict``) on the same file: per-epoch
    ``train_dice_loss`` within 3e-4 and ``train_dice_metric`` within 1e-3,
    the final SWA-averaged predictions within 2e-3 (the tolerances of
    ``test_cryovit_torch_parity.py``)."""
    train_hdf, labels_hdf = _training_file(tmp_path, rng)
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(3))
    epochs = 6

    jcfg = compose(
        "train_model",
        ["model=cryovit", "datamodule=file", "label_key=mito", f"paths.exp_dir={tmp_path}"],
    )
    jdm = jax_build_file_datamodule(
        jcfg, data_paths=[train_hdf], data_labels=[labels_hdf], labels=["mito"]
    )
    jmodel = JaxCryoVIT(
        name="CryoVIT", input_key="dino_features", lr=1e-4, weight_decay=1e-3,
        losses={"dice_loss": JaxDiceLoss()},
        metrics={"dice_metric": JaxDiceMetric(0.5), "f1_metric": JaxF1Metric(0.5)},
        dtype=jnp.float32,
    )
    jrec = _Recorder()
    jtrainer = JaxTrainer(
        precision="f32", max_epochs=epochs, callbacks=[JaxSWA(swa_lrs=1e-4, swa_epoch_start=0.8)],
        loggers=[jrec], donate_state=False,
    )
    jvars = jax.tree_util.tree_map(
        jnp.asarray, convert_cryovit_state_dict({k: v.numpy() for k, v in sd.items()})
    )
    jstate = jtrainer.fit(jmodel, jdm, variables=jvars)

    cfg = TrainConfig(
        label_key="mito", trainer=TrainerConfig(precision="f32", max_epochs=epochs)
    )
    cfg = dataclasses.replace(cfg, dataloader=dataclasses.replace(cfg.dataloader, num_workers=2))
    rec = _Recorder()
    trainer = build_trainer(cfg, device="cpu")
    trainer.loggers.append(rec)
    module = trainer.fit(
        build_model(cfg),
        build_file_datamodule(cfg, [train_hdf], [labels_hdf], labels=["mito"]),
        variables=sd,
    )

    for key, tol in (("train_dice_loss", 3e-4), ("train_dice_metric", 1e-3)):
        got, want = rec.series(key), jrec.series(key)
        assert len(got) == len(want) == epochs
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=key)
    assert rec.series("val_dice_loss") and np.isfinite(rec.series("grad_norm")).all()
    assert set(rec.history[-1]) >= {"epoch_train_dice_loss", "val_f1_metric", "epoch_time_s"}

    batch, _ = next(iter(jdm.train_loader()))
    with torch.no_grad():
        got = module(torch.from_numpy(np.asarray(batch.data))).numpy()
    want = np.asarray(jmodel.apply(jstate.params, jnp.asarray(batch.data)))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_cli_train_writes_a_model_the_jax_package_serves(tmp_path, rng):
    """``cryovit-torch train --device cpu --num-epochs 2`` end to end: the
    ``.model`` (and its ``--export-torch`` twin) opens in the JAX package,
    and ``CryoVITModule`` on those weights predicts what the port does,
    within 5e-5 (f32)."""
    train_hdf, labels_hdf = _training_file(tmp_path, rng)
    out = tmp_path / "out"
    assert main([
        "train", str(train_hdf.parent), str(labels_hdf.parent), "mito", "--labels", "mito",
        "--num-epochs", "2", "--name", "cli", "--result-folder", str(out),
        "--export-torch", "--device", "cpu",
    ]) == 0
    assert (out / "cli.torch.model").exists()

    jmodel, jvars, model_type, name, label_key = jax_load_model(out / "cli.model")
    assert (model_type.value, name, label_key) == ("cryovit", "cli", "mito")
    module, *_ = load_model(out / "cli.model", device="cpu")
    feats = rng.standard_normal((1, 3, 2, 3, 1536)).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(feats)).numpy()
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(feats)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)
    trained = load_model(out / "cli.torch.model", device="cpu")[0].state_dict()
    for key, value in module.state_dict().items():
        torch.testing.assert_close(trained[key], value, rtol=0, atol=0)
