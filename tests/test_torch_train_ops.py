"""The port's training pieces against the JAX package, one module at a time:
the backward kernels' plain versions (JAX Pallas kernels in interpret mode),
the losses and metrics, the random crop, the batch collation and the
training config's defaults; and the Trainer's ``last.ckpt`` resume.

Inputs come from a seeded numpy generator and go to both packages
unchanged.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.config import compose
from cryovit_tpu.data.datasets import random_crop as jax_random_crop
from cryovit_tpu.data.pipeline import BucketSpec as JaxBucketSpec
from cryovit_tpu.data.pipeline import collate as jax_collate
from cryovit_tpu.models import losses as jax_losses
from cryovit_tpu.models import metrics as jax_metrics
from cryovit_tpu.ops.conv3d_dm import conv3d_dm_dw as jax_conv3d_dm_dw
from cryovit_tpu.ops.convt_dm import convt2x_dm_bwd as jax_convt2x_dm_bwd
from cryovit_tpu.types import TomogramData as JaxTomogramData
from cryovit_tpu_torch.config import TrainConfig
from cryovit_tpu_torch.data import BucketSpec, collate, random_crop
from cryovit_tpu_torch.models import losses, metrics
from cryovit_tpu_torch.ops.conv3d_dm import conv3d_dm_dw_reference
from cryovit_tpu_torch.ops.convt_dm import convt2x_dm_bwd
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.types import TomogramData


@pytest.mark.parametrize(
    "b,d,ci,co,h,dil",
    [(1, 4, 8, 1, 3, 1), (1, 5, 16, 8, 2, 2), (2, 5, 8, 16, 2, 4), (1, 3, 8, 8, 2, 5)],
)
def test_conv3d_dw_plain_matches_pallas_dw_kernel(rng, b, d, ci, co, h, dil):
    """f32 at W = 128 (the Pallas kernel's gate), dilations 1, 2, 4 and
    5 > D = 3 (only the centre depth tap sees planes), 8 → 1 (the mask
    head) among them; within 1e-4·max|ref|: the same sums in another
    order."""
    x = rng.standard_normal((b, d, ci, h, 128)).astype(np.float32)
    g = rng.standard_normal((b, d, co, h, 128)).astype(np.float32)
    want = np.asarray(
        jax_conv3d_dm_dw(jnp.asarray(x), jnp.asarray(g), (dil, 1, 1), interpret=True)
    )
    got = conv3d_dm_dw_reference(torch.from_numpy(x), torch.from_numpy(g), (dil, 1, 1)).numpy()
    assert got.shape == want.shape == (3, 3, 3, ci, co)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("ci,co,h", [(16, 8, 3), (32, 32, 2)])
def test_convt_bwd_plain_matches_pallas_bwd_kernel(rng, ci, co, h):
    """bf16 at W = 128 (the Pallas kernel's gate), through the port's
    wrapper on CPU tensors: dx and dW within 2^-6·max|ref| (bf16 inputs,
    f32 sums, dx rounded to bf16 in both)."""
    x = rng.standard_normal((1, 2, ci, h, 128)).astype(np.float32)
    g = rng.standard_normal((1, 2, co, 2 * h, 256)).astype(np.float32)
    k = (rng.standard_normal((1, 2, 2, ci, co)) / np.sqrt(ci)).astype(np.float32)
    bf = jnp.bfloat16
    want_dx, want_dw = jax_convt2x_dm_bwd(
        jnp.asarray(g, bf), jnp.asarray(x, bf), jnp.asarray(k, bf), interpret=True
    )
    to_bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    dx, dw = convt2x_dm_bwd(to_bf(g), to_bf(x), to_bf(k))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    for got, want in ((dx.float().numpy(), np.asarray(want_dx, np.float32)),
                      (dw.numpy(), np.asarray(want_dw, np.float32))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2.0**-6 * np.abs(want).max(), rtol=0)


def _loss_inputs(rng):
    pred = rng.random((2, 3, 8, 8)).astype(np.float32)
    label = rng.integers(-1, 2, size=(2, 3, 8, 8)).astype(np.int8)
    return pred, label, label > -1


@pytest.mark.parametrize(
    "name,port_fn,jax_fn",
    [
        ("dice_loss", losses.dice_loss, jax_losses.dice_loss),
        ("focal_loss", losses.focal_loss, jax_losses.focal_loss),
        ("dice_metric", metrics.dice_metric, jax_metrics.dice_metric),
        ("f1_metric", metrics.f1_metric, jax_metrics.f1_metric),
    ],
)
def test_losses_and_metrics_match_jax(rng, name, port_fn, jax_fn):
    """Masked f32 losses and metrics on labels with −1 voxels; within 1e-6."""
    pred, label, mask = _loss_inputs(rng)
    pred[0, 0, 0, :4] = 0.5  # exactly at the threshold
    want = float(jax_fn(jnp.asarray(pred), jnp.asarray(label), jnp.asarray(mask)))
    got = float(port_fn(torch.from_numpy(pred), torch.from_numpy(label), torch.from_numpy(mask)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0, err_msg=name)


@pytest.mark.parametrize("feature_space,shape", [(True, (140, 40, 36, 3)), (False, (6, 530, 515, 1))])
def test_random_crop_draws_the_same_crop(rng, feature_space, shape):
    """The same generator seed gives the same crop in both packages."""
    data = rng.standard_normal(shape).astype(np.float32)
    scale = 16 if feature_space else 1
    label = rng.integers(-1, 2, size=(shape[0], shape[1] * scale, shape[2] * scale)).astype(np.int8)
    got = random_crop(data, label, feature_space=feature_space, rng=np.random.default_rng(5))
    want = jax_random_crop(data, label, feature_space=feature_space, rng=np.random.default_rng(5))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    side = 32 if feature_space else 512
    assert got[0].shape[:3] == (min(shape[0], 128), side, side)


def test_collate_pads_like_jax(rng):
    """Two feature volumes of different sizes bucket to the same shapes:
    data padded with 0, labels with −1."""
    items = []
    for d, h, w in ((3, 2, 3), (5, 4, 2)):
        data = rng.standard_normal((d, h, w, 6)).astype(np.float32)
        label = rng.integers(0, 2, size=(d, 16 * h, 16 * w)).astype(np.int8)
        items.append((data, label))
    got, _ = collate([TomogramData("s", "t", None, a, b) for a, b in items],
                     BucketSpec.for_input("dino_features"))
    want, _ = jax_collate([JaxTomogramData("s", "t", None, a, b) for a, b in items],
                          JaxBucketSpec.for_input("dino_features"))
    for name in ("data", "label", "num_slices"):
        np.testing.assert_array_equal(getattr(got, name), np.asarray(getattr(want, name)), err_msg=name)
    assert got.label.shape == (2, 32, 64, 64) and got.label[0, 3:].max() == -1


def test_train_config_defaults_equal_the_jax_composed_config():
    """Every default of the port's recipe equals the value the JAX package
    composes for ``train_model`` with ``model=cryovit`` and
    ``datamodule=file``."""
    want = compose("train_model", ["model=cryovit", "datamodule=file", "label_key=mito"])
    cfg = TrainConfig(label_key="mito")
    assert cfg.run_name == want.name and cfg.random_seed == want.random_seed
    m = cfg.model
    assert (m.name, m.input_key, m.lr, m.weight_decay) == (
        want.model.name, want.model.input_key, want.model.lr, want.model.weight_decay
    )
    assert list(m.losses) == list(want.model.losses)
    assert list(m.metrics) == list(want.model.metrics)
    assert m.metric_threshold == want.model.metrics.dice_metric.threshold
    assert "threshold" not in want.model.metrics.f1_metric  # F1's default: 0.5
    assert metrics.F1Metric().threshold == m.metric_threshold
    for key, value in vars(cfg.trainer).items():
        assert want.trainer[key] == value, key
    swa = want.callbacks.stochastic_weight_average
    assert cfg.swa.swa_epoch_start == swa.swa_epoch_start
    # the constants the port's SWA implements: constant lr, no annealing
    assert (swa.swa_lrs, swa.annealing_epochs) == (m.lr, 0)
    for key, value in vars(cfg.dataloader).items():
        assert want.datamodule.dataloader[key] == value, key
    assert want.datamodule.dataset.input_key == m.input_key


class _ArrayDataModule:
    """One in-memory feature volume (3 slices, 2x2 patches of 8 channels)
    through the port's DataLoader and collate."""

    def __init__(self, rng):
        from cryovit_tpu_torch.data import DataLoader

        item = TomogramData(
            "s", "t", None, rng.standard_normal((3, 2, 2, 8)).astype(np.float32),
            rng.integers(0, 2, size=(3, 32, 32)).astype(np.int8),
        )
        self.loader = lambda: DataLoader(
            [item], num_workers=0, collate_fn=lambda items: collate(items, BucketSpec(4, 2, 32))
        )

    def train_loader(self):
        return self.loader()

    def val_loader(self):
        return self.loader()


def test_trainer_resumes_from_last_ckpt(rng, tmp_path):
    """``enable_checkpointing`` writes ``last.ckpt`` after each epoch; a new
    Trainer given it continues at the next epoch with the saved model,
    optimizer and step count, and ends where an uninterrupted run ends."""
    from cryovit_tpu_torch.run.train_model import build_model

    cfg = TrainConfig(label_key="mito")
    cfg = dataclasses.replace(cfg, trainer=dataclasses.replace(cfg.trainer, precision="f32"))
    dm = _ArrayDataModule(rng)

    def fit(epochs, ckpt=None, root=None):
        trainer = Trainer(precision="f32", max_epochs=epochs, device="cpu", seed=1,
                          enable_checkpointing=root is not None, default_root_dir=root)
        module = trainer.fit(build_model(cfg), dm, ckpt_path=ckpt)
        return trainer, {k: v.detach().clone() for k, v in module.state_dict().items()}

    _, straight = fit(3)
    first, _ = fit(2, root=tmp_path)
    assert (tmp_path / "last.ckpt").exists() and first.step == 2
    resumed, weights = fit(3, ckpt=tmp_path / "last.ckpt")
    assert resumed.step == 3
    for key, value in straight.items():
        torch.testing.assert_close(weights[key], value, rtol=0, atol=1e-6)
