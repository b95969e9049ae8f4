"""The UNet3D baseline: the port against the JAX package's ``UNet3DModule``.

On 1×16×32×32 raw voxels in f32 on the CPU (the depth-major level 1 runs
the plain versions of ``conv3d_dm`` / ``conv3d_dm_dw``):

- :func:`unet3d_from_jax` writes what ``export_unet3d_state_dict`` writes,
  and the port loads it strictly;
- the forward pass within 1e-4 of ``UNet3DModule.apply``;
- a masked Dice loss's gradients within 1e-3 of ``jax.grad``'s, relative to
  each tensor's norm (for the biases of convs followed by a norm, whose
  gradients are zero up to rounding, relative to the largest norm);
- ``cryovit-torch train --model unet3d --device cpu`` writes a ``.model``
  that the JAX package serves with the same forward within 5e-5, and that
  ``cryovit-torch evaluate`` scores.

The JAX variables are the port's seeded init taken into JAX's tree by
``convert_unet3d_state_dict`` (flax's eager init of the full-width U-Net
takes half a minute on the CPU).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cryovit_tpu.models.losses import dice_loss as jax_dice_loss
from cryovit_tpu.models.unet3d import UNet3DModule
from cryovit_tpu.train.checkpoint import load_model as jax_load_model
from cryovit_tpu.train.torch_export import export_unet3d_state_dict
from cryovit_tpu.train.torch_import import convert_unet3d_state_dict
from cryovit_tpu_torch.cli.main import main
from cryovit_tpu_torch.convert import unet3d_from_jax
from cryovit_tpu_torch.models.losses import dice_loss
from cryovit_tpu_torch.models.unet3d import (
    UNet3D,
    _InstanceNorm,
    make_unet3d,
    random_unet3d_state_dict,
)
from cryovit_tpu_torch.train.checkpoint import load_model

SHAPE = (1, 16, 32, 32, 1)


@pytest.fixture(scope="module")
def weights():
    """(JAX variables, their reference state dict, inputs) from the port's
    seeded init."""
    rng = np.random.default_rng(5)
    sd = random_unet3d_state_dict(torch.Generator().manual_seed(4))
    sd = {k: (v.numpy() + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
              if v.dim() == 1 else v.numpy()) for k, v in sd.items()}
    variables = jax.tree_util.tree_map(jnp.asarray, convert_unet3d_state_dict(sd))
    x = rng.standard_normal(SHAPE).astype(np.float32)
    return variables, sd, x


def _port(sd, **kwargs):
    return make_unet3d({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                       **kwargs)


def test_unet3d_from_jax_equals_the_export_and_loads_strictly(weights):
    variables, _, _ = weights
    got, want = unet3d_from_jax(variables), export_unet3d_state_dict(variables)
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    with torch.device("meta"):
        template = UNet3D().state_dict()
    assert {k: tuple(v.shape) for k, v in template.items()} == {
        k: v.shape for k, v in got.items()}
    _port(got)  # load_state_dict(strict=True)


def test_unet3d_forward_matches_jax(weights):
    variables, sd, x = weights
    want = np.asarray(jax.jit(UNet3DModule(dtype=jnp.float32).apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(sd)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == SHAPE[:4] and got.dtype == np.float32
    assert want.std() > 0.01
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_unet3d_dice_gradients_match_jax_grad(weights):
    """Masked Dice loss (first slice unlabeled): the loss within 1e-6 and
    every parameter's gradient within relative L2 error 1e-3."""
    variables, sd, x = weights
    rng = np.random.default_rng(6)
    label = rng.integers(0, 2, size=SHAPE[:4]).astype(np.float32)
    label[:, 0] = -1
    module = UNet3DModule(dtype=jnp.float32)

    def loss_fn(v):
        y = jnp.asarray(label)
        return jax_dice_loss(module.apply(v, jnp.asarray(x)), y, y > -1)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(variables)
    want = unet3d_from_jax(want_grads)

    model = _port(sd, trainable=True)
    y = torch.from_numpy(label)
    loss = dice_loss(model(torch.from_numpy(x)), y, y > -1)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=1e-6, rtol=0)
    largest = max(np.linalg.norm(w) for w in want.values())
    got = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, w in want.items():
        scale = max(np.linalg.norm(w), 1e-3 * largest)
        assert np.linalg.norm(got[name] - w) <= 1e-3 * scale, name


@pytest.mark.parametrize("channel_dim,shape", [(1, (2, 3, 4, 5, 6)), (2, (2, 4, 3, 5, 6))])
def test_instance_norm_function_matches_autograd(channel_dim, shape):
    """:class:`_InstanceNorm`'s hand-written backward against autograd
    through the same math, in float64 (``gradcheck``)."""
    gen = torch.Generator().manual_seed(channel_dim)
    c = shape[channel_dim]
    x = (torch.randn(shape, generator=gen, dtype=torch.float64) * 3 + 1).requires_grad_()
    w = torch.randn(c, generator=gen, dtype=torch.float64).requires_grad_()
    b = torch.randn(c, generator=gen, dtype=torch.float64).requires_grad_()
    torch.autograd.gradcheck(lambda *a: _InstanceNorm.apply(*a, channel_dim, 1e-3), (x, w, b))


def test_random_init_follows_flax_laws():
    """lecun-normal kernels (std 1/sqrt(fan_in), fan-in over input channels
    and taps, the ConvTranspose's too), zero biases, unit norm scales."""
    sd = random_unet3d_state_dict(torch.Generator().manual_seed(0))
    checks = {"bottom_layer.0.weight": 256 * 27, "synthesis_layers.0.upconv.0.weight": 256 * 8,
              "synthesis_layers.0.layers.0.proj.weight": 320, "analysis_layers.1.pool.0.weight":
              64 * 8}
    for name, fan_in in checks.items():
        assert abs(sd[name].std().item() * fan_in**0.5 - 1.0) < 0.05, name
    assert not sd["bottom_layer.0.bias"].any()
    assert torch.equal(sd["bottom_layer.1.weight"], torch.ones(384))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``cryovit-torch train --model unet3d --device cpu`` for 2 epochs on
    one 16×64×64 raw tomogram with blob labels."""
    root = tmp_path_factory.mktemp("unet3d")
    rng = np.random.default_rng(8)
    (root / "tomos").mkdir()
    (root / "labels").mkdir()
    vol = rng.integers(0, 255, size=(16, 64, 64)).astype(np.uint8)
    label = (vol > 127).astype(np.int8)
    label[0] = -1
    with h5py.File(root / "tomos" / "t.hdf", "w") as f:
        f.create_dataset("data", data=vol)
    with h5py.File(root / "labels" / "t.hdf", "w") as f:
        f.create_dataset("mito", data=label)
    assert main([
        "train", str(root / "tomos"), str(root / "labels"), "mito", "--labels", "mito",
        "--model", "unet3d", "--num-epochs", "2", "--name", "unet", "--result-folder",
        str(root / "out"), "--device", "cpu",
    ]) == 0
    return root


def test_cli_train_unet3d_writes_a_model_the_jax_package_serves(trained):
    jmodel, jvars, model_type, name, label_key = jax_load_model(trained / "out" / "unet.model")
    assert (model_type.value, name, label_key) == ("unet3d", "unet", "mito")
    module, port_type, *_ = load_model(trained / "out" / "unet.model", device="cpu")
    assert port_type.value == "unet3d" and isinstance(module, UNet3D)
    x = np.random.default_rng(9).random(SHAPE).astype(np.float32)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(jvars, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


def test_cli_evaluate_scores_the_unet3d_model(trained):
    assert main([
        "evaluate", str(trained / "tomos"), str(trained / "labels"),
        str(trained / "out" / "unet.model"), "--labels", "mito", "--result-folder",
        str(trained / "eval"), "--device", "cpu",
    ]) == 0
    frame = pd.read_csv(trained / "eval" / "results" / "unet" / "tomos.csv")
    assert list(frame.columns) == ["sample", "tomo_name", "dice_metric", "f1_metric"]
    assert frame[["sample", "tomo_name"]].values.tolist() == [["tomos", "t.hdf"]]
    assert np.isfinite(frame[["dice_metric", "f1_metric"]].to_numpy()).all()
