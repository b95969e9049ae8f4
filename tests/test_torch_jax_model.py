"""The JAX package's own ``.model`` and ``weights.msgpack`` in the port.

- ``train/msgpack.py`` against ``flax.serialization.msgpack_restore``, bit
  for bit: nested trees of f32, f16, bf16, int8, int32, bool arrays and
  numpy scalars, and chunked arrays (flax's ``MAX_CHUNK_SIZE`` patched down
  inside the test); other ext codes and unknown dtypes are refused.
- The JAX ``save_model`` of a CryoVIT, a UNet3D and a SAM2 ``tiny_test``
  loads through the port's ``load_model`` and predicts what JAX predicts,
  within the tolerances of ``tests/test_torch_models.py`` (1e-4),
  ``tests/test_torch_unet3d.py`` (1e-4) and ``tests/test_torch_sam2_train.py``
  (2e-3).
- ``cryovit-torch evaluate`` and ``infer`` on a JAX-written ``.model`` write
  what they write for the same weights in the reference torch format, and
  ``train --ckpt weights.msgpack`` starts from those weights.
"""

import sys

import flax.serialization as flax_serialization
import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cryovit_tpu.models import CryoVIT as JaxCryoVIT
from cryovit_tpu.models import UNet3D as JaxUNet3D
from cryovit_tpu.models.cryovit import CryoVITModule
from cryovit_tpu.models.losses import DiceLoss as JaxDiceLoss
from cryovit_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from cryovit_tpu.models.sam2.convert import convert_sam2_state_dict
from cryovit_tpu.models.sam2.family import SAM2 as JaxSAM2
from cryovit_tpu.models.unet3d import UNet3DModule
from cryovit_tpu.train.checkpoint import save_model as jax_save_model
from cryovit_tpu.train.checkpoint import save_weights as jax_save_weights
from cryovit_tpu.train.torch_export import save_torch_model
from cryovit_tpu.train.torch_import import convert_cryovit_state_dict, convert_unet3d_state_dict
from cryovit_tpu_torch.cli.main import main
from cryovit_tpu_torch.models import SAM2
from cryovit_tpu_torch.models.cryovit import random_cryovit_state_dict
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.model import random_sam2_state_dict
from cryovit_tpu_torch.models.unet3d import random_unet3d_state_dict
from cryovit_tpu_torch.run import train_model
from cryovit_tpu_torch.train.checkpoint import load_jax_weights, load_model
from cryovit_tpu_torch.train.msgpack import msgpack_restore
from cryovit_tpu_torch.types import ModelType

# ---- the reader -----------------------------------------------------------------------


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def _assert_same(want, got, path="tree"):
    """Equal trees: the same keys, types and values, arrays bit for bit
    (flax's bfloat16 against the port's torch.bfloat16 by their bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_same(want[key], got[key], f"{path}/{key}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            _assert_same(w, g, f"{path}/{i}")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype.name == "bfloat16":
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(want).view(np.uint16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


def test_msgpack_reader_matches_flax(rng):
    """Nested maps of f32, f16, bf16, int8, int32 and bool arrays, numpy
    scalars (f32, int64, bf16), Python scalars, strings, nil and a list."""
    tree = {
        "params": {
            "dense": {"kernel": rng.standard_normal((7, 5)).astype(np.float32),
                      "bias": rng.standard_normal(5).astype(np.float16)},
            "bf16": {"kernel": _bf16(rng.standard_normal((3, 4, 2)))},
            "ints": {"i8": rng.integers(-128, 128, (4, 3)).astype(np.int8),
                     "i32": rng.integers(-2**31, 2**31, (6,)).astype(np.int32)},
            "mask": rng.random((2, 3)) > 0.5,
            "empty": np.zeros((0, 4), np.float32),
        },
        "step": np.int64(-12), "lr": np.float32(3e-4), "scale": jnp.bfloat16(0.3),
        "epoch": 7, "big": 2**40, "neg": -1000, "ratio": 0.125, "name": "mito ü",
        "none": None, "flag": True, "shape": [1, 2.5, "x"],
    }
    data = flax_serialization.msgpack_serialize(tree)
    _assert_same(flax_serialization.msgpack_restore(data), msgpack_restore(data))


def test_msgpack_reader_joins_chunked_arrays(rng, monkeypatch):
    """Arrays over flax's ``MAX_CHUNK_SIZE`` (patched down to 64 bytes
    here; 2^30 in use) are written as ``__msgpack_chunked_array__`` dicts
    and joined back: f32 and bf16, nested and at the top of the tree."""
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"w": rng.standard_normal((9, 11)).astype(np.float32),
                       "b": _bf16(rng.standard_normal(100)), "small": np.ones(3, np.float32)}}
    data = flax_serialization.msgpack_serialize(tree)
    assert data.count(b"__msgpack_chunked_array__") == 2
    _assert_same(flax_serialization.msgpack_restore(data), msgpack_restore(data))
    top = flax_serialization.msgpack_serialize(rng.standard_normal((5, 7)).astype(np.float32))
    _assert_same(flax_serialization.msgpack_restore(top), msgpack_restore(top))


@pytest.mark.parametrize("leaf, match", [
    (complex(1, 2), "ext type 2"),
    (np.asarray(jnp.ones(3, jnp.float8_e4m3fn)), "float8_e4m3fn"),
])
def test_msgpack_reader_refuses_what_flax_weights_do_not_hold(leaf, match):
    """A complex number (ext 2) and a dtype numpy does not know raise."""
    data = flax_serialization.msgpack_serialize({"x": leaf})
    with pytest.raises(ValueError, match=match):
        msgpack_restore(data)


# ---- the JAX package's .model ----------------------------------------------------------

LOSSES = {"dice_loss": JaxDiceLoss()}


def _cryovit():
    """(JAX family, variables, reference state dict, its forward on one
    input): the decoder at full width, mask head scaled so probabilities
    spread over (0, 1)."""
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(12))
    sd["output_layer.2.weight"] *= 40.0
    variables = convert_cryovit_state_dict({k: v.numpy() for k, v in sd.items()})
    feats = np.random.default_rng(13).standard_normal((1, 3, 2, 3, 1536)).astype(np.float32)
    want = np.asarray(CryoVITModule(dtype=jnp.float32, remat=False).apply(
        variables, jnp.asarray(feats)))
    family = JaxCryoVIT(name="CryoVIT", input_key="dino_features", lr=1e-4, losses=LOSSES,
                        metrics={}, dtype=jnp.float32)
    return family, variables, lambda module: module(torch.from_numpy(feats)).numpy(), want, 1e-4


def _unet3d():
    rng = np.random.default_rng(5)
    sd = random_unet3d_state_dict(torch.Generator().manual_seed(4))
    sd = {k: (v.numpy() + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
              if v.dim() == 1 else v.numpy()) for k, v in sd.items()}
    variables = jax.tree_util.tree_map(jnp.asarray, convert_unet3d_state_dict(sd))
    x = rng.standard_normal((1, 16, 32, 32, 1)).astype(np.float32)
    want = np.asarray(jax.jit(UNet3DModule(dtype=jnp.float32).apply)(variables, jnp.asarray(x)))
    family = JaxUNet3D(name="UNet3D", input_key="data", lr=3e-3, losses=LOSSES, metrics={})
    return family, variables, lambda module: module(torch.from_numpy(x)).numpy(), want, 1e-4


def _sam2():
    """SAM2 at ``tiny_test`` with one cond slice (the config the port reads
    off a test-width artifact's shapes), on 3 slices of 64²; seeded weights
    as in ``tests/test_torch_sam2_train.py``."""
    rng = np.random.default_rng(21)
    sd = {k: v.numpy() + 0.05 * rng.standard_normal(v.shape).astype(np.float32)
          for k, v in random_sam2_state_dict(SAM2Config.tiny_test(),
                                             torch.Generator().manual_seed(20)).items()}
    sd["model.sam_mask_decoder.pred_obj_score_head.layers.2.bias"][:] = 3.0
    variables = jax.tree_util.tree_map(
        jnp.asarray, convert_sam2_state_dict(sd, JaxSAM2Config.tiny_test()))
    custom = {"test_config": True, "num_init_cond_slices": (1, 1)}
    jax_fam = JaxSAM2(name="SAM2", input_key="data", lr=1e-3, losses=LOSSES, metrics={},
                      custom_kwargs=dict(custom))
    fam = SAM2(name="SAM2", input_key="data", lr=1e-3, losses={}, metrics={},
               custom_kwargs=dict(custom))
    x = rng.random((1, 3, 64, 64, 1)).astype(np.float32)
    inputs = {"slices": jnp.asarray(x), "order": jnp.asarray([1, 0, 2]),
              "num_cond": jnp.asarray(1)}
    want = np.asarray(jax_fam.apply(variables, inputs))
    tin = {"slices": torch.from_numpy(x), "order": [1, 0, 2], "num_cond": 1}
    return jax_fam, variables, lambda module: fam.apply(module.eval(), tin).numpy(), want, 2e-3


FAMILIES = {"cryovit": _cryovit, "unet3d": _unet3d, "sam2": _sam2}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_jax_model_loads_and_predicts_as_jax(family, tmp_path):
    """The JAX package's ``save_model`` (flax msgpack weights in its
    ``SavedModel`` pickle) → the port's ``load_model``: name, type, label
    key, and the predictions of JAX's module on the same input."""
    jax_family, variables, predict, want, tol = FAMILIES[family]()
    path = tmp_path / f"{family}.model"
    jax_save_model("jax_mito", "mito", jax_family, variables, {"name": family}, path)
    assert b"cryovit_tpu.train.checkpoint" in path.read_bytes()
    module, model_type, name, label_key = load_model(path, device="cpu")
    assert (model_type, name, label_key) == (ModelType(family), "jax_mito", "mito")
    with torch.no_grad():
        got = predict(module)
    assert got.shape == want.shape and want.std() > 0.01
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def test_jax_weights_msgpack_gives_the_reference_state_dict(tmp_path):
    """``save_weights`` of CryoVIT and UNet3D variables → the state dict the
    bridges give, bit for bit, for the model type named."""
    for make in (_cryovit, _unet3d):
        family, variables, *_ = make()
        path = tmp_path / "weights.msgpack"
        jax_save_weights(path, variables)
        got = load_jax_weights(path, family.model_type.value)
        want = load_model(_torch_model(tmp_path, family, variables), device="cpu")[0].state_dict()
        assert set(got) == set(want)
        for key in want:
            assert torch.equal(got[key], want[key]), key


def _torch_model(root, family, variables):
    return save_torch_model("ref", "mito", family, variables, root / "ref.model")


# ---- the CLI on JAX-written files ----------------------------------------------------


@pytest.fixture(scope="module")
def tomograms(tmp_path_factory):
    """Two 8×64×64 feature files (f32 ``dino_features``) and their labels;
    a CryoVIT decoder as the JAX package's ``.model`` and ``weights.msgpack``
    and, the same weights, as its reference-format ``.model``."""
    root = tmp_path_factory.mktemp("jax_model")
    rng = np.random.default_rng(11)
    (root / "tomos").mkdir()
    (root / "labels").mkdir()
    for i in range(2):
        with h5py.File(root / "tomos" / f"t{i}.hdf", "w") as f:
            f.create_dataset("data", data=rng.random((8, 64, 64)).astype(np.float32))
            f.create_dataset("dino_features", data=(
                rng.standard_normal((1536, 8, 4, 4)) * 0.5).astype(np.float32))
        label = rng.integers(0, 2, size=(8, 64, 64)).astype(np.int8)
        label[0] = -1
        with h5py.File(root / "labels" / f"t{i}.hdf", "w") as f:
            f.create_dataset("mito", data=label)
    family, variables, *_ = _cryovit()
    jax_save_model("mito_net", "mito", family, variables, {"name": "CryoVIT"},
                   root / "jax" / "mito_net.model")
    save_torch_model("mito_net", "mito", family, variables, root / "torch" / "mito_net.model")
    jax_save_weights(root / "weights.msgpack", variables)
    return root


def test_cli_evaluate_and_infer_take_the_jax_model(tomograms):
    """``evaluate`` and ``infer`` (file-based) on the JAX-written ``.model``
    write the same metrics CSV and masks as on the reference-format one."""
    root = tomograms
    outputs = {}
    for fmt in ("jax", "torch"):
        model = str(root / fmt / "mito_net.model")
        assert main(["evaluate", str(root / "tomos"), str(root / "labels"), model, "--labels",
                     "mito", "--result-folder", str(root / f"eval_{fmt}"),
                     "--device", "cpu"]) == 0
        assert main(["infer", str(root / "tomos"), "--model", model, "--result-folder",
                     str(root / f"infer_{fmt}"), "--device", "cpu"]) == 0
        csv = (root / f"eval_{fmt}" / "results" / "mito_net" / "tomos.csv").read_text()
        masks = []
        for path in sorted((root / f"infer_{fmt}").rglob("t*.hdf")):
            with h5py.File(path) as f:
                masks.append(np.asarray(f["mito_preds"]))
        outputs[fmt] = csv, masks
    assert outputs["jax"][0] == outputs["torch"][0] and "t0.hdf" in outputs["jax"][0]
    assert len(outputs["jax"][1]) == 2
    for got, want in zip(*(outputs[f][1] for f in ("jax", "torch"))):
        assert got.dtype == np.uint8 and got.shape == (8, 64, 64)
        np.testing.assert_array_equal(got, want)


class _Started(Exception):
    pass


def test_cli_train_ckpt_takes_jax_weights_msgpack(tomograms, monkeypatch):
    """``train --ckpt weights.msgpack`` hands ``Trainer.fit`` the JAX
    weights as the reference state dict (recorded, then the run stops)."""
    root = tomograms
    seen = {}

    def fit(self, model, datamodule, variables=None, **kw):
        seen["variables"] = variables
        raise _Started

    monkeypatch.setattr(train_model.Trainer, "fit", fit)
    with pytest.raises(_Started):
        main(["train", str(root / "tomos"), str(root / "labels"), "mito", "--labels", "mito",
              "--ckpt", str(root / "weights.msgpack"), "--num-epochs", "1",
              "--result-folder", str(root / "train"), "--device", "cpu"])
    want = load_model(root / "torch" / "mito_net.model", device="cpu")[0].state_dict()
    got = seen["variables"]
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def test_the_jax_model_is_read_without_jax_or_flax(tomograms, monkeypatch):
    """The unpickler maps the JAX package's ``SavedModel`` and ``ModelType``
    by name: with ``cryovit_tpu``, ``jax``, ``flax`` and ``msgpack`` made
    unimportable, the JAX ``.model`` still loads."""
    for name in list(sys.modules):
        if name.split(".")[0] in ("cryovit_tpu", "jax", "flax", "msgpack"):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(sys, "meta_path", [_Refuse(), *sys.meta_path])
    with pytest.raises(ImportError):
        __import__("flax")
    module, model_type, *_ = load_model(tomograms / "jax" / "mito_net.model", device="cpu")
    assert model_type == ModelType.CRYOVIT and len(module.state_dict()) > 0


class _Refuse:
    """An import hook that refuses the JAX side's packages."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("cryovit_tpu", "jax", "flax", "msgpack"):
            raise ImportError(f"{name} is not importable in this test")
        return None
