"""The port's serving path as a whole against the JAX package: raw MRC
tomogram → DINOv2 → CryoVIT decoder → thresholded masks, plus the ``.model``
artifact in both directions and the feature extractor.

A small backbone (2 blocks, 2 heads of 64) stands in for ViT-g; the decoder
is full width. Everything runs on the CPU, in f32 except where a JAX entry
point fixes bf16.
"""

import functools
import pickle

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cryovit_tpu.models.fused as jax_fused
from cryovit_tpu.models import CryoVIT as JaxCryoVITFamily
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.models.dinov2 import make_dinov2 as jax_make_dinov2
from cryovit_tpu.models.losses import DiceLoss
from cryovit_tpu.models.metrics import DiceMetric
from cryovit_tpu.run.dino_features import DinoExtractor as JaxDinoExtractor
from cryovit_tpu.run.infer_model import _run_fused_inference as jax_run_fused_inference
from cryovit_tpu.train.checkpoint import load_model as jax_load_model
from cryovit_tpu.train.checkpoint import save_model as jax_save_model
from cryovit_tpu.train.torch_export import save_torch_model
from cryovit_tpu_torch.convert import IMAGENET_MEAN, cryovit_from_jax, dinov2_from_jax
from cryovit_tpu_torch.data.transforms import pad_slices_to_multiple
from cryovit_tpu_torch.io import load_data, write_mrc
from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2
from cryovit_tpu_torch.run.dino_features import TORCH_HUB_WEIGHTS, DinoExtractor, run_dino
from cryovit_tpu_torch.run.infer_model import load_fused, run_inference
from cryovit_tpu_torch.train.checkpoint import load_model, save_model

from test_torch_models import SMALL, _decoder_variables, randomize, to_torch

THRESHOLD = 0.5


def _jax_family():
    return JaxCryoVITFamily(
        "slice", "dino_features", lr=1e-4,
        losses={"dice_loss": DiceLoss()}, metrics={"dice_metric": DiceMetric()},
    )


def _hub_state_dict(port_sd):
    """A torch hub checkpoint (3-channel patch embed) that folds, with
    ImageNet normalization, back to ``port_sd``'s one-channel patch embed:
    each channel carries the weight times its std / 3, and the bias gains
    mean(ImageNet mean)·ΣW."""
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    w1 = torch.as_tensor(port_sd["patch_embed.proj.weight"])  # (E, 1, p, p)
    hub = {k: torch.as_tensor(v) for k, v in port_sd.items()}
    hub["patch_embed.proj.weight"] = w1 * std / 3.0
    hub["patch_embed.proj.bias"] = (
        torch.as_tensor(port_sd["patch_embed.proj.bias"]) + np.mean(IMAGENET_MEAN) * w1.sum((1, 2, 3))
    )
    return hub


@pytest.fixture(scope="module")
def slice_env(tmp_path_factory):
    """A 4x128x128 MRC tomogram, random small-backbone and decoder weights,
    the decoder written by the JAX package's ``save_torch_model`` and the
    backbone as a torch hub checkpoint."""
    tmp = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(11)
    raw = tmp / "tomos" / "t0.mrc"
    raw.parent.mkdir()
    write_mrc(raw, rng.integers(0, 255, size=(4, 128, 128)).astype(np.int16))

    jcfg = JaxDinoV2Config(**SMALL)
    dino = jax_make_dinov2(jcfg, use_flash_attention=False)
    dino_vars = randomize(dino.init(jax.random.key(0), jnp.zeros((1, 28, 28))), rng)
    _, dec_vars = _decoder_variables(rng, np.zeros((1, 1, 1, 1, SMALL["embed_dim"]), np.float32))
    model_path = save_torch_model("slice", "mito", _jax_family(), dec_vars, tmp / "slice.model")

    model_dir = tmp / "dino"
    model_dir.mkdir()
    torch.save(_hub_state_dict(dinov2_from_jax(dino_vars)), model_dir / TORCH_HUB_WEIGHTS)
    return dict(tmp=tmp, raw=raw, jcfg=jcfg, dino_vars=dino_vars, dec_vars=dec_vars,
                model_path=model_path, model_dir=model_dir)


def test_fused_inference_matches_jax(slice_env, monkeypatch):
    """``run_inference(fused=True)`` against the JAX ``_run_fused_inference``
    (both in f32): probabilities within atol 1e-3; thresholded masks agree on
    at least 99.9 % of voxels, and only voxels within 1e-3 of the threshold
    may differ."""
    env = slice_env
    monkeypatch.setattr(
        jax_fused, "FusedDinoCryoVIT",
        functools.partial(jax_fused.FusedDinoCryoVIT, dtype=jnp.float32),
    )
    model, variables, *_ = jax_load_model(env["model_path"])
    jax_written = jax_run_fused_inference(
        [env["raw"]], model, variables, "mito", env["tmp"] / "jax_out", THRESHOLD,
        dino_cfg=env["jcfg"], dino_variables=env["dino_vars"],
    )
    port_written = run_inference(
        [env["raw"]], env["model_path"], env["tmp"] / "port_out", THRESHOLD, fused=True,
        model_dir=env["model_dir"], dino_cfg=DinoV2Config(**SMALL), device="cpu",
        dtype=torch.float32,
    )
    assert [p.name for p in port_written] == [p.name for p in jax_written] == ["t0.hdf"]

    stack = pad_slices_to_multiple(load_data(env["raw"])[0][0].astype(np.float32))
    jax_probs = np.asarray(
        jax_fused.FusedDinoCryoVIT(
            env["dino_vars"], variables, dino_cfg=env["jcfg"]
        ).segment(stack)
    )
    segmenter, label_key = load_fused(
        env["model_path"], env["model_dir"], dino_cfg=DinoV2Config(**SMALL),
        device="cpu", dtype=torch.float32,
    )
    port_probs = segmenter.segment(stack).numpy()
    assert label_key == "mito" and port_probs.shape == jax_probs.shape == (4, 128, 128)
    assert 0.05 < jax_probs.std()
    np.testing.assert_allclose(port_probs, jax_probs, atol=1e-3, rtol=0)

    with h5py.File(jax_written[0]) as fj, h5py.File(port_written[0]) as fp:
        want, got = np.asarray(fj["mito_preds"]), np.asarray(fp["mito_preds"])
        np.testing.assert_array_equal(np.asarray(fp["data"]), np.asarray(fj["data"]))
    assert got.dtype == np.uint8 and got.shape == (4, 128, 128)
    differ = got != want
    assert differ.mean() <= 1e-3
    assert np.all(np.abs(jax_probs[differ] - THRESHOLD) < 1e-3)


def test_load_model_reads_the_jax_torch_export(slice_env):
    """A ``.model`` written by the JAX package's ``save_torch_model`` loads
    into the port with exactly the exported weights."""
    model, model_type, name, label_key = load_model(slice_env["model_path"])
    assert (model_type.value, name, label_key) == ("cryovit", "slice", "mito")
    want = cryovit_from_jax(slice_env["dec_vars"])
    got = model.state_dict()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_save_model_reads_back_in_jax(tmp_path):
    """The port's ``save_model`` writes the reference format: the JAX
    package's ``load_model`` reads it, and its weights map back exactly."""
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(5), in_channels=1536)
    model = make_cryovit(sd)
    path = save_model("portmodel", "cristae", model, tmp_path / "port.model")
    _, variables, model_type, name, label_key = jax_load_model(path)
    assert (model_type.value, name, label_key) == ("cryovit", "portmodel", "cristae")
    back = cryovit_from_jax(variables)
    assert back.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k].numpy(), err_msg=k)


def test_load_model_refuses_flax_msgpack_and_foreign_globals(tmp_path, slice_env):
    """The JAX package's own ``.model`` (flax msgpack weights) is refused
    with a clear error, and the restricted unpickler refuses globals outside
    its safe set."""
    msgpack_path = tmp_path / "flax.model"
    jax_save_model("x", "mito", _jax_family(), slice_env["dec_vars"], {}, msgpack_path)
    with pytest.raises(ValueError, match="flax"):
        load_model(msgpack_path)

    class Evil:
        def __reduce__(self):
            import os

            return (os.system, ("true",))

    evil = tmp_path / "evil.model"
    evil.write_bytes(pickle.dumps(Evil()))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        load_model(evil)


def test_extractor_matches_jax_extractor(slice_env):
    """``DinoExtractor.extract`` against the JAX extractor on the same
    padded uint8 stack (normalized on the device by both): (C, D, gh, gw)
    fp16, a tail batch smaller than the batch size. The JAX extractor
    computes in bf16, so the port does too; atol 5e-2 for bf16 rounding at
    different places on values up to a few units."""
    env = slice_env
    stack = np.random.default_rng(3).integers(0, 255, size=(5, 64, 80)).astype(np.uint8)
    want = JaxDinoExtractor(
        env["dino_vars"], cfg=env["jcfg"], batch_size=2, use_flash_attention=False
    ).extract(stack)
    model = make_dinov2(
        to_torch(dinov2_from_jax(env["dino_vars"])), DinoV2Config(**SMALL), device="cpu",
        dtype=torch.bfloat16,
    )
    got = DinoExtractor(model, batch_size=2).extract(stack)
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (128, 5, 4, 5)
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=5e-2, rtol=0)


def test_run_dino_writes_the_reference_layout(slice_env, tmp_path):
    """``run_dino``: ``<stem>.hdf`` with the normalized gzip ``data`` volume
    and fp16 ``(C, D, H/16, W/16)`` ``dino_features``."""
    written = run_dino(
        [slice_env["raw"]], tmp_path, batch_size=3, model_dir=slice_env["model_dir"],
        dino_cfg=DinoV2Config(**SMALL), device="cpu", dtype=torch.float32,
    )
    assert [p.name for p in written] == ["t0.hdf"]
    with h5py.File(written[0]) as f:
        feats = f["dino_features"]
        assert feats.dtype == np.float16 and feats.shape == (128, 4, 8, 8)
        assert np.isfinite(np.asarray(feats)).all()
        np.testing.assert_array_equal(np.asarray(f["data"]), load_data(slice_env["raw"])[0][0])


def test_cli_infer_fused_and_features_end_to_end(slice_env, tmp_path, monkeypatch):
    """``cryovit-torch infer --fused`` and ``features`` through ``main`` on
    the CPU (``--device cpu``), with random backbone weights (``--random-init``) and the
    backbone shrunk to the small config: masks and features in the
    reference HDF5 layout."""
    from cryovit_tpu_torch.cli.main import main

    monkeypatch.setattr(DinoV2Config, "giant", classmethod(lambda cls: cls(**SMALL)))
    tomos = slice_env["raw"].parent
    assert main(["infer", str(tomos), "--model", str(slice_env["model_path"]), "--fused",
                 "--random-init", "--result-folder", str(tmp_path / "masks"),
                 "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "masks" / "t0.hdf") as f:
        masks = np.asarray(f["mito_preds"])
    assert masks.dtype == np.uint8 and masks.shape == (4, 128, 128)
    assert set(np.unique(masks)) <= {0, 1}

    assert main(["features", str(tomos), str(tmp_path / "feats"), "--random-init",
                 "--batch-size", "3", "--device", "cpu"]) == 0
    with h5py.File(tmp_path / "feats" / "t0.hdf") as f:
        assert f["dino_features"].shape == (128, 4, 8, 8)
        assert f["dino_features"].dtype == np.float16
