"""The JAX package's converted foundation weights, read by the port from a
``model_dir`` that holds only what ``tools/convert_dinov2.py`` and
``tools/convert_sam2.py`` write (ROADMAP A11, C9). CPU, tiny configs.

The files are written by flax's own ``to_bytes``, from trees the JAX
converters make of seeded torch-layout state dicts:

- ``DINOv2/dinov2_vitg14_reg.msgpack``, scanned and per block, with and
  without ImageNet normalization folded into the patch embed: the port's
  ``load_dinov2_variables`` gives ``dinov2_from_jax`` of the tree flax reads,
  bit for bit, and ``run_dino``'s features agree with the JAX
  ``DinoExtractor`` on the weights JAX loads from the same directory, both in
  bf16, within atol 5e-2 (the tolerance of
  ``tests/test_torch_slice.py::test_extractor_matches_jax_extractor``); the
  same tree with flax's ``MAX_CHUNK_SIZE`` patched down (chunked arrays)
  loads the same; the msgpack wins over the torch hub checkpoint; with
  neither file the error names both.
- ``SAM2/sam2_encoder.msgpack``: ``run_sam``'s pyramids against JAX
  ``run_sam``'s from the same directory, both bf16, within the JAX package's
  bf16 tolerance (cosine > 0.9999, max |diff| < 0.1: ``assert_close_bf16`` of
  ``tests/test_torch_sam2.py``), position encodings and the ``data`` volume
  equal; the patch embed folded as JAX folds it; the msgpack wins over the
  published checkpoint; with neither file the error names both.
- ``SAM2/sam2_weights.msgpack``: ``train --model sam2``'s initial weights
  (``run_training``, stopped where the optimizer is built) equal, tensor for
  tensor, the JAX ``load_pretrained_variables`` tree laid over the same
  initial weights by JAX's ``merge_variables``; the LoRA factors and the
  prompt predictor stay fresh; the msgpack route and the ``.pt`` route give
  equal tensors on every key of the published dict (the decoder's
  ``output_upscaling`` taps included: C5); the msgpack wins when both are
  present; a tensor the port has no place for is named; MedSAM is still
  refused.
- ``chip_smoke.write_flax_msgpack`` (the smoke's writer on the card's
  machine, which has no flax) writes ``flax.serialization.to_bytes``'s bytes,
  chunked and not.
"""

import dataclasses
import importlib.util
import logging
import shutil
from functools import partial
from pathlib import Path

import flax.serialization as flax_serialization
import h5py
import numpy as np
import pytest
import torch

from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.models.dinov2 import convert_torch_state_dict
from cryovit_tpu.models.dinov2 import make_dinov2 as jax_make_dinov2
from cryovit_tpu.models.sam2.config import SAM2Config as JaxSAM2Config
from cryovit_tpu.models.sam2.convert import convert_encoder_state_dict, convert_sam2_state_dict
from cryovit_tpu.models.sam2.family import SAM2 as JaxSAM2
from cryovit_tpu.run import dino_features as jax_dino
from cryovit_tpu.run import sam_features as jax_sam
from cryovit_tpu.train.checkpoint import merge_variables
from cryovit_tpu_torch.config import MODELS, TrainConfig
from cryovit_tpu_torch.convert import dinov2_from_jax, sam2_encoder_from_jax, sam2_from_jax
from cryovit_tpu_torch.data.transforms import pad_slices_to_multiple
from cryovit_tpu_torch.io import load_data, write_hdf, write_mrc
from cryovit_tpu_torch.models import SAM2
from cryovit_tpu_torch.models.dinov2 import DinoV2, DinoV2Config
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.models.sam2.encoder import fold_rgb_patch_embed, random_encoder_state_dict
from cryovit_tpu_torch.run.dino_features import (
    JAX_WEIGHTS,
    TORCH_HUB_WEIGHTS,
    load_dinov2_variables,
    run_dino,
)
from cryovit_tpu_torch.run.sam_features import (
    SAM2_CHECKPOINT,
    SAM2_ENCODER_WEIGHTS,
    make_sam_encoder_state,
    run_sam,
)
from cryovit_tpu_torch.run.train_model import run_training

from test_sam2_torch_parity import _published_full_state_dict
from test_torch_sam2 import assert_close_bf16

DINO_ATOL = 5e-2  # bf16 on both sides, fp16 features of a few units
SAM2_WEIGHTS, SAM2_PT = "sam2_weights.msgpack", "sam2.1_hiera_large.pt"


def _write(path: Path, tree) -> Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(flax_serialization.to_bytes(tree))
    return path


def _hub_state_dict(seed: int) -> dict[str, np.ndarray]:
    """A torch hub DINOv2 checkpoint of ``tiny_test`` widths: the 3-channel
    patch embed (channels apart, so the folds differ), kernels ~ N(0,
    1/fan_in), LayerNorm scales 1 + N(0, 0.1²), the rest N(0, 0.1²), and the
    ``mask_token`` the converters drop."""
    rng = np.random.default_rng(seed)
    cfg = DinoV2Config.tiny_test()
    with torch.device("meta"):
        template = DinoV2(cfg).state_dict()
    out = {"mask_token": np.zeros((1, cfg.embed_dim), np.float32)}
    for name, t in template.items():
        shape = tuple(t.shape)
        if name == "patch_embed.proj.weight":
            shape = (shape[0], 3, *shape[2:])
        noise = rng.standard_normal(shape).astype(np.float32)
        if name.endswith(".weight") and len(shape) > 1:
            out[name] = noise / np.sqrt(np.prod(shape[1:]))
        elif "norm" in name and name.endswith(".weight"):
            out[name] = 1.0 + 0.1 * noise
        else:
            out[name] = 0.1 * noise
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tomograms (a 3x48x40 int16 MRC for DINOv2, 3x48x48 f32 in [0, 1]
    for SAM2)
    and the model_dirs: ``dino/<layout>-<normalize>/`` with one
    ``dinov2_vitg14_reg.msgpack`` each, ``hub/`` with a torch hub checkpoint
    of other weights, ``sam_encoder/`` with ``sam2_encoder.msgpack``,
    ``sam_pt/`` with a published checkpoint of other encoder weights."""
    tmp = tmp_path_factory.mktemp("foundation")
    rng = np.random.default_rng(51)
    for sub in ("dino_tomos", "sam_tomos"):
        (tmp / sub).mkdir()
    write_mrc(tmp / "dino_tomos/t0.mrc", rng.integers(-120, 120, (3, 48, 40)).astype(np.int16))
    write_mrc(tmp / "sam_tomos/v.mrc", rng.random((3, 48, 48)).astype(np.float32))
    jcfg, hub = JaxDinoV2Config.tiny_test(), _hub_state_dict(52)
    dino = {}
    for scanned in (True, False):
        for normalize in (True, False):
            tree = convert_torch_state_dict(hub, jcfg, normalize=normalize, scan_blocks=scanned)
            layout = "scanned" if scanned else "per-block"
            dino[scanned, normalize] = _write(tmp / f"dino/{layout}-{normalize}" / JAX_WEIGHTS, tree)
    (tmp / "hub").mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in _hub_state_dict(53).items()},
               tmp / "hub" / TORCH_HUB_WEIGHTS)

    def published_encoder(seed):
        sd = random_encoder_state_dict(SAM2Config.tiny_test(), torch.Generator().manual_seed(seed))
        return {f"image_encoder.{k}": v.numpy() for k, v in sd.items()}

    encoder = _write(tmp / "sam_encoder" / SAM2_ENCODER_WEIGHTS,
                     convert_encoder_state_dict(published_encoder(54), JaxSAM2Config.tiny_test()))
    (tmp / "sam_pt").mkdir()
    torch.save({"model": {k: torch.from_numpy(v) for k, v in published_encoder(55).items()}},
               tmp / "sam_pt" / SAM2_CHECKPOINT)
    return {"tmp": tmp, "dino": dino, "hub": tmp / "hub", "encoder": encoder,
            "sam_pt": tmp / "sam_pt", "dino_mrc": tmp / "dino_tomos/t0.mrc",
            "sam_mrc": tmp / "sam_tomos/v.mrc"}


def _port_dino(model_dir) -> dict[str, np.ndarray]:
    sd, random = load_dinov2_variables(model_dir, cfg=DinoV2Config.tiny_test(), device="cpu")
    assert not random
    return {k: v.numpy() for k, v in sd.items()}


def _assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- DINOv2 -------------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False], ids=["normalized", "unnormalized"])
@pytest.mark.parametrize("scanned", [True, False], ids=["scanned", "per-block"])
def test_dinov2_msgpack_features_match_jax(files, scanned, normalize, monkeypatch, tmp_path):
    """``load_dinov2_variables`` takes the file as stored (its patch kernel
    already folded to one channel, no second fold), and ``run_dino``'s
    features from the directory agree with JAX's extractor on what JAX
    loads from it. JAX's extractor scans its blocks where the file is
    scanned, as ViT-g's does (``scan_blocks`` follows the depth)."""
    path = files["dino"][scanned, normalize]
    want_sd = dinov2_from_jax(flax_serialization.msgpack_restore(path.read_bytes()))
    _assert_same(_port_dino(path.parent), want_sd)
    assert want_sd["patch_embed.proj.weight"].shape == (64, 1, 14, 14)

    jcfg = JaxDinoV2Config.tiny_test()
    monkeypatch.setattr(jax_dino, "make_dinov2", partial(jax_make_dinov2, scan_blocks=scanned))
    variables, random = jax_dino.load_dinov2_variables(path.parent, cfg=jcfg)
    assert not random and ("blocks" in variables["params"]) == scanned
    stack = pad_slices_to_multiple(load_data(files["dino_mrc"])[0][0])
    want = jax_dino.DinoExtractor(variables, cfg=jcfg, batch_size=2).extract(stack)

    (written,) = run_dino([files["dino_mrc"]], tmp_path, batch_size=2,
                          dino_cfg=DinoV2Config.tiny_test(), model_dir=path.parent, device="cpu",
                          dtype=torch.bfloat16)
    with h5py.File(written) as f:
        got = np.asarray(f["dino_features"])
    assert got.dtype == want.dtype == np.float16
    assert got.shape == want.shape == (64, 3, 3, 3)
    assert float(np.abs(want.astype(np.float32)).max()) > 0.5
    np.testing.assert_allclose(got.astype(np.float32), want.astype(np.float32), atol=DINO_ATOL,
                               rtol=0)


def test_dinov2_chunked_msgpack_loads_as_the_whole_arrays(files, monkeypatch, tmp_path):
    """The scanned tree written with flax's ``MAX_CHUNK_SIZE`` patched down
    to 4 KiB (ViT-g's qkv and w12 kernels are over the real 2^30 bytes)
    loads bit for bit as the unchunked file does."""
    path = files["dino"][True, True]
    tree = flax_serialization.msgpack_restore(path.read_bytes())
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 4096)
    chunked = _write(tmp_path / JAX_WEIGHTS, tree)
    assert chunked.read_bytes().count(b"__msgpack_chunked_array__") >= 5
    _assert_same(_port_dino(tmp_path), _port_dino(path.parent))


def test_dinov2_msgpack_wins_over_the_torch_hub_checkpoint(files, tmp_path):
    """With both files the converted weights are read (JAX reads only
    them); the torch hub checkpoint alone still loads, folded here; with
    neither, the error names both files and the converter."""
    msgpack = files["dino"][True, True]
    shutil.copy(msgpack, tmp_path / JAX_WEIGHTS)
    shutil.copy(files["hub"] / TORCH_HUB_WEIGHTS, tmp_path / TORCH_HUB_WEIGHTS)
    got, hub = _port_dino(tmp_path), _port_dino(files["hub"])
    _assert_same(got, _port_dino(msgpack.parent))
    assert not np.array_equal(got["blocks.0.attn.qkv.weight"], hub["blocks.0.attn.qkv.weight"])
    assert hub["patch_embed.proj.weight"].shape == (64, 1, 14, 14)
    with pytest.raises(FileNotFoundError, match=f"{JAX_WEIGHTS}.*convert_dinov2.py.*"
                                                f"{TORCH_HUB_WEIGHTS}"):
        load_dinov2_variables(tmp_path / "empty", cfg=DinoV2Config.tiny_test(), device="cpu")


# ---- the SAM2 encoder -----------------------------------------------------------------------


def test_sam2_encoder_msgpack_pyramids_match_jax_run_sam(files, tmp_path):
    """``make_sam_encoder_state`` gives ``sam2_encoder_from_jax`` of the tree
    with the patch embed's three channels summed as JAX sums them;
    ``run_sam``'s pyramids from the directory agree with JAX ``run_sam``'s
    from the same directory."""
    path = files["encoder"]
    tree = flax_serialization.msgpack_restore(path.read_bytes())
    state = make_sam_encoder_state(path.parent, SAM2Config.tiny_test(), device="cpu")
    want = fold_rgb_patch_embed({k: torch.from_numpy(np.array(v))
                                 for k, v in sam2_encoder_from_jax(tree).items()})
    _assert_same({k: v.numpy() for k, v in state.items()}, {k: v.numpy() for k, v in want.items()})
    folded, was_folded = jax_sam._fold_rgb_patch_embed(tree)
    kernel = np.asarray(folded["params"]["trunk"]["patch_embed"]["kernel"])  # (kh, kw, 1, out)
    assert was_folded and state["trunk.patch_embed.proj.weight"].shape == (8, 1, 7, 7)
    np.testing.assert_array_equal(state["trunk.patch_embed.proj.weight"].numpy(),
                                  kernel.transpose(3, 2, 0, 1))

    (jax_written,) = jax_sam.run_sam([files["sam_mrc"]], tmp_path / "jax", batch_size=2,
                                     sam_cfg=JaxSAM2Config.tiny_test(), model_dir=path.parent)
    (port_written,) = run_sam([files["sam_mrc"]], tmp_path / "port", batch_size=2,
                              sam_cfg=SAM2Config.tiny_test(), model_dir=path.parent, device="cpu",
                              dtype=torch.bfloat16)
    with h5py.File(jax_written) as fj, h5py.File(port_written) as fp:
        np.testing.assert_array_equal(np.asarray(fp["data"]), np.asarray(fj["data"]))
        for i, side in enumerate((16, 8, 4)):
            got, ref = (np.asarray(f[f"sam_features/backbone_fpn/{i}"]) for f in (fp, fj))
            assert got.dtype == ref.dtype == np.float16
            assert got.shape == ref.shape == (3, 32, side, side)
            assert_close_bf16(got.astype(np.float32), ref.astype(np.float32))
            np.testing.assert_array_equal(np.asarray(fp[f"sam_features/vision_pos_enc/{i}"]),
                                          np.asarray(fj[f"sam_features/vision_pos_enc/{i}"]))


def test_sam2_encoder_msgpack_wins_over_the_published_checkpoint(files, tmp_path):
    """Both files: the converted encoder is read; the published checkpoint
    alone still loads; neither: the error names both files and the
    converter."""
    shutil.copy(files["encoder"], tmp_path / SAM2_ENCODER_WEIGHTS)
    shutil.copy(files["sam_pt"] / SAM2_CHECKPOINT, tmp_path / SAM2_CHECKPOINT)

    def state(model_dir):
        sd = make_sam_encoder_state(model_dir, SAM2Config.tiny_test(), device="cpu")
        return {k: v.numpy() for k, v in sd.items()}

    both, pt = state(tmp_path), state(files["sam_pt"])
    _assert_same(both, state(files["encoder"].parent))
    key = "trunk.blocks.0.attn.qkv.weight"
    assert not np.array_equal(both[key], pt[key])
    with pytest.raises(FileNotFoundError, match=f"{SAM2_ENCODER_WEIGHTS}.*convert_sam2.py.*"
                                                f"{SAM2_CHECKPOINT}"):
        make_sam_encoder_state(tmp_path / "empty", SAM2Config.tiny_test(), device="cpu")


# ---- SAM2 training's pretrained weights ---------------------------------------------------------


@pytest.fixture(scope="module")
def sam2_dirs(tmp_path_factory):
    """A published-format checkpoint of ``tiny_test`` widths, as
    ``sam2_weights.msgpack`` (the JAX ``convert_sam2_state_dict`` tree, as
    ``tools/convert_sam2.py`` writes it) under ``msgpack/SAM2``, as the
    ``.pt`` under ``pt/SAM2``, and both under ``both/SAM2`` with the ``.pt``
    of other weights; two 5x40x40 tomograms with labels."""
    tmp = tmp_path_factory.mktemp("sam2_weights")
    cfg = JaxSAM2Config.tiny_test()
    published = _published_full_state_dict(cfg, np.random.default_rng(56))
    other = _published_full_state_dict(cfg, np.random.default_rng(57))
    tree = convert_sam2_state_dict(published, cfg)

    def pt(sd, path):
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}},
                   path)

    _write(tmp / "msgpack/SAM2" / SAM2_WEIGHTS, tree)
    pt(published, tmp / "pt/SAM2" / SAM2_PT)
    _write(tmp / "both/SAM2" / SAM2_WEIGHTS, tree)
    pt(other, tmp / "both/SAM2" / SAM2_PT)
    rng = np.random.default_rng(58)
    for sub in ("tomos", "labels"):
        (tmp / sub).mkdir()
    write_hdf(tmp / "tomos/t0.hdf", {"data": rng.integers(0, 255, (5, 40, 40)).astype(np.uint8)})
    label = (rng.random((5, 40, 40)) > 0.5).astype(np.int8)
    label[0] = -1
    write_hdf(tmp / "labels/t0.hdf", {"mito": label})
    return {"tmp": tmp, "published": published, "tree": tree}


def _family(name: str = "SAM2", **custom) -> SAM2:
    return SAM2(name=name, input_key="data", lr=5e-5, losses={}, metrics={}, custom_kwargs=custom)


class _Built(Exception):
    """Raised where ``Trainer.fit`` builds the optimizer: the module then
    holds its initial weights, the pretrained ones laid over them."""


def _initial_weights(root: Path, model_dir: Path, monkeypatch) -> dict[str, np.ndarray]:
    """``train --model sam2``'s initial weights (``run_training`` with
    ``model_dir``), taken where the optimizer is built."""
    seen = {}

    def stop(self, module):
        seen.update({k: v.detach().numpy().copy() for k, v in module.state_dict().items()})
        raise _Built

    monkeypatch.setattr(SAM2, "make_optimizer", stop)
    model = dataclasses.replace(MODELS["sam2"], custom_kwargs=MODELS["sam2"].custom_kwargs
                                + (("test_config", True),))
    cfg = TrainConfig(label_key="mito", model=model, model_dir=str(model_dir))
    with pytest.raises(_Built):
        run_training([root / "tomos/t0.hdf"], [root / "labels/t0.hdf"], ["mito"], "mito",
                     "sam2_mito", root / "run", num_epochs=1, device="cpu", config=cfg)
    monkeypatch.undo()
    return seen


def test_sam2_weights_msgpack_initial_weights_match_jax(sam2_dirs, monkeypatch, caplog):
    """``run_training`` with only ``SAM2/sam2_weights.msgpack`` in
    ``model_dir``: its initial weights are, tensor for tensor, JAX's
    ``merge_variables`` of ``load_pretrained_variables``' tree over the same
    fresh weights (the run with an empty ``model_dir``, in JAX's tree by
    ``convert_sam2_state_dict``); every tensor the file sets moved, and the
    rest (LoRA factors, prompt predictor) stayed fresh. The log names the
    file read."""
    root = sam2_dirs["tmp"]
    fresh = _initial_weights(root, root / "none", monkeypatch)
    with caplog.at_level(logging.INFO, logger="cryovit_tpu_torch.models.sam2.family"):
        got = _initial_weights(root, root / "msgpack", monkeypatch)
    read = root / "msgpack/SAM2" / SAM2_WEIGHTS
    assert f"loading the converted SAM2 weights {read}" in caplog.text

    jcfg = JaxSAM2Config.tiny_test()
    loaded = JaxSAM2(name="SAM2", input_key="data", lr=5e-5, losses={}, metrics={},
                     custom_kwargs={"test_config": True}).load_pretrained_variables(
        root / "msgpack/SAM2")
    merged = merge_variables(convert_sam2_state_dict(fresh, jcfg), loaded)
    _assert_same(got, sam2_from_jax(merged))

    pub = sam2_from_jax(loaded)
    assert set(pub) < set(got)
    assert all(k.endswith((".w_a.weight", ".w_b.weight")) or k.startswith("prompt_predictor.")
               for k in set(got) - set(pub))
    for k in set(got) - set(pub):
        np.testing.assert_array_equal(got[k], fresh[k], err_msg=k)
    assert all(not np.array_equal(got[k], fresh[k]) for k in pub if fresh[k].std() > 0)


def test_sam2_msgpack_and_pt_routes_give_equal_tensors(sam2_dirs, caplog):
    """``load_pretrained`` of the msgpack and of the ``.pt`` of one
    checkpoint: the same keys (the LoRA bases under ``.proj``) and equal
    tensors, the decoder's ConvTranspose taps stored once, as exported
    (C5: flipped only in ``ConvTranspose2d.forward``); with both files the
    msgpack's; a tensor of the JAX tree the port has no place for is named
    in a warning."""
    root, fam = sam2_dirs["tmp"], _family(test_config=True)
    from_msgpack = fam.load_pretrained(root / "msgpack/SAM2")
    from_pt = fam.load_pretrained(root / "pt/SAM2")
    _assert_same(from_msgpack, from_pt)
    assert any(k.endswith(".q_proj.proj.weight") for k in from_msgpack)
    taps = "model.sam_mask_decoder.output_upscaling.0.weight"
    published = sam2_dirs["published"]["sam_mask_decoder.output_upscaling.0.weight"]
    np.testing.assert_array_equal(from_msgpack[taps], published)
    _assert_same(fam.load_pretrained(root / "both/SAM2"), from_msgpack)

    tree = sam2_dirs["tree"]
    extra = {"params": {"sam": {**tree["params"]["sam"], "extra_embed": np.zeros(3, np.float32)}}}
    with caplog.at_level(logging.WARNING, logger="cryovit_tpu_torch.convert"):
        _assert_same(sam2_from_jax(extra), from_msgpack)
    assert "1 tensors of the JAX SAM2 tree have no place in the port: /params/sam/extra_embed" in (
        caplog.text)


def test_sam2_pretrained_missing_warns_and_medsam_is_refused(sam2_dirs, tmp_path, caplog):
    """With neither file: None and a warning naming both (training starts
    from random weights, as in JAX). MedSAM stays refused up front (C2),
    its converted file present or not."""
    with caplog.at_level(logging.WARNING):
        assert _family(test_config=True).load_pretrained(tmp_path) is None
    assert f"looked for {SAM2_WEIGHTS}, {SAM2_PT}" in caplog.text
    _write(tmp_path / "medsam2_weights.msgpack", sam2_dirs["tree"])
    with pytest.raises(ValueError, match="C2"):
        _family("MedSAM")


# ---- chip_smoke's writer ------------------------------------------------------------------------


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("max_chunk", [2**30, 64], ids=["whole", "chunked"])
def test_smoke_msgpack_writer_writes_flax_bytes(max_chunk, monkeypatch, tmp_path):
    """``chip_smoke.write_flax_msgpack`` against ``flax.serialization.to_bytes``
    on a tree of f32, f16, int8, uint8, bool, 0-d and empty arrays, maps of
    over 15 keys, long keys and arrays over 2^16 bytes; with flax's
    ``MAX_CHUNK_SIZE`` and the writer's limit both 64 bytes, chunked; the
    port's reader reads it back."""
    from cryovit_tpu_torch.train.msgpack import msgpack_read

    rng = np.random.default_rng(59)
    tree = {"params": {f"dense{i}": {"kernel": rng.standard_normal((3, i + 1)).astype(np.float32)}
                       for i in range(17)},
            "blocks": {"w": rng.standard_normal((4, 5, 6)).astype(np.float16),
                       "empty": np.zeros((0, 4), np.float32), "scalar": np.array(3.0, np.float32),
                       "mask": rng.random((2, 3)) > 0.5, "k" * 40: np.ones(2, np.int8),
                       "bytes": rng.integers(0, 255, 70000).astype(np.uint8)}}
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", max_chunk)
    want = flax_serialization.to_bytes({k: dict(v) for k, v in tree.items()})
    path = tmp_path / "tree.msgpack"
    with open(path, "wb") as f:
        _chip_smoke().write_flax_msgpack(f, tree, max_chunk)
    assert path.read_bytes() == want
    assert (want.count(b"__msgpack_chunked_array__") > 0) == (max_chunk == 64)
    back = msgpack_read(path)

    def same(got, want):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for key in want:
                same(got[key], want[key])
        else:
            assert got.dtype == want.dtype and got.shape == want.shape and got.flags.writeable
            np.testing.assert_array_equal(got, want)

    same(back, tree)
