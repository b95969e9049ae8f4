"""Evaluation and file-based inference: the port against the JAX package.

One reference ``.model`` (CryoVIT, written by the JAX package's
``save_torch_model``) and two tomograms of 16×64×64 voxels with f32 DINOv2
features (1536×16×4×4) and labels go through the JAX ``run_evaluation`` /
``run_inference`` and the port's, on the CPU in f32:

- the metrics CSVs have the same rows and columns, metrics within 1e-4;
- the ``--visualize`` HDF5s hold the same inputs and labels, and
  probabilities within 1e-4;
- file-based masks equal JAX's thresholded probabilities, except at voxels
  where JAX's probability lies within 1e-4 of the threshold;
- ``CsvWriter`` replaces a tomogram's row on a rerun, with and without a
  split id, as the JAX writer does.
"""

from pathlib import Path

import h5py
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from cryovit_tpu.callbacks import CsvWriter as JaxCsvWriter
from cryovit_tpu.models import CryoVIT as JaxCryoVIT
from cryovit_tpu.run.eval_model import run_evaluation as jax_run_evaluation
from cryovit_tpu.run.infer_model import run_inference as jax_run_inference
from cryovit_tpu.train.loop import Trainer as JaxTrainer
from cryovit_tpu.train.torch_export import save_torch_model
from cryovit_tpu.train.torch_import import convert_cryovit_state_dict
from cryovit_tpu.types import BatchedModelResult as JaxBatchedModelResult
from cryovit_tpu.types import TomogramBatch as JaxTomogramBatch
from cryovit_tpu.types import TomogramData as JaxTomogramData
from cryovit_tpu_torch.callbacks import CsvWriter
from cryovit_tpu_torch.config import MODELS, TrainConfig
from cryovit_tpu_torch.data import FileDataset
from cryovit_tpu_torch.io import load_files_from_path
from cryovit_tpu_torch.models.cryovit import random_cryovit_state_dict
from cryovit_tpu_torch.run.eval_model import run_evaluation
from cryovit_tpu_torch.run.infer_model import run_inference
from cryovit_tpu_torch.run.train_model import build_model
from cryovit_tpu_torch.train.loop import Trainer
from cryovit_tpu_torch.types import BatchedModelResult, FileData, TomogramBatch, TomogramData

DEPTH, SIDE, GRID = 16, 64, 4
TOL = 1e-4


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``tomos/t{0,1}.hdf`` (``data``, f32 ``dino_features``), their
    ``labels/t{0,1}.hdf`` (``mito``, the first slice unlabeled) and a
    reference ``.model`` of seeded decoder weights, its mask head scaled so
    the probabilities spread over (0, 1)."""
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(11)
    (root / "tomos").mkdir()
    (root / "labels").mkdir()
    for i in range(2):
        with h5py.File(root / "tomos" / f"t{i}.hdf", "w") as f:
            f.create_dataset("data", data=rng.random((DEPTH, SIDE, SIDE)).astype(np.float32))
            f.create_dataset("dino_features", data=(
                rng.standard_normal((1536, DEPTH, GRID, GRID)) * 0.5).astype(np.float32))
        label = rng.integers(0, 2, size=(DEPTH, SIDE, SIDE)).astype(np.int8)
        label[0] = -1
        with h5py.File(root / "labels" / f"t{i}.hdf", "w") as f:
            f.create_dataset("mito", data=label)
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(12))
    sd["output_layer.2.weight"] *= 40.0
    variables = convert_cryovit_state_dict({k: v.numpy() for k, v in sd.items()})
    jmodel = JaxCryoVIT(name="CryoVIT", input_key="dino_features", lr=1e-4,
                        losses={}, metrics={}, dtype=jnp.float32)
    save_torch_model("eval_ref", "mito", jmodel, variables, root / "eval_ref.model")
    return root


@pytest.fixture(scope="module")
def evaluations(files):
    """Both packages' ``run_evaluation`` with ``visualize``, each into its
    own result directory."""
    tomos = load_files_from_path(files / "tomos")
    labels = load_files_from_path(files / "labels")
    jax_dir = jax_run_evaluation(tomos, labels, ["mito"], files / "eval_ref.model",
                                 files / "jax_eval", visualize=True)
    port_dir = run_evaluation(tomos, labels, ["mito"], files / "eval_ref.model",
                              files / "port_eval", visualize=True, device="cpu")
    return files, Path(jax_dir), Path(port_dir)


def test_evaluation_csv_matches_jax(evaluations):
    """Same file names, rows and columns; every metric within 1e-4."""
    _, jax_dir, port_dir = evaluations
    assert port_dir.parts[-2:] == jax_dir.parts[-2:] == ("results", "eval_ref")
    names = sorted(p.name for p in jax_dir.glob("*.csv"))
    assert names == sorted(p.name for p in port_dir.glob("*.csv")) == ["tomos.csv"]
    want, got = pd.read_csv(jax_dir / names[0]), pd.read_csv(port_dir / names[0])
    assert list(got.columns) == list(want.columns) == [
        "sample", "tomo_name", "dice_metric", "f1_metric"]
    pd.testing.assert_frame_equal(got[["sample", "tomo_name"]], want[["sample", "tomo_name"]])
    np.testing.assert_allclose(got[["dice_metric", "f1_metric"]].to_numpy(),
                               want[["dice_metric", "f1_metric"]].to_numpy(), atol=TOL, rtol=0)
    assert (want["dice_metric"] > 0.1).all()  # masks far from empty: the metric says something


def test_evaluation_prediction_hdf5s_match_jax(evaluations):
    """``<results>/predictions/<name>/<sample>/<tomo>``: the same datasets,
    the raw volume and labels equal, the probabilities within 1e-4."""
    root, _, _ = evaluations
    for i in range(2):
        rel = Path("predictions") / "eval_ref" / "tomos" / f"t{i}.hdf"
        with h5py.File(root / "jax_eval" / rel) as fj, h5py.File(root / "port_eval" / rel) as fp:
            assert sorted(fp) == sorted(fj) == ["data", "mito", "mito_preds"]
            np.testing.assert_array_equal(fp["data"][()], fj["data"][()])
            np.testing.assert_array_equal(fp["mito"][()], fj["mito"][()])
            assert fp["mito_preds"].shape == (DEPTH, SIDE, SIDE)
            np.testing.assert_allclose(fp["mito_preds"][()], fj["mito_preds"][()], atol=TOL, rtol=0)


def test_file_inference_masks_match_jax(evaluations):
    """``run_inference(fused=False)`` on the feature files: uint8 masks on
    the voxel grid equal to JAX's probabilities (from its evaluation)
    thresholded at 0.5, except where those lie within 1e-4 of 0.5. The
    JAX package's own file-based masks cover only the patch grid (ROADMAP.md
    C4); there the port's masks equal them."""
    root, _, _ = evaluations
    tomos = load_files_from_path(root / "tomos")
    got_paths = run_inference(tomos, root / "eval_ref.model", root / "port_infer", device="cpu")
    jax_paths = jax_run_inference(tomos, root / "eval_ref.model", root / "jax_infer")
    assert [p.name for p in got_paths] == [p.name for p in jax_paths] == ["t0.hdf", "t1.hdf"]
    for got_path, jax_path in zip(got_paths, jax_paths):
        rel = Path("predictions") / "eval_ref" / "tomos" / got_path.name
        with h5py.File(root / "jax_eval" / rel) as f:
            probs = f["mito_preds"][()]
        with h5py.File(got_path) as f, h5py.File(jax_path) as fj:
            masks = f["mito_preds"][()]
            np.testing.assert_array_equal(f["data"][()], fj["data"][()])
            jax_masks = fj["mito_preds"][()]
        assert masks.dtype == np.uint8 and masks.shape == (DEPTH, SIDE, SIDE)
        clear = np.abs(probs - 0.5) > TOL
        np.testing.assert_array_equal(masks[clear], (probs >= 0.5).astype(np.uint8)[clear])
        assert jax_masks.shape == (DEPTH, GRID, GRID)
        corner = clear[:, :GRID, :GRID]
        np.testing.assert_array_equal(masks[:, :GRID, :GRID][corner], jax_masks[corner])


def test_unlabelled_feature_files_predict_on_the_voxel_grid(files):
    """Without a label file the port's zero label takes the raw volume's
    shape (the predictions are cropped to it); the JAX package's takes the
    feature grid's (ROADMAP.md C4)."""
    fd = FileData(tomo_path=files / "tomos" / "t0.hdf", sample="tomos")
    item = FileDataset([fd], input_key="dino_features", label_key="mito")[0]
    assert item.label.shape == (DEPTH, SIDE, SIDE) and not item.label.any()
    assert item.data.shape == (DEPTH, GRID, GRID, 1536)
    assert item.aux_data["data"].shape == (DEPTH, SIDE, SIDE)


def _results(package, split_id, metrics):
    cls = JaxBatchedModelResult if package == "jax" else BatchedModelResult
    zeros = np.zeros((1, 2, 2), np.float32)
    return cls(batch_size=1, samples=["s"], tomo_names=["a.hdf"], split_id=[split_id],
               data=[zeros], label=[zeros], preds=[zeros], losses={}, metrics=metrics)


@pytest.mark.parametrize("split_id", [None, 3])
def test_csv_writer_replaces_rows_on_a_rerun(tmp_path, split_id):
    """The same three writes (a tomogram, a second one, the first again
    with new metrics) through both writers: one file, two rows, the rerun's
    metrics in the first's place at the end, the same frame as JAX's."""
    writes = [("a.hdf", {"dice_metric": 0.25, "f1_metric": 0.5}),
              ("b.hdf", {"dice_metric": 0.125, "f1_metric": 0.75}),
              ("a.hdf", {"dice_metric": 0.3125, "f1_metric": 0.0625})]
    frames = {}
    for package, writer_cls in (("jax", JaxCsvWriter), ("port", CsvWriter)):
        writer = writer_cls(tmp_path / package)
        for tomo, metrics in writes:
            result = _results(package, split_id, metrics)
            result.tomo_names = [tomo]
            writer.on_test_batch_end(result)
        (path,) = (tmp_path / package).glob("*.csv")
        assert path.name == ("s.csv" if split_id is None else f"s_{split_id}.csv")
        frames[package] = pd.read_csv(path)
    got = frames["port"]
    assert list(got["tomo_name"]) == ["b.hdf", "a.hdf"]
    assert list(got["dice_metric"]) == [0.125, 0.3125]
    pd.testing.assert_frame_equal(got, frames["jax"])


def test_test_step_applies_the_mito_aux_mask():
    """A batch whose items carry ``labels/mito`` is scored on the voxels
    inside that mask only (reference ``test_step``), as the JAX trainer's
    ``_aux_mask`` builds it (padded to the batch's label shape); with
    ``use_mito_mask`` off, on every labelled voxel."""
    rng = np.random.default_rng(3)
    label = rng.integers(0, 2, size=(4, 8, 8)).astype(np.int8)
    mito = np.zeros((4, 6, 8), np.int8)
    mito[:, :3] = 1
    item = TomogramData("s", "t.hdf", None, np.zeros((4, 8, 8, 1), np.float32), label,
                        aux_data={"labels/mito": mito})
    batch = TomogramBatch(data=item.data[None], label=label[None], num_slices=np.array([4]))
    jitem = JaxTomogramData("s", "t.hdf", None, item.data, label, aux_data={"labels/mito": mito})
    jbatch = JaxTomogramBatch(data=item.data[None], label=label[None], num_slices=np.array([4]))
    jax_mask = np.asarray(JaxTrainer._aux_mask(None, None, jbatch, [jitem]))

    model = build_model(TrainConfig(label_key="mito", model=MODELS["unet3d"]))
    trainer = Trainer(precision="f32", device="cpu")
    aux = trainer._aux_mask(model, batch, [item])
    np.testing.assert_array_equal(aux.numpy(), jax_mask)
    y = torch.from_numpy(label[None])
    preds = torch.from_numpy(rng.random((1, 4, 8, 8)).astype(np.float32))
    _, _, masked = trainer.eval_step(lambda x: preds, model, None, y, aux)
    _, _, full = trainer.eval_step(lambda x: preds, model, None, y, None)
    hard = preds.numpy()[0] >= 0.5
    inside = jax_mask[0] > 0
    want = 2 * (label * hard)[inside].sum() / (label[inside].sum() + hard[inside].sum() + 1e-3)
    np.testing.assert_allclose(float(masked["dice_metric"]), want, rtol=1e-6)
    assert float(full["dice_metric"]) != pytest.approx(float(masked["dice_metric"]))
    model.custom_kwargs["use_mito_mask"] = False
    assert trainer._aux_mask(model, batch, [item]) is None
