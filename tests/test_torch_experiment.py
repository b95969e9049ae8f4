"""The experiment mode: the port's split datamodules, datasets and
``run_trainer``s against the JAX package's, on the CPU.

- each split policy's train, val, test and predict records equal the JAX
  DataFrame rows, in order and with the same columns; the numpy folds equal
  sklearn's ``KFold(11, shuffle=True, random_state=42)``;
- ``TomoDataset`` items equal JAX's on the same HDF5 files and seed;
- on the JAX end-to-end fixture (depth 4, side 32, f32): the port's train
  experiment writes ``weights.pt`` at ``name/AD/split_1``; JAX's
  ``load_weights`` + ``save_weights`` turn it into a ``weights.msgpack``
  experiment on which JAX's ``eval_model.run_trainer`` and the port's (on
  its own ``weights.pt``, and on the JAX experiment) write the same CSV rows,
  metrics within 1e-4; a rerun replaces the rows; UNet3D trains one epoch;
  a MedSAM grid point fails alone (exit 1) while the others run;
- the ``training`` modules' ``--device`` and GPU default;
- the ``dino_features`` sweep (``DinoV2Config.tiny_test()``, the same
  weights as a flax msgpack for JAX and a torch hub checkpoint for the
  port, both in f32) writes JAX's training-ready files: volumes and labels
  bit for bit, features within test_torch_slice.py's f32 atol 1e-3, and
  under ``quant_int8`` within test_torch_w8a8.py's DINO_LIMIT; the
  ``sam_features`` sweep writes ``SamFeatureExtractor``'s pyramids;
  ``export_features`` writes the PCA maps.
"""

import csv
import functools
import shutil
import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import cryovit_tpu.run.dino_features as jax_dino_features
from cryovit_tpu import data as jax_data
from cryovit_tpu.config import compose as jax_compose
from cryovit_tpu.io import write_hdf
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu.run.eval_model import run_trainer as jax_eval_trainer
from cryovit_tpu.train.checkpoint import load_weights, save_weights
from cryovit_tpu_torch import data as port_data
from cryovit_tpu_torch import training
from cryovit_tpu_torch.config import compose, validate_dino_config, validate_experiment_config
from cryovit_tpu_torch.convert import dinov2_from_jax
from cryovit_tpu_torch.data.datamodules import kfold_assignments
from cryovit_tpu_torch.models.dinov2 import DinoV2Config
from cryovit_tpu_torch.models.sam2.config import SAM2Config
from cryovit_tpu_torch.run import dino_features, sam_features
from cryovit_tpu_torch.run.common import build_trainer, pipeline_io, setup_exp_dir
from cryovit_tpu_torch.run.eval_model import run_trainer as eval_trainer
from cryovit_tpu_torch.run.train_model import run_trainer as train_trainer

from conftest import make_synthetic_tomogram
from test_torch_models import randomize
from test_torch_slice import _hub_state_dict
from test_torch_w8a8 import DINO_LIMIT

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this module trains on the CPU: the suite
    runs several test processes on the host at once, and torch's thread pool
    in each of them would otherwise spin against the others'."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _write_splits(path: Path, rows: list[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)


# ---- split records and folds ---------------------------------------------------

@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    """The JAX data tests' splits CSV shape: AD and Young, 6 tomograms each,
    split_id i % 3, plus a sample of neither."""
    path = tmp_path_factory.mktemp("splits") / "splits.csv"
    rows = [{"sample": s, "tomo_name": f"tomo_{i}.hdf", "split_id": i % 3}
            for s in ("AD", "Young", "Aged") for i in range(6 if s != "Aged" else 2)]
    _write_splits(path, rows)
    return path


POLICIES = [
    ("SingleSampleDataModule", dict(sample=["AD"], split_id=0, test_sample=["Young"])),
    ("SingleSampleDataModule", dict(sample="Young", split_id=2)),
    ("SingleSampleDataModule", dict(sample="AD")),
    ("MultiSampleDataModule", dict(sample=["AD", "Young"], split_id=1)),
    ("MultiSampleDataModule", dict(sample=["Young", "Aged"], split_id=0, test_sample=["AD"])),
    ("MultiSampleDataModule", dict(sample=["AD", "Aged"])),
    ("FractionalDataModule", dict(sample=["AD", "Young"], split_id=5, test_sample=0)),
    ("FractionalDataModule", dict(sample=["Young", "Aged"], split_id=10, test_sample=7)),
    ("FractionalDataModule", dict(sample=["AD", "Young", "Aged"], test_sample=3)),
    ("FractionalSampleDataModule", dict(sample=["AD", "Young"], split_id=2,
                                        test_sample=["Young"])),
    ("FractionalSampleDataModule", dict(sample=["AD", "Young", "Aged"], test_sample="AD")),
]


def _jax_records(df: pd.DataFrame) -> list[dict]:
    return [{c: (v.item() if hasattr(v, "item") else v) for c, v in zip(df.columns, row)}
            for row in df.itertuples(index=False)]


@pytest.mark.parametrize("cls, kwargs", POLICIES,
                         ids=[f"{c}-{i}" for i, (c, _) in enumerate(POLICIES)])
def test_split_records_equal_the_jax_frames(splits, cls, kwargs):
    common = dict(split_file=splits, dataset_fn=None, dataloader_fn=None)
    want = getattr(jax_data, cls)(**kwargs, **common)
    got = getattr(port_data, cls)(**kwargs, **common)
    for phase in ("train_df", "val_df", "test_df", "predict_df"):
        want_rows, got_rows = _jax_records(getattr(want, phase)()), getattr(got, phase)()
        assert got_rows == want_rows, phase
        assert [list(r) for r in got_rows] == [list(r) for r in want_rows], phase
        assert all(type(a[k]) is type(b[k]) for a, b in zip(got_rows, want_rows) for k in a)


def test_numpy_folds_equal_sklearn_kfold():
    from sklearn.model_selection import KFold

    for n in range(11, 81):
        want = np.full(n, -1)
        for fold, (_, test_idx) in enumerate(
                KFold(n_splits=11, shuffle=True, random_state=42).split(np.zeros((n, 1)))):
            want[test_idx] = fold
        np.testing.assert_array_equal(kfold_assignments(n), want, err_msg=str(n))
    with pytest.raises(ValueError, match="n_splits=11"):
        kfold_assignments(10)


def test_loaders_refuse_empty_phases(splits):
    dm = port_data.SingleSampleDataModule(sample="AD", split_id=1, test_sample="Aged",
                                          split_file=splits, dataset_fn=None,
                                          dataloader_fn=None)
    dm.record_df = [r for r in dm.record_df if r["sample"] != "Aged"]
    with pytest.raises(ValueError, match="No testing data"):
        dm.test_loader()


# ---- the datasets ------------------------------------------------------------------

@pytest.fixture(scope="module")
def tomo_root(tmp_path_factory):
    """``tomograms/<sample>/t{i}.hdf`` in the reference layout, one of them
    with cached SAM2 pyramids."""
    root = tmp_path_factory.mktemp("tomos") / "tomograms"
    rng = np.random.default_rng(5)
    for sample in ("AD", "Young"):
        for i in range(2):
            arrays = make_synthetic_tomogram(rng, depth=6, side=32)
            if sample == "AD" and i == 0:
                arrays.update({f"sam_features/{k}/{lvl}": rng.standard_normal(
                    (6, 4, 2 ** (3 - lvl), 2 ** (3 - lvl))).astype(np.float16)
                    for k in ("backbone_fpn", "vision_pos_enc") for lvl in range(3)})
            write_hdf(root / sample / f"t{i}.hdf", arrays)
    return root


def _same_items(a, b) -> None:
    assert (a.sample, a.tomo_name, a.split_id) == (b.sample, b.tomo_name, b.split_id)
    assert a.data.dtype == b.data.dtype and a.label.dtype == b.label.dtype
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.label, b.label)
    assert (a.aux_data is None) == (b.aux_data is None)
    for key in a.aux_data or {}:
        if key == "sam_features":
            for name, levels in a.aux_data[key].items():
                for x, y in zip(levels, b.aux_data[key][name], strict=True):
                    np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a.aux_data[key], b.aux_data[key])


@pytest.mark.parametrize("input_key, train, aux_keys", [
    ("dino_features", False, ["data"]),
    ("dino_features", True, []),
    ("data", True, ["sam_features"]),
    ("data", False, ["sam_features", "labels/mito", "nowhere"]),
])
def test_tomo_dataset_items_equal_jax(tomo_root, input_key, train, aux_keys):
    records = [{"sample": s, "tomo_name": f"t{i}.hdf", "split_id": i}
               for s in ("AD", "Young") for i in range(2)]
    kwargs = dict(input_key=input_key, label_key="mito", data_root=tomo_root, train=train,
                  aux_keys=aux_keys, split_key="split_id", seed=3, max_crop_depth=4)
    want = jax_data.TomoDataset(pd.DataFrame(records), **kwargs)
    got = port_data.TomoDataset(records, **kwargs)
    assert len(got) == len(want) == 4
    for _ in range(2):  # the crops draw from each dataset's own generator
        for i in range(4):
            _same_items(got[i], want[i])
    with pytest.raises(IndexError):
        got[4]


@pytest.mark.parametrize("use_sam", [False, True])
def test_vit_dataset_items_equal_jax(tomo_root, use_sam):
    """Raw ``data`` of each record, edge-padded to a multiple of 16 unless
    ``use_sam``; the raw volume in ``aux_data``."""
    records = [{"sample": "Young", "tomo_name": "t1.hdf", "split_id": 1},
               {"sample": "AD", "tomo_name": "t0.hdf", "split_id": 0}]
    want = jax_data.VITDataset(pd.DataFrame(records), data_root=tomo_root, use_sam=use_sam)
    got = port_data.VITDataset(records, data_root=tomo_root, use_sam=use_sam)
    assert len(got) == len(want) == 2
    for i in range(2):
        _same_items(got[i], want[i])


# ---- train and evaluate ---------------------------------------------------------

@pytest.fixture(scope="module")
def experiment_env(tmp_path_factory):
    """The JAX end-to-end fixture: ``data/tomograms/<sample>/t{0..3}.hdf``
    (depth 4, side 32) and ``data/csv/splits.csv`` (split_id i % 2)."""
    data_dir = tmp_path_factory.mktemp("exp") / "data"
    rng = np.random.default_rng(42)
    rows = []
    for sample in ("AD", "Young"):
        for i in range(4):
            name = f"t{i}.hdf"
            write_hdf(data_dir / "tomograms" / sample / name,
                      make_synthetic_tomogram(rng, depth=4, side=32))
            rows.append({"sample": sample, "tomo_name": name, "split_id": i % 2})
    _write_splits(data_dir / "csv" / "splits.csv", rows)
    return data_dir


def _overrides(data_dir, exp_dir, model="cryovit", *extra):
    return [f"model={model}", "datamodule=single", "label_key=mito", "datamodule.sample=AD",
            "datamodule.split_id=1", "datamodule.test_sample=Young", "trainer.precision=f32",
            f"paths.data_dir={data_dir}", f"paths.exp_dir={exp_dir}", *extra]


def _csv_rows(exp_dir: Path, name: str) -> list[dict]:
    (path,) = sorted((exp_dir / "results" / name).glob("*.csv"))
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def trained(experiment_env, tmp_path_factory):
    """The port's train experiment (2 epochs, no logger), then a copy of its
    directory where JAX's load_weights + save_weights hold the weights as
    ``weights.msgpack`` only."""
    root = tmp_path_factory.mktemp("runs")
    cfg = compose("train_model", _overrides(experiment_env, root / "port", "cryovit",
                                            "trainer.max_epochs=2", "logger={}"))
    exp_dir = train_trainer(cfg, device="cpu")
    shutil.copytree(root / "port", root / "jax")
    jax_exp = root / "jax" / exp_dir.relative_to(root / "port")
    save_weights(jax_exp / "weights.msgpack", load_weights(jax_exp / "weights.pt"))
    (jax_exp / "weights.pt").unlink()
    return root, exp_dir, jax_exp, str(cfg.name)


def test_train_experiment_writes_weights_pt_in_the_jax_layout(trained):
    root, exp_dir, _, name = trained
    assert exp_dir == root / "port" / name / "AD" / "split_1"
    assert name == "single_any_cryovit_mito"
    sd = torch.load(exp_dir / "weights.pt", map_location="cpu", weights_only=True)
    assert "output_layer.2.weight" in sd and all(v.dtype == torch.float32 for v in sd.values())


def test_eval_experiment_matches_jax(experiment_env, trained):
    root, _, _, name = trained
    eval_ov = ["logger={}", f"name={name}"]
    jax_results = jax_eval_trainer(jax_compose(
        "eval_model", _overrides(experiment_env, root / "jax", "cryovit", *eval_ov)))
    port_results = eval_trainer(compose(
        "eval_model", _overrides(experiment_env, root / "port", "cryovit", *eval_ov)),
        device="cpu")
    assert len(port_results) == len(jax_results) == 4  # every Young tomogram
    want = _csv_rows(root / "jax", name)
    got = _csv_rows(root / "port", name)
    assert [list(r) for r in got] == [list(r) for r in want]
    assert list(got[0]) == ["sample", "tomo_name", "dice_metric", "f1_metric"]
    for g, w in zip(got, want, strict=True):
        assert (g["sample"], g["tomo_name"]) == (w["sample"], w["tomo_name"])
        for key in ("dice_metric", "f1_metric"):
            assert abs(float(g[key]) - float(w[key])) <= TOL, (g, w)
            assert 0.0 <= float(g[key]) <= 1.0
    for p, j in zip(port_results, jax_results, strict=True):
        np.testing.assert_allclose(p.preds[0], np.asarray(j.preds[0]), atol=TOL, rtol=0)
    preds = sorted((root / "port" / "predictions" / name).rglob("*.hdf"))
    assert len(preds) == 4

    # the port on the JAX experiment (weights.msgpack only) gives JAX's metrics
    shutil.rmtree(root / "jax" / "results")
    eval_trainer(compose("eval_model", _overrides(experiment_env, root / "jax", "cryovit",
                                                  *eval_ov)), device="cpu")
    for g, w in zip(_csv_rows(root / "jax", name), want, strict=True):
        for key in ("dice_metric", "f1_metric"):
            assert abs(float(g[key]) - float(w[key])) <= TOL, (g, w)

    # a rerun replaces the rows
    eval_trainer(compose("eval_model", _overrides(experiment_env, root / "port", "cryovit",
                                                  *eval_ov)), device="cpu")
    assert len(_csv_rows(root / "port", name)) == 4


def test_resume_ckpt_continues_from_last_ckpt(experiment_env, tmp_path):
    """``resume_ckpt=true`` writes ``last.ckpt`` each epoch and a second run
    starts from it: after a run of one epoch, a run to two epochs takes the
    second epoch's steps only, its step count carried on from the file."""
    steps, calls = [], []

    def run(max_epochs):
        cfg = compose("train_model", _overrides(experiment_env, tmp_path, "cryovit",
                                                f"trainer.max_epochs={max_epochs}", "logger={}",
                                                "resume_ckpt=true"))
        from cryovit_tpu_torch.run import common

        build = common.build_trainer

        def recording(*args, **kwargs):
            trainer = build(*args, **kwargs)
            train_step = trainer.train_step
            trainer.train_step = lambda *a: calls.append(max_epochs) or train_step(*a)
            steps.append(trainer)
            return trainer

        common.build_trainer = recording
        try:
            return train_trainer(cfg, device="cpu")
        finally:
            common.build_trainer = build

    exp_dir = run(1)
    assert (exp_dir / "last.ckpt").exists()
    assert run(2) == exp_dir
    # two AD training tomograms an epoch
    assert [t.step for t in steps] == [2, 4] and calls == [1, 1, 2, 2]


def test_eval_without_weights_raises(experiment_env, tmp_path):
    cfg = compose("eval_model", _overrides(experiment_env, tmp_path, "cryovit"))
    with pytest.raises(FileNotFoundError, match="weights.pt"):
        eval_trainer(cfg, device="cpu")


def test_unet3d_experiment_one_epoch(experiment_env, tmp_path):
    cfg = compose("train_model", _overrides(experiment_env, tmp_path, "unet3d",
                                            "trainer.max_epochs=1", "logger={}"))
    exp_dir = train_trainer(cfg, device="cpu")
    assert (exp_dir / "weights.pt").exists()
    assert exp_dir == tmp_path / "single_any_unet3d_mito" / "AD" / "split_1"


def test_sam2_experiment_trains_clipped_and_evaluates(experiment_env, tmp_path):
    """SAM2 (``SAM2Config.tiny_test()`` through ``custom_kwargs.test_config``)
    in the experiment mode: ``trainer_model/sam2.yaml`` clips the gradients'
    global norm at 1, the cond slices draw from the run's seed, no published
    checkpoint (random weights, with a warning); eval scores every Young
    tomogram from its ``weights.pt``."""
    extra = ["+model.custom_kwargs.test_config=true", "logger={}"]
    cfg = compose("train_model", _overrides(experiment_env, tmp_path, "sam2",
                                            "trainer.max_epochs=1", *extra))
    assert cfg.trainer.gradient_clip_val == 1 and cfg.model.lr == 5e-5
    exp_dir = train_trainer(cfg, device="cpu")
    assert exp_dir == tmp_path / "single_any_sam2_mito" / "AD" / "split_1"
    assert (exp_dir / "weights.pt").exists()
    results = eval_trainer(compose("eval_model", _overrides(experiment_env, tmp_path, "sam2",
                                                            *extra)), device="cpu")
    assert [r.tomo_names[0] for r in results] == [f"t{i}.hdf" for i in range(4)]
    assert all(0.0 <= r.metrics["dice_metric"] <= 1.0 for r in results)
    assert len(_csv_rows(tmp_path, "single_any_sam2_mito")) == 4


def test_medsam_grid_point_fails_alone(experiment_env, tmp_path, monkeypatch):
    """``test_experiment``'s grid, cut to its single-datamodule CryoVIT,
    MedSAM and UNet3D points: MedSAM fails (Hiera-T, ROADMAP C2) and is
    logged, the other two train, the exit code is 1."""
    grid = [g for g in training.expand_sweep_file("test_experiment")
            if "datamodule=single" in g and any(f"model={m}" in g
                                                for m in ("cryovit", "medsam", "unet3d"))]
    assert [g[-1] for g in grid] == ["model=cryovit", "model=unet3d", "model=medsam"]
    monkeypatch.setattr(training, "expand_sweep_file", lambda name: grid)
    ran = []

    def run(cfg, device):
        ran.append(cfg._choices_["model"])
        return train_trainer(cfg, device=device)

    argv = [f"paths.data_dir={experiment_env}", f"paths.exp_dir={tmp_path}",
            "trainer.precision=f32", "logger={}", "+experiments=test_experiment",
            "--device", "cpu"]
    assert training.sweep_main("train_model", run, validate_experiment_config, argv) == 1
    assert ran == ["cryovit", "unet3d", "medsam"]
    assert (tmp_path / "test" / "AD" / "split_1" / "weights.pt").exists()


def test_sweep_stops_at_a_config_error(experiment_env, tmp_path):
    ran = []
    argv = [f"paths.data_dir={experiment_env}", "model=cryovit", "datamodule=single",
            "datamodule.sample=Nope", "label_key=mito", "--device", "cpu"]
    assert training.sweep_main("train_model", lambda c, device: ran.append(c),
                               validate_experiment_config, argv) == 1
    assert ran == []


def test_entry_points_default_to_the_gpu(experiment_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [f"paths.data_dir={experiment_env}", "model=cryovit", "datamodule=single",
            "datamodule.sample=AD", "label_key=mito"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        training.sweep_main("train_model", train_trainer, validate_experiment_config, argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_trainer(compose("train_model", argv))


def test_trainer_refuses_a_mesh_and_drops_donation(experiment_env, tmp_path):
    """``trainer.mesh_shape`` now reaches the Trainer: with no process group
    a world of one builds a mesh of size one (tests/test_torch_parallel.py
    runs the multi-rank meshes); ``donate_state`` is still dropped."""
    ov = _overrides(experiment_env, tmp_path, "cryovit", "logger={}")
    meshed = build_trainer(compose("train_model", ov + ["trainer.mesh_shape={data: -1}"]), "cpu")
    assert meshed.mesh.shape == {"data": 1} and meshed.mesh.size == 1 and meshed.is_main
    assert meshed.device == torch.device("cpu")
    trainer = build_trainer(compose("train_model", ov + ["trainer.donate_state=false"]), "cpu")
    assert trainer.mesh is None
    assert trainer.precision == "f32" and trainer.max_epochs == 50
    assert [type(c).__name__ for c in trainer.callbacks] == ["ProgressBar",
                                                             "StochasticWeightAveraging"]
    assert trainer.callbacks[1].swa_lrs == 1e-4


def test_exp_dir_layout_matches_jax(tmp_path):
    from cryovit_tpu.run.common import setup_exp_dir as jax_setup_exp_dir

    for overrides in (
        ["model=cryovit", "datamodule=single", "datamodule.sample=AD", "datamodule.split_id=3"],
        ["model=unet3d", "datamodule=multi", "datamodule.sample=[Young, AD]",
         "datamodule.test_sample=[Aged]"],
        ["model=cryovit", "datamodule=fractional", "datamodule.sample=[AD, Young]",
         "datamodule.split_id=4", "datamodule.test_sample=2"],
        ["model=sam2", "datamodule=fractional_loo", "datamodule.sample=[AD, Young]",
         "datamodule.test_sample=Young"],
    ):
        ov = overrides + ["label_key=mito", f"paths.exp_dir={tmp_path}"]
        got = setup_exp_dir(compose("train_model", ov))
        assert got == jax_setup_exp_dir(jax_compose("train_model", ov)) and got.is_dir()


def test_no_jax_module_is_imported_by_the_entry_points():
    import subprocess

    code = ("import sys, cryovit_tpu_torch.training.train_model, "
            "cryovit_tpu_torch.training.eval_model; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'cryovit_tpu', 'yaml', 'pandas', 'sklearn', 'h5py')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120, cwd=Path(__file__).parents[1])
    assert out.stdout.strip() == "[]"


# ---- the extraction sweeps (Part B) ----------------------------------------------

@pytest.fixture(scope="module")
def sweep_env(tmp_path_factory):
    """Annotated tomograms under ``data/dino_features/<sample>`` (uint8
    data, int8 labels; AD's order from ``csv/AD.csv``, Young's from the
    directory) and one tiny_test backbone's weights in both formats under
    ``models/DINOv2``."""
    root = tmp_path_factory.mktemp("sweep")
    data_dir, rng = root / "data", np.random.default_rng(9)
    for sample, names in (("AD", ["b.hdf", "a.hdf"]), ("Young", ["t0.hdf"])):
        for name in names:
            label = rng.integers(-1, 2, size=(3, 32, 48)).astype(np.int8)
            write_hdf(data_dir / "dino_features" / sample / name, {
                "data": rng.integers(0, 255, size=(3, 32, 48)).astype(np.uint8),
                "labels/mito": label, "labels/cristae": (label > 0).astype(np.int8)})
    _write_splits(data_dir / "csv" / "AD.csv", [{"tomo_name": "b.hdf"}, {"tomo_name": "a.hdf"}])
    jcfg = JaxDinoV2Config.tiny_test()
    module = jax_dino_features.make_dinov2(jcfg, dtype=jnp.float32)
    variables = randomize(module.init(jax.random.key(0), jnp.zeros((1, 28, 28))), rng)
    model_dir = root / "models" / "DINOv2"
    model_dir.mkdir(parents=True)
    from flax.serialization import msgpack_serialize

    (model_dir / jax_dino_features.WEIGHTS_FILENAME).write_bytes(msgpack_serialize(variables))
    torch.save(_hub_state_dict(dinov2_from_jax(variables)),
               model_dir / dino_features.TORCH_HUB_WEIGHTS)
    return data_dir, root / "models"


def _sweep_overrides(env, out, *extra):
    data_dir, model_dir = env
    return [f"paths.data_dir={data_dir}", f"paths.model_dir={model_dir}",
            f"paths.tomo_name={out}", "batch_size=2", *extra]


def _read_all(path: Path) -> dict:
    out = {}
    with h5py.File(path) as f:
        f.visititems(lambda k, v: out.__setitem__(k, np.asarray(v)) if isinstance(
            v, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_path_in_f32", "quant_int8"])
def test_dino_sweep_writes_what_jax_writes(sweep_env, monkeypatch, quant):
    """Both packages in f32 (the JAX extractor's make_dinov2 asked for f32,
    as the port computes on the CPU)."""
    monkeypatch.setattr(jax_dino_features, "make_dinov2",
                        functools.partial(jax_dino_features.make_dinov2, dtype=jnp.float32))
    extra = ("+quant_int8=true",) if quant else ()
    for out, ov in [("jax_out", extra)] + ([("jax_plain", ())] if quant else []):
        jax_dino_features.run_trainer(jax_compose("dino_features", _sweep_overrides(
            sweep_env, out, *ov)), dino_cfg=JaxDinoV2Config.tiny_test())
    argv = _sweep_overrides(sweep_env, "port_out", *extra) + ["--device", "cpu"]
    assert training.sweep_main("dino_features", functools.partial(
        dino_features.run_trainer, dino_cfg=DinoV2Config.tiny_test()),
        validate_dino_config, argv) == 0
    data_dir = sweep_env[0]
    written = sorted(p.relative_to(data_dir / "port_out")
                     for p in (data_dir / "port_out").rglob("*.hdf"))
    assert written == sorted(p.relative_to(data_dir / "jax_out")
                             for p in (data_dir / "jax_out").rglob("*.hdf"))
    assert [str(p) for p in written] == ["AD/a.hdf", "AD/b.hdf", "Young/t0.hdf"]
    for rel in written:
        got, want = _read_all(data_dir / "port_out" / rel), _read_all(data_dir / "jax_out" / rel)
        assert sorted(got) == sorted(want) == ["data", "dino_features", "labels/cristae",
                                               "labels/mito"]
        for key in ("data", "labels/cristae", "labels/mito"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
        g, w = got["dino_features"], want["dino_features"]
        assert g.dtype == w.dtype == np.float16 and g.shape == w.shape == (64, 3, 2, 3)
        g, w = g.astype(np.float32), w.astype(np.float32)
        if quant:
            assert np.linalg.norm(g - w) / np.linalg.norm(w) <= DINO_LIMIT
            # the limit tells int8 from unquantized: JAX's two lie 3x farther apart
            u = _read_all(data_dir / "jax_plain" / rel)["dino_features"].astype(np.float32)
            assert np.linalg.norm(u - w) / np.linalg.norm(w) >= 3 * DINO_LIMIT
        else:
            np.testing.assert_allclose(g, w, atol=1e-3, rtol=0)


def test_sam_sweep_writes_the_extractor_pyramids(sweep_env, tmp_path):
    """``sam_features`` with ``sample=Young`` and seeded weights (``SAM2Config.tiny_test()``):
    the source's volume and labels, and per level the pyramids that
    ``SamFeatureExtractor`` gives the same tomogram with the same weights."""
    data_dir = sweep_env[0]
    argv = _sweep_overrides(sweep_env, "sam_out", "sample=Young", "+random_init=true",
                            "batch_size=2") + ["--device", "cpu"]
    cfg_sam = SAM2Config.tiny_test()
    assert training.sweep_main("sam_features", functools.partial(
        sam_features.run_trainer, sam_cfg=cfg_sam), validate_dino_config, argv) == 0
    (path,) = sorted((data_dir / "sam_out").rglob("*.hdf"))
    assert path.relative_to(data_dir / "sam_out") == Path("Young/t0.hdf")
    got = _read_all(path)
    source = _read_all(data_dir / "dino_features" / "Young" / "t0.hdf")
    np.testing.assert_array_equal(got["data"], source["data"])
    np.testing.assert_array_equal(got["labels/mito"], source["labels/mito"])
    extractor = sam_features.SamFeatureExtractor(
        sam_features.load_sam_encoder(random_init=True, cfg=cfg_sam, device="cpu"), batch_size=2)
    want = extractor.extract(source["data"].astype(np.float32) / 255.0)
    for key, levels in want.items():
        for i, level in enumerate(levels):
            np.testing.assert_array_equal(got[f"sam_features/{key}/{i}"], level)


def test_export_features_is_refused_until_visualization_is_ported(sweep_env, tmp_path):
    """Visualization is ported: ``export_features=true`` is no longer
    refused and writes each tomogram's PCA maps (slice 0 of the depth-3
    volumes) under ``exp_dir/dino_images/<sample>/<stem>``, beside the
    training-ready files (the PNGs against the JAX package's:
    ``tests/test_torch_visualization.py``)."""
    cfg = compose("dino_features", _sweep_overrides(sweep_env, "exported", "export_features=true",
                                                    "+random_init=true", f"paths.exp_dir={tmp_path}"))
    dino_features.run_trainer(cfg, dino_cfg=DinoV2Config.tiny_test(), device="cpu")
    images = tmp_path / "dino_images"
    assert sorted(str(p.relative_to(images)) for p in images.rglob("*.png")) == [
        "AD/a/0.png", "AD/b/0.png", "Young/t0/0.png"]
    assert len(list((sweep_env[0] / "exported").rglob("*.hdf"))) == 3


def test_pipeline_io_keeps_order_and_overlaps():
    import threading

    seen = []
    out = pipeline_io(7, lambda i: i * 10, lambda i, item: item + 1,
                      lambda i, r: seen.append(threading.current_thread().name) or (i, r))
    assert out == [(i, i * 10 + 1) for i in range(7)]
    assert all(name.startswith("cryovit-write") for name in seen)
    assert pipeline_io(0, None, None, None) == []
