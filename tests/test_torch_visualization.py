"""Visualization: the port's DINOv2 PCA maps, experiment statistics and
figures, overlay videos and ``visualize_results`` against the JAX package's,
on the CPU.

- ``_calculate_pca`` on fp16 features with a planted, well-separated top-3
  spectrum (singular values 10, 6, 3 over noise 0.1) at shapes where sklearn
  takes an exact solver (``full`` or ``covariance_eigh``): within 1e-4 ×
  max|JAX| of the JAX package's (sklearn, f32) and within 1e-5 × max of a
  float64 numpy reference with sklearn's sign rule;
- ``_color_features`` and the HSV copies bit for bit matplotlib's (grey
  pixels and channel ties included); the bicubic resize of the raw slice bit
  for bit Pillow's; the PNG writer read by Pillow;
- ``export_pca``'s PNGs decoded by Pillow: raw halves equal, map halves
  within MAP_LEVELS levels on all but MAP_SHARE of the pixels, at the JAX
  test's 12×32×32 (grid 2×2) and at 12×30×45, where JAX resizes the raw
  slice;
- ``run_dino(visualize=True)`` and the ``export_features=true`` sweep write
  the JAX package's PNG sets on the same tiny DINOv2 weights (f32), within
  the same limits;
- ``merge_experiments``' CSVs and ``compute_stats``' table equal JAX's,
  ``significance_test``'s p-values equal; each ``process_*_experiment`` and
  the video walker write JAX's file set; ``visualize_results`` dispatches
  every ``--exp_type`` with JAX's experiment-name tables.
"""

import csv
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

import cryovit_tpu.run.dino_features as jax_dino_features
import cryovit_tpu.training.visualize_results as jax_visualize_results
import cryovit_tpu.visualization as jax_viz
import cryovit_tpu.visualization.dino_pca as jax_pca
from cryovit_tpu.config import compose as jax_compose
from cryovit_tpu.io import write_hdf
from cryovit_tpu.models.dinov2 import DinoV2Config as JaxDinoV2Config
from cryovit_tpu_torch import training
from cryovit_tpu_torch.config import validate_dino_config
from cryovit_tpu_torch.convert import dinov2_from_jax
from cryovit_tpu_torch.io import write_mrc
from cryovit_tpu_torch.models.dinov2 import DinoV2Config
from cryovit_tpu_torch.run import dino_features
from cryovit_tpu_torch.training import visualize_results
from cryovit_tpu_torch.visualization import _image
from cryovit_tpu_torch.visualization import dino_pca as pca
from cryovit_tpu_torch import visualization as viz

from test_torch_models import randomize
from test_torch_slice import _hub_state_dict

# the map halves: colours of an f32 embedding quantized to 8 bits; an
# embedding differing at rounding level may move a pixel across a level
MAP_LEVELS = 1
MAP_SHARE = 1e-3


def planted(rng, c, d, gh, gw, sv=(10.0, 6.0, 3.0), noise=0.1):
    """fp16 ``(C, D, gh, gw)`` features whose token matrix has the top three
    singular values ∝ ``sv`` over N(0, noise²) noise."""
    n = d * gh * gw
    u = np.linalg.qr(rng.standard_normal((n, 3)))[0]
    v = np.linalg.qr(rng.standard_normal((c, 3)))[0]
    x = (u * np.asarray(sv)) @ v.T * np.sqrt(n) / 3 + noise * rng.standard_normal((n, c))
    return x.reshape(d, gh, gw, c).transpose(3, 0, 1, 2).astype(np.float16)


def _float64_embedding(features):
    """The exact embedding in float64 numpy: the top three right singular
    vectors of the centred tokens, each signed so its largest-magnitude
    entry is positive, applied to the features upsampled 2× (f32 bicubic)."""
    f32 = features.astype(np.float32)
    c, d, gh, gw = f32.shape
    x = f32.transpose(1, 2, 3, 0).reshape(-1, c).astype(np.float64)
    mean = x.mean(0)
    vt = np.linalg.svd(x - mean, full_matrices=False)[2][:3]
    vt *= np.sign(vt[np.arange(3), np.abs(vt).argmax(1)])[:, None]
    up = pca.resize_bicubic_2d(torch.from_numpy(f32), 2 * gh, 2 * gw).numpy()
    y = up.transpose(1, 2, 3, 0).reshape(-1, c).astype(np.float64)
    return ((y - mean) @ vt.T).reshape(d, 2 * gh, 2 * gw, 3)


@pytest.mark.parametrize("shape", [(64, 2, 2, 2), (32, 2, 8, 8), (96, 4, 4, 6)],
                         ids=["full", "covariance_eigh", "full_wide"])
def test_calculate_pca_matches_jax_and_float64(shape):
    f = planted(np.random.default_rng(sum(shape)), *shape)
    got = pca._calculate_pca(torch.from_numpy(f)).numpy()
    want = jax_pca._calculate_pca(f.astype(np.float32))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), rtol=0)
    exact = _float64_embedding(f)
    np.testing.assert_allclose(got, exact, atol=1e-5 * np.abs(exact).max(), rtol=0)


def test_fit_pca_variances_and_signs():
    f = planted(np.random.default_rng(3), 48, 3, 4, 4)
    x = torch.from_numpy(f).float().permute(1, 2, 3, 0).reshape(-1, 48)
    mean, comps, var = pca.fit_pca(x)
    xn = x.double().numpy()
    want = np.linalg.svd(xn - xn.mean(0), compute_uv=False) ** 2 / (len(xn) - 1)
    np.testing.assert_allclose(var.numpy()[:10], want[:10], rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(comps.numpy() @ comps.numpy().T, np.eye(3), atol=1e-12)
    c = comps.numpy()
    assert (c[np.arange(3), np.abs(c).argmax(1)] > 0).all()


def _embedding_with_ties(rng):
    e = rng.standard_normal((2, 4, 6, 3)).astype(np.float32)
    e[0, 0, 0] = [0.2, 0.2, 0.2]  # grey after scaling: undefined hue
    e[0, 0, 1] = e[..., 0].max(), e[..., 1].max(), -5.0  # red and green tie at 1
    e[1, 1, 1] = e[..., 0].min(), e[..., 1].min(), e[..., 2].min()  # black
    return e


def test_color_features_and_hsv_match_matplotlib(rng):
    from matplotlib.colors import hsv_to_rgb, rgb_to_hsv

    e = _embedding_with_ties(rng)
    got = pca._color_features(e)
    want = jax_pca._color_features(e)
    assert got.dtype == want.dtype == np.uint8 and got.shape == (2, 32, 48, 3)
    np.testing.assert_array_equal(got, want)
    x = rng.random((30, 3)).astype(np.float32)
    x[0], x[1], x[2], x[3] = 0.5, [1, 1, 0.1], [0.3, 0.9, 0.9], [0.7, 0.2, 0.7]
    for arr in (x, x.astype(np.float64)):
        np.testing.assert_array_equal(_image.rgb_to_hsv(arr), rgb_to_hsv(arr))
        hsv = rgb_to_hsv(arr)
        hsv[4, 1] = 0.0  # the zero-saturation branch
        np.testing.assert_array_equal(_image.hsv_to_rgb(hsv), hsv_to_rgb(hsv))


@pytest.mark.parametrize("sizes", [(30, 45, 32, 48), (17, 48, 32, 48), (64, 50, 32, 80),
                                   (500, 301, 512, 304)])
def test_resize_bicubic_uint8_matches_pillow(rng, sizes):
    h, w, oh, ow = sizes
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).convert("RGB").resize((ow, oh)))
    np.testing.assert_array_equal(_image.resize_bicubic_uint8(img, oh, ow), want[..., 0])


def test_png_writer_reads_back_in_pillow(rng, tmp_path):
    img = rng.integers(0, 256, (19, 33, 3), dtype=np.uint8)
    path = _image.write_png(tmp_path / "x.png", img)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(_image.read_png(path), img)


def assert_same_pngs(got_dir: Path, want_dir: Path) -> int:
    """The same relative PNG paths; each image's raw half equal and its map
    half within MAP_LEVELS on all but MAP_SHARE of the pixels. Returns the
    number of images."""
    got = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*.png"))
    assert got == sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.png")) and got
    for rel in got:
        with Image.open(got_dir / rel) as a, Image.open(want_dir / rel) as b:
            a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.uint8
        w = a.shape[1] // 2
        np.testing.assert_array_equal(a[:, :w], b[:, :w])
        diff = np.abs(a[:, w:].astype(int) - b[:, w:])
        assert diff.max() <= MAP_LEVELS or (diff > MAP_LEVELS).mean() <= MAP_SHARE, rel
    return len(got)


@pytest.mark.parametrize("dhw", [(12, 32, 32), (12, 30, 45)], ids=["grid_2x2", "resized_raw"])
@pytest.mark.parametrize("frame_id", [None, 7])
def test_export_pca_matches_jax(tmp_path, dhw, frame_id):
    rng = np.random.default_rng(dhw[2] + (frame_id or 0))
    d, h, w = dhw
    f = planted(rng, 64, d, -(-h // 16), -(-w // 16))
    data = rng.random(dhw).astype(np.float32)
    jax_pca.export_pca(data, f.astype(np.float32), "t", tmp_path / "jax", frame_id)
    written = pca.export_pca(data, torch.from_numpy(f), "t", tmp_path / "port", frame_id)
    assert [p.name for p in written] == (["0.png", "10.png"] if frame_id is None else ["7.png"])
    assert assert_same_pngs(tmp_path / "port", tmp_path / "jax") == len(written)


def test_export_pca_on_uint8_volumes_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    f = planted(rng, 64, 3, 2, 3)
    data = rng.integers(3, 250, (3, 32, 48), dtype=np.uint8)
    jax_pca.export_pca(data, f.astype(np.float32), "t", tmp_path / "jax")
    pca.export_pca(data, f, "t", tmp_path / "port")
    assert_same_pngs(tmp_path / "port", tmp_path / "jax")


# ---- run_dino(visualize=True) and the export_features sweep ---------------------

@pytest.fixture(scope="module")
def dino_env(tmp_path_factory):
    """Two uint8 MRC tomograms (one of them 30×45, edge-padded to 32×48), two
    annotated HDF5 tomograms under ``data/dino_features/AD``, and one
    tiny_test backbone's weights as the JAX package's msgpack and as a torch
    hub checkpoint under ``models/DINOv2``."""
    root = tmp_path_factory.mktemp("viz")
    rng = np.random.default_rng(11)
    (root / "tomos").mkdir()
    write_mrc(root / "tomos" / "a.mrc", rng.integers(0, 255, (12, 32, 48), dtype=np.uint8))
    write_mrc(root / "tomos" / "b.mrc", rng.integers(0, 255, (11, 30, 45), dtype=np.uint8))
    for name in ("x.hdf", "y.hdf"):
        write_hdf(root / "data" / "dino_features" / "AD" / name, {
            "data": rng.integers(0, 255, size=(12, 32, 48)).astype(np.uint8),
            "labels/mito": rng.integers(-1, 2, size=(12, 32, 48)).astype(np.int8)})
    module = jax_dino_features.make_dinov2(JaxDinoV2Config.tiny_test(), dtype=jnp.float32)
    variables = randomize(module.init(jax.random.key(0), jnp.zeros((1, 28, 28))), rng)
    model_dir = root / "models" / "DINOv2"
    model_dir.mkdir(parents=True)
    from flax.serialization import msgpack_serialize

    (model_dir / jax_dino_features.WEIGHTS_FILENAME).write_bytes(msgpack_serialize(variables))
    torch.save(_hub_state_dict(dinov2_from_jax(variables)),
               model_dir / dino_features.TORCH_HUB_WEIGHTS)
    return root


@pytest.fixture
def jax_in_f32(monkeypatch):
    """The JAX extractor in f32, as the port computes on the CPU."""
    monkeypatch.setattr(jax_dino_features, "make_dinov2",
                        functools.partial(jax_dino_features.make_dinov2, dtype=jnp.float32))


def test_run_dino_visualize_writes_what_jax_writes(dino_env, jax_in_f32, monkeypatch):
    monkeypatch.setenv("CRYOVIT_MODEL_DIR", str(dino_env / "models"))
    files = sorted((dino_env / "tomos").glob("*.mrc"))
    jax_dino_features.run_dino(files, dino_env / "jax_feats", batch_size=8, visualize=True,
                               dino_cfg=JaxDinoV2Config.tiny_test())
    dino_features.run_dino(files, dino_env / "port_feats", batch_size=8,
                           dino_cfg=DinoV2Config.tiny_test(),
                           model_dir=dino_env / "models" / "DINOv2", device="cpu",
                           visualize=True)
    images = dino_env / "port_feats" / "dino_images"
    assert sorted(str(p.relative_to(images)) for p in images.rglob("*.png")) == [
        "a/a/0.png", "a/a/10.png", "b/b/0.png", "b/b/10.png"]
    assert assert_same_pngs(images, dino_env / "jax_feats" / "dino_images") == 4


def test_dino_sweep_export_features_writes_what_jax_writes(dino_env, jax_in_f32):
    def overrides(out):
        return [f"paths.data_dir={dino_env / 'data'}", f"paths.model_dir={dino_env / 'models'}",
                f"paths.exp_dir={dino_env / out}", f"paths.tomo_name={out}", "batch_size=4",
                "export_features=true"]

    jax_dino_features.run_trainer(jax_compose("dino_features", overrides("jax_exp")),
                                  dino_cfg=JaxDinoV2Config.tiny_test())
    assert training.sweep_main("dino_features", functools.partial(
        dino_features.run_trainer, dino_cfg=DinoV2Config.tiny_test()), validate_dino_config,
        overrides("port_exp") + ["--device", "cpu"]) == 0
    images = dino_env / "port_exp" / "dino_images"
    assert sorted(str(p.relative_to(images)) for p in images.rglob("*.png")) == [
        "AD/x/0.png", "AD/x/10.png", "AD/y/0.png", "AD/y/10.png"]
    assert assert_same_pngs(images, dino_env / "jax_exp" / "dino_images") == 4
    # process_samples on the training-ready files: the dino_pca figure type
    jax_viz.process_samples(dino_env / "data" / "jax_exp", dino_env / "jax_pca")
    viz.process_samples(dino_env / "data" / "port_exp", dino_env / "port_pca", device="cpu")
    assert assert_same_pngs(dino_env / "port_pca", dino_env / "jax_pca") == 4


# ---- statistics, figures, videos, the dispatcher --------------------------------

MODELS = {"cryovit": "CryoVIT", "unet3d": "3D U-Net", "sam2": "SAM2"}


def _results_tree(root: Path, rng, names: list[str], samples=("AD", "HD"), n=6,
                  split_ids=(1, 2)) -> None:
    """Per-sample metric CSVs, as the eval writers leave them, under
    ``root/<name>/<sample>.csv``."""
    for name in names:
        for sample in samples:
            rows = [{"tomo_name": f"t{i}.hdf", "sample": sample,
                     "split_id": split_ids[i % len(split_ids)],
                     "dice_metric": float(rng.random()), "f1_metric": float(rng.random())}
                    for i in range(n)]
            (root / name).mkdir(parents=True, exist_ok=True)
            with open(root / name / f"{sample}.csv", "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(rows[0]))
                writer.writeheader()
                writer.writerows(rows)


def _files(root: Path) -> list[str]:
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_merge_and_statistics_match_jax(tmp_path):
    names = {f"single_ad_{k}_mito": [v, "AD"] for k, v in MODELS.items()}
    for which in ("jax", "port"):
        _results_tree(tmp_path / which, np.random.default_rng(4), list(names))
    want = jax_viz.merge_experiments(tmp_path / "jax", names, keys=["model", "group"])
    got = viz.merge_experiments(tmp_path / "port", names, keys=["model", "group"])
    pd.testing.assert_frame_equal(got, want)
    for name in names:
        assert (tmp_path / "port" / f"{name}.csv").read_bytes() == (
            tmp_path / "jax" / f"{name}.csv").read_bytes()
    for test_fn in ("wilcoxon", "ttest_rel"):
        assert viz.significance_test(got, "CryoVIT", "SAM2", test_fn=test_fn) == \
            jax_viz.significance_test(want, "CryoVIT", "SAM2", test_fn=test_fn)
    for which, mod, df in (("jax", jax_viz, want), ("port", viz, got)):
        fn = functools.partial(mod.significance_test, model_A="CryoVIT", model_B="3D U-Net")
        p = mod.compute_stats(df, ["sample", "model"], str(tmp_path / f"{which}.csv"), fn)
        assert len(p) == 2
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    with pytest.raises(ValueError, match="Unknown test function"):
        viz.significance_test(got, "CryoVIT", "SAM2", test_fn="nope")


_PROCESSORS = {
    "single": (["model", "group"], lambda k, v, g: [v, g]),
    "multi": (["model", "group"], lambda k, v, g: [v, "forward"]),
    "multi_label": (["model", "label"], lambda k, v, g: [v, g]),
    "multi_label_sample": (["model", "label"], lambda k, v, g: [v, g]),
    "fractional": (["model"], lambda k, v, g: [v]),
    "sparse": (["model", "annotation"], lambda k, v, g: [v, g]),
}


@pytest.mark.parametrize("exp_type", list(_PROCESSORS))
def test_process_experiments_write_the_jax_file_set(tmp_path, exp_type):
    groups = ("mito", "cristae") if exp_type.startswith("multi_label") else ("Sparse", "Dense")
    names = {f"{exp_type}_{k}_{g}": _PROCESSORS[exp_type][1](k, v, g)
             for k, v in list(MODELS.items())[:2] for g in groups[:1 if exp_type == "fractional"
                                                                  else 2]}
    exp_names = {"AD": names}
    fn = f"process_{exp_type}_experiment"
    for which, mod in (("jax", jax_viz), ("port", viz)):
        _results_tree(tmp_path / which / "exp", np.random.default_rng(5), list(names),
                      split_ids=(1, 2, 3))
        getattr(mod, fn)(exp_type, "all", exp_names, tmp_path / which / "exp",
                         tmp_path / which / "fig")
    got, want = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert got == want and any(f.endswith(".svg") for f in got)
    for rel in got:
        if rel.endswith(".csv"):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_overlay_videos_write_the_jax_file_set(tmp_path):
    import h5py

    rng = np.random.default_rng(6)
    for sample in ("AD", "HD"):
        for tomo in ("t0", "t1"):
            path = tmp_path / "preds" / "run" / sample / f"{tomo}.hdf"
            path.parent.mkdir(parents=True, exist_ok=True)
            with h5py.File(path, "w") as f:
                f["data"] = rng.integers(0, 255, (4, 16, 24)).astype(np.uint8)
                f["mito_preds"] = rng.random((4, 16, 24)).astype(np.float32)
                f["cristae"] = (rng.random((4, 16, 24)) > 0.5).astype(np.float32)
    want = jax_viz.process_experiment(tmp_path / "preds", tmp_path / "jax")
    got = viz.process_experiment(tmp_path / "preds", tmp_path / "port")
    assert [p.relative_to(tmp_path / "port") for p in got] == [
        p.relative_to(tmp_path / "jax") for p in want]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax") == [
        "AD/t0.mp4", "AD/t1.mp4", "HD/t0.mp4", "HD/t1.mp4"]
    assert all((tmp_path / "port" / f).stat().st_size > 0 for f in _files(tmp_path / "port"))


def test_visualize_results_dispatches_every_exp_type(tmp_path, monkeypatch):
    calls = []
    targets = {"dino_pca": "process_samples", "segmentations": "process_experiment",
               **{t: f"process_{t}_experiment" for t in _PROCESSORS}}
    for name in set(targets.values()):
        monkeypatch.setattr(viz, name, lambda *a, _n=name, **k: calls.append((_n, a, k)))
    tables = {"single": jax_visualize_results._single_names(),
              "multi": jax_visualize_results._multi_names(),
              "multi_label": jax_visualize_results._label_names(),
              "multi_label_sample": jax_visualize_results._label_names(),
              "fractional": jax_visualize_results._fractional_names(),
              "sparse": jax_visualize_results._sparse_names()}
    argv = ["--exp_dir", str(tmp_path), "--result_dir", str(tmp_path / "out")]
    for exp_type, fn in targets.items():
        calls.clear()
        assert visualize_results.main(["--exp_type", exp_type, *argv, "--device", "cpu"]) == 0
        ((name, args, kwargs),) = calls
        assert name == fn
        if exp_type in tables:
            assert args == (exp_type, "all", tables[exp_type], tmp_path, tmp_path / "out")
        elif exp_type == "dino_pca":
            assert kwargs == {"sample": None, "device": "cpu"}
    with pytest.raises(SystemExit):
        visualize_results.main(["--exp_type", "nope", *argv])


@pytest.mark.parametrize("use_sam", [False, True])
def test_features_cli_passes_visualize_to_run_dino(tmp_path, monkeypatch, use_sam):
    """``features -v`` hands ``visualize=True`` to ``run_dino``; with
    ``--use-sam`` the flag draws nothing, as in the JAX package."""
    from cryovit_tpu_torch.cli.main import main
    from cryovit_tpu_torch.run import sam_features

    calls = []
    monkeypatch.setattr(dino_features, "run_dino", lambda *a, **k: calls.append(("dino", k)))
    monkeypatch.setattr(sam_features, "run_sam", lambda *a, **k: calls.append(("sam", k)))
    (tmp_path / "tomos").mkdir()
    write_mrc(tmp_path / "tomos" / "a.mrc", np.zeros((2, 16, 16), np.uint8))
    argv = ["features", str(tmp_path / "tomos"), str(tmp_path / "out"), "-v", "--device", "cpu"]
    assert main(argv + (["--use-sam"] if use_sam else [])) == 0
    ((which, kwargs),) = calls
    assert which == ("sam" if use_sam else "dino")
    assert kwargs.get("visualize") is (None if use_sam else True)
