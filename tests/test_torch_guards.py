"""Guards on the port's boundaries: what it imports, how its kernels are
built, and how its wrappers dispatch; plus its host I/O and command line."""

import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from cryovit_tpu_torch import kernels
from cryovit_tpu_torch.cli.main import main
from cryovit_tpu_torch.io import load_data, load_files_from_path, read_mrc, write_mrc
from cryovit_tpu_torch.ops.conv3d_dm import conv3d_dm, conv3d_dm_dw
from cryovit_tpu_torch.ops.convt_dm import convt2x_dm, convt2x_dm_bwd
from cryovit_tpu_torch.ops.flash_attention import (
    attention_int8_operands,
    attention_int8_scales,
    flash_attention,
    flash_attention_bhnd,
    flash_attention_bnhd,
)
from cryovit_tpu_torch.ops.fused_norm import residual_layernorm
from cryovit_tpu_torch.ops.window_attention import (
    window_attention,
    window_block_attention,
    window_block_mlp,
)


def test_port_imports_no_jax_flax_or_h5py():
    """Every module of the port, the experiment mode's composer, datamodules
    and ``training`` entry points among them, imports in a fresh interpreter
    (this test process has jax loaded through conftest.py) without pulling
    in jax, flax, h5py, pyyaml, pandas, sklearn, wandb, the plotting stack
    (matplotlib, seaborn, cv2, PIL, umap) or the JAX package."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import cryovit_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "h5py", "cryovit_tpu", "yaml",
                                               "pandas", "sklearn", "wandb", "matplotlib",
                                               "seaborn", "cv2", "PIL", "umap"))
        print(len(names), loaded, sorted(n for n in names if ".training." in n
                                         or n.endswith((".composer", ".datamodules"))))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120
    ).stdout.split(maxsplit=2)
    assert int(out[0]) >= 20 and out[1].strip() == "[]", out
    for name in ("composer", "data.datamodules", "training.train_model", "training.eval_model"):
        assert f"cryovit_tpu_torch.{name}'" in out[2], out


def test_experiment_mode_runs_without_yaml_pandas_sklearn_h5py_or_jax(tmp_path):
    """A GPU host without those packages: with yaml, pandas, sklearn, h5py
    and jax made unimportable, ``train_model`` composes, its split datamodule
    reads the splits CSV and yields its records, and ``--list-sweep`` prints
    the grid."""
    (tmp_path / "csv").mkdir()
    (tmp_path / "csv" / "splits.csv").write_text(
        "sample,tomo_name,split_id\n" + "".join(f"AD,t{i}.hdf,{i % 2}\n" for i in range(4)))
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("yaml", "pandas", "sklearn", "h5py", "jax", "flax", "cryovit_tpu"):
            sys.modules[name] = None
        from cryovit_tpu_torch.config import compose, validate_experiment_config
        from cryovit_tpu_torch.run.common import build_datamodule
        from cryovit_tpu_torch.training import sweep_main
        cfg = compose("train_model", ["model=cryovit", "datamodule=fractional_loo",
                                      "label_key=mito", "datamodule.sample=[AD]",
                                      "datamodule.test_sample=AD", "datamodule.split_id=1",
                                      "paths.data_dir={tmp_path}"])
        validate_experiment_config(cfg)
        dm = build_datamodule(cfg)
        print(cfg.model.lr, dm.train_df(), len(dm.test_df()))
        sys.exit(sweep_main("train_model", None, None,
                            ["model=unet3d", "+experiments=multi_bacteria", "--list-sweep"]))
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "0.0001 [] 4", lines[0]
    assert len(lines) == 1 + 3 * 10 * 2
    assert lines[1] == ("0 ['datamodule.sample=CZI_Campy_C', 'datamodule.split_id=0', "
                        "'model=cryovit']")


def test_visualization_runs_without_the_plotting_stack(tmp_path):
    """A GPU host without the plotting stack: with PIL, matplotlib, seaborn,
    cv2, umap, sklearn, pandas, h5py and jax made unimportable,
    ``export_pca`` writes its PNGs, and ``process_experiment`` (the overlay
    videos) raises an ImportError that names cv2 rather than returning."""
    code = textwrap.dedent(
        f"""
        import sys
        for name in ("PIL", "matplotlib", "seaborn", "cv2", "umap", "sklearn", "pandas",
                     "h5py", "jax", "flax", "cryovit_tpu"):
            sys.modules[name] = None
        import numpy as np
        from cryovit_tpu_torch.visualization import export_pca, process_experiment
        from cryovit_tpu_torch.visualization._image import read_png
        rng = np.random.default_rng(0)
        paths = export_pca(rng.random((12, 32, 48)).astype(np.float32),
                           rng.standard_normal((16, 12, 2, 3)).astype(np.float16),
                           "t", r"{tmp_path}")
        print([p.name for p in paths], read_png(paths[0]).shape)
        try:
            process_experiment(r"{tmp_path}", r"{tmp_path / 'videos'}")
        except ImportError as e:
            print("ImportError:", e)
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[0] == "['0.png', '10.png'] (32, 96, 3)", lines
    assert lines[1].startswith("ImportError: cv2 is not installed"), lines
    assert not (tmp_path / "videos").exists()


def test_kernel_loader_names_nvcc_when_the_toolkit_is_missing(monkeypatch, tmp_path):
    """No nvcc anywhere: loading the kernels raises and says so; it never
    hands back the plain versions instead."""
    monkeypatch.setattr(shutil, "which", lambda *_: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels, "DEFAULT_CUDA_HOME", str(tmp_path / "no-cuda-either"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.load_library()


def test_cpu_tensors_take_the_plain_path_and_count_nothing(rng, monkeypatch):
    """Each wrapper, called on CPU tensors, runs its plain version: no kernel
    library is loaded and every launch counter stays at 0."""
    monkeypatch.setattr(kernels, "_lib", None)
    kernels.reset_launch_counts()
    x = torch.from_numpy(rng.standard_normal((1, 3, 8, 4, 6)).astype(np.float32))
    assert conv3d_dm(x, torch.ones(3, 3, 3, 8, 16), (2, 1, 1)).shape == (1, 3, 16, 4, 6)
    assert convt2x_dm(x, torch.ones(1, 2, 2, 8, 8)).shape == (1, 3, 8, 8, 12)
    assert conv3d_dm_dw(x, x, (2, 1, 1)).shape == (3, 3, 3, 8, 8)
    g = torch.ones(1, 3, 16, 8, 12)
    dx, dw = convt2x_dm_bwd(g, x, torch.ones(1, 2, 2, 8, 16))
    assert dx.shape == x.shape and dw.shape == (1, 2, 2, 8, 16)
    q = torch.from_numpy(rng.standard_normal((2, 9, 128)).astype(np.float32))
    assert flash_attention(q, q, q, torch.zeros(3, 128), 2).shape == (2, 9, 128)
    for quant in ("qk", "pv", "qkpv"):
        assert flash_attention(q, q, q, torch.zeros(3, 128), 2, quant=quant).shape == (2, 9, 128)
        assert len(attention_int8_scales(q, q, q, torch.zeros(3, 128), 2, quant=quant)) == 3
        assert len(attention_int8_operands(q, q, q, torch.zeros(3, 128), 2, quant=quant)) == 2
    xw = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    ln = (torch.ones(8), torch.zeros(8))
    assert window_block_attention(xw, *ln, torch.ones(24, 8), torch.zeros(24), torch.ones(8, 8),
                                  torch.zeros(8), 2).shape == (2, 16, 8)
    assert window_block_mlp(xw, *ln, torch.ones(32, 8), torch.zeros(32), torch.ones(8, 32),
                            torch.zeros(8)).shape == (2, 16, 8)
    assert window_attention(xw, xw, xw, 2).shape == (2, 16, 8)
    qh = torch.from_numpy(rng.standard_normal((2, 3, 9, 64)).astype(np.float32))
    assert flash_attention_bhnd(qh, qh, qh).shape == (2, 3, 9, 64)
    assert flash_attention_bnhd(qh, qh, qh, torch.float32).shape == (2, 3, 9, 64)
    x_new, y = residual_layernorm(xw, xw, None, *ln)
    assert x_new.dtype == torch.float32 and y.dtype == torch.bfloat16 and y.shape == (2, 16, 8)
    assert kernels._lib is None
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    assert set(kernels.KERNELS) == {
        "flash_attention", "conv3d_dm", "convt2x_dm", "conv3d_dm_dw", "convt2x_dm_bwd",
        "window_block_attention", "window_block_mlp", "window_attention",
        "flash_attention_bhnd", "flash_attention_bnhd", "residual_layernorm",
        "flash_attention_int8", "flash_attention_int8_scales", "flash_attention_int8_operands",
    }


@pytest.mark.parametrize(
    "op",
    ["attention", "conv3d", "convt", "conv3d_dw", "convt_bwd", "window_block", "window_mlp",
     "window_attention", "attention_bhnd", "attention_bnhd", "residual_layernorm",
     "attention_int8", "attention_int8_scales", "attention_int8_operands"],
)
def test_wrappers_refuse_devices_without_a_kernel(op):
    """A tensor on neither the CPU nor a GPU raises: there is no fallback to
    the plain version outside the CPU."""
    x = torch.empty(1, 2, 8, 4, 4, device="meta")
    w = torch.empty(8, 8, device="meta")
    v = torch.empty(8, device="meta")
    calls = {
        "window_block": lambda: window_block_attention(x[0], v, v, w, v, w, v, 1),
        "window_mlp": lambda: window_block_mlp(x[0], v, v, w, v, w, v),
        "window_attention": lambda: window_attention(x[0], x[0], x[0], 1),
        "attention": lambda: flash_attention(x[0, 0], x[0, 0], x[0, 0], torch.empty(3, 4, device="meta"), 1),
        "attention_int8": lambda: flash_attention(x[0, 0], x[0, 0], x[0, 0],
                                                  torch.empty(3, 4, device="meta"), 1,
                                                  quant="qkpv"),
        "attention_int8_scales": lambda: attention_int8_scales(
            x[0, 0], x[0, 0], x[0, 0], torch.empty(3, 4, device="meta"), 1),
        "attention_int8_operands": lambda: attention_int8_operands(
            x[0, 0], x[0, 0], x[0, 0], torch.empty(3, 4, device="meta"), 1),
        "attention_bhnd": lambda: flash_attention_bhnd(x[0], x[0], x[0]),
        "attention_bnhd": lambda: flash_attention_bnhd(x[0], x[0], x[0]),
        "residual_layernorm": lambda: residual_layernorm(x, x, v, v, v),
        "conv3d": lambda: conv3d_dm(x, torch.empty(3, 3, 3, 8, 8, device="meta")),
        "convt": lambda: convt2x_dm(x, torch.empty(1, 2, 2, 8, 8, device="meta")),
        "conv3d_dw": lambda: conv3d_dm_dw(x, x),
        "convt_bwd": lambda: convt2x_dm_bwd(x, x, torch.empty(1, 2, 2, 8, 8, device="meta")),
    }
    with pytest.raises(ValueError, match="no .*kernel for device meta"):
        calls[op]()


def test_mrc_roundtrip_and_load_data_scaling(tmp_path, rng):
    """uint8 volumes are stored as MRC mode 6 and come back through
    ``load_data`` as f32 / 255 with a leading channel axis, the same bytes
    the JAX package's reader sees."""
    from cryovit_tpu.io import load_data as jax_load_data

    vol = rng.integers(0, 256, size=(3, 20, 24)).astype(np.uint8)
    path = tmp_path / "t.mrc"
    write_mrc(path, vol)
    np.testing.assert_array_equal(read_mrc(path), vol.astype(np.uint16))
    data, _ = load_data(path)
    assert data.dtype == np.float32 and data.shape == (1, 3, 20, 24)
    np.testing.assert_array_equal(data[0], vol.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(data, jax_load_data(path)[0])
    assert load_files_from_path(tmp_path) == [path]


def test_hdf_roundtrip_picks_the_most_unique_key(tmp_path, rng):
    from cryovit_tpu_torch.io import read_hdf, write_hdf

    vol = rng.random((4, 8, 8)).astype(np.float32)
    write_hdf(tmp_path / "a.hdf", {"data": vol, "labels/mito": np.zeros((4, 8, 8), np.int8)})
    key, data, meta = read_hdf(tmp_path / "a.hdf")
    assert key == "data" and meta.dshape == (4, 8, 8)
    np.testing.assert_array_equal(data, vol)


@pytest.mark.parametrize("family", ["medsam"])
def test_cli_verbs_not_yet_ported_exit_with_a_message(family, capsys, tmp_path):
    """``train --model medsam`` is refused with ROADMAP C2's message
    (Hiera-T's odd q-pool window) before anything is read or built."""
    argv = ["train", str(tmp_path), str(tmp_path), "mito", "--labels", "mito",
            "--model", family, "--device", "cpu"]
    with pytest.raises(ValueError, match="C2"):
        main(argv)


@pytest.mark.parametrize("family", ["cryovit", "unet3d", "sam2"])
def test_cli_train_refuses_an_empty_data_folder(family, tmp_path):
    """Every ported ``train --model`` gets past the CLI and refuses a data
    folder with no tomogram in it, naming the folder."""
    argv = ["train", str(tmp_path), str(tmp_path), "mito", "--labels", "mito",
            "--model", family, "--device", "cpu"]
    with pytest.raises(ValueError, match=f"No valid tomogram files found in {tmp_path}"):
        main(argv)


def _eval_files(root):
    """A reference-format CryoVIT ``.model`` (8 feature channels, seeded
    weights) and one 4x32x32 tomogram's feature file and label file."""
    import h5py

    from cryovit_tpu_torch.models.cryovit import make_cryovit, random_cryovit_state_dict
    from cryovit_tpu_torch.train.checkpoint import save_model

    rng = np.random.default_rng(0)
    for sub in ("tomos", "labels"):
        (root / sub).mkdir()
    with h5py.File(root / "tomos" / "t.hdf", "w") as f:
        f.create_dataset("data", data=rng.random((4, 32, 32)).astype(np.float32))
        f.create_dataset("dino_features", data=rng.standard_normal((8, 4, 2, 2)).astype(np.float16))
    with h5py.File(root / "labels" / "t.hdf", "w") as f:
        f.create_dataset("mito", data=rng.integers(0, 2, (4, 32, 32)).astype(np.int8))
    sd = random_cryovit_state_dict(torch.Generator().manual_seed(0), in_channels=8)
    save_model("m", "mito", make_cryovit(sd), root / "m.model")
    return root / "tomos", root / "labels", root / "m.model"


def _eval_argv(verb, tomos, labels, model, out):
    if verb == "evaluate":
        return ["evaluate", str(tomos), str(labels), str(model), "--labels", "mito",
                "--result-folder", str(out)]
    return ["infer", str(tomos), "--model", str(model), "--result-folder", str(out)]


@pytest.mark.parametrize("verb", ["evaluate", "infer"])
def test_cli_evaluate_and_file_infer_refuse_to_fall_back_to_the_cpu(verb, monkeypatch, tmp_path):
    """``evaluate`` and ``infer`` without ``--fused`` default to the GPU:
    without one they raise, naming ``--device cpu``, before writing
    anything."""
    argv = _eval_argv(verb, *_eval_files(tmp_path), tmp_path / "out")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
    assert not (tmp_path / "out").exists()


def test_cli_evaluate_and_file_infer_run_on_the_cpu(tmp_path):
    """With ``--device cpu`` both verbs run: a metrics CSV with one row, and
    one uint8 mask on the tomogram's voxel grid."""
    import h5py

    files = _eval_files(tmp_path)
    assert main(_eval_argv("evaluate", *files, tmp_path / "eval") + ["--device", "cpu"]) == 0
    rows = (tmp_path / "eval" / "results" / "m" / "tomos.csv").read_text().splitlines()
    assert rows[0] == "sample,tomo_name,dice_metric,f1_metric" and len(rows) == 2
    assert main(_eval_argv("infer", *files, tmp_path / "infer") + ["--device", "cpu"]) == 0
    with h5py.File(tmp_path / "infer" / "t.hdf") as f:
        assert f["mito_preds"].dtype == np.uint8 and f["mito_preds"].shape == (4, 32, 32)


def test_resolve_device_raises_without_cuda(monkeypatch):
    """No GPU: the default device (None, or CUDA by name) raises and names
    the way to ask for the CPU; the CPU is taken only when named."""
    import cryovit_tpu_torch as port

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="--device cpu"):
            port.resolve_device(device)
    assert port.resolve_device("cpu") == torch.device("cpu")


def test_cli_train_refuses_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """``cryovit-torch train`` without ``--device`` on a machine without a
    GPU raises instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "t.hdf").touch()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["train", str(tmp_path), str(tmp_path), "mito", "--labels", "mito",
              "--result-folder", str(tmp_path / "out")])


def test_cli_features_use_sam_refuses_to_fall_back_to_the_cpu(monkeypatch, tmp_path):
    """``cryovit-torch features --use-sam`` without ``--device`` on a machine
    without a GPU raises instead of extracting on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_mrc(tmp_path / "t.mrc", np.zeros((2, 8, 8), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["features", str(tmp_path), str(tmp_path / "out"), "--use-sam", "--random-init"])


@pytest.mark.parametrize("device", ["cuda", None])
def test_trainer_refuses_f32_on_cuda(monkeypatch, device):
    """f32 training on a CUDA device (named, or the default) raises when the
    Trainer is built, naming the decoder's bf16-only kernels, and not in the
    middle of the first step; bf16 there and f32 on the CPU are taken."""
    from cryovit_tpu_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"conv3d_dm, conv3d_dm_dw, .*bf16 only"):
        Trainer(precision="f32", device=device)
    assert Trainer(precision="bf16", device=device).device.type == "cuda"
    assert Trainer(precision="f32", device="cpu").device.type == "cpu"


def test_run_training_refuses_f32_on_cuda_before_anything_is_built(monkeypatch, tmp_path):
    """``run_training`` with an f32 trainer on a CUDA device raises before it
    reads a file, builds a model or writes its result folder."""
    from cryovit_tpu_torch.config import TrainConfig, TrainerConfig
    from cryovit_tpu_torch.run.train_model import run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = TrainConfig(label_key="mito", trainer=TrainerConfig(precision="f32"))
    missing, out = tmp_path / "missing.hdf", tmp_path / "out"
    with pytest.raises(ValueError, match=r"convt2x_dm_bwd\) take bf16 only"):
        run_training([missing], [missing], ["mito"], "mito", "m", out, device="cuda", config=cfg)
    assert not out.exists()


@pytest.mark.parametrize("device,dtype", [("cuda", torch.float32), ("cuda:0", torch.float32),
                                          ("cuda", torch.float16)])
def test_make_dinov2_refuses_another_dtype_on_cuda_before_any_weight(monkeypatch, device, dtype):
    """``make_dinov2`` on a CUDA device in another dtype than bf16 raises,
    naming the backbone's bf16-only kernels, before it builds a weight (the
    empty state dict would fail the strict load after that)."""
    from cryovit_tpu_torch.models.dinov2 import DinoV2Config, make_dinov2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"flash_attention, .*residual_layernorm\) take bf16"):
        make_dinov2({}, DinoV2Config.tiny_test(), device=device, dtype=dtype)
