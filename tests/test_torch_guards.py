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
from cryovit_tpu_torch.ops.flash_attention import flash_attention
from cryovit_tpu_torch.ops.window_attention import (
    window_attention,
    window_block_attention,
    window_block_mlp,
)


def test_port_imports_no_jax_flax_or_h5py():
    """Every module of the port imports in a fresh interpreter (this test
    process has jax loaded through conftest.py) without pulling in jax,
    flax, h5py or the JAX package."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import cryovit_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "h5py", "cryovit_tpu"))
        print(len(names), loaded)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True, timeout=120
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20 and out[1].strip() == "[]", out


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
    xw = torch.from_numpy(rng.standard_normal((2, 16, 8)).astype(np.float32))
    ln = (torch.ones(8), torch.zeros(8))
    assert window_block_attention(xw, *ln, torch.ones(24, 8), torch.zeros(24), torch.ones(8, 8),
                                  torch.zeros(8), 2).shape == (2, 16, 8)
    assert window_block_mlp(xw, *ln, torch.ones(32, 8), torch.zeros(32), torch.ones(8, 32),
                            torch.zeros(8)).shape == (2, 16, 8)
    assert window_attention(xw, xw, xw, 2).shape == (2, 16, 8)
    assert kernels._lib is None
    assert kernels.launch_counts() == {name: 0 for name in kernels.KERNELS}
    assert set(kernels.KERNELS) == {
        "flash_attention", "conv3d_dm", "convt2x_dm", "conv3d_dm_dw", "convt2x_dm_bwd",
        "window_block_attention", "window_block_mlp", "window_attention",
    }


@pytest.mark.parametrize(
    "op",
    ["attention", "conv3d", "convt", "conv3d_dw", "convt_bwd", "window_block", "window_mlp",
     "window_attention"],
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


@pytest.mark.parametrize(
    "argv",
    [
        ["infer", "dir", "--model", "m", "--device", "cpu"],
        ["evaluate", "a", "b", "m.model"],
        ["infer", "dir", "--model", "m"],
    ],
)
def test_cli_verbs_not_yet_ported_exit_with_a_message(argv, capsys):
    assert main(argv) == 2
    assert "not yet ported" in capsys.readouterr().err


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
